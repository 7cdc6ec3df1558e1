"""The port's command-line runner writes the reference's output files,
statistics.txt with the JAX package's keys and formats included; it plays a
TUM-layout sequence from disk (written by tools/make_disk_dataset_torch.py),
with the global bundle adjustment and with an XML operating point."""

import json
import os
import sys

import numpy as np
import pytest
from _torch_port import port_cfg

from putslam_tpu_torch import run

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
sys.path.insert(0, TOOLS)
STAT_KEYS = ["frames", "vo_ok_fraction", "map_ok_fraction", "keyframes",
             "ba_runs", "map_inliers_median", "map_matches_median",
             "landmarks_final"]


def _stat_keys(path):
    return [line.split()[0] for line in path.read_text().splitlines()]


def test_run_synthetic_writes_outputs(tmp_path, capsys):
    assert run.main(["--synthetic", "3", "--device", "cpu", "--out",
                     str(tmp_path)]) == 0
    for name in ("VO_trajectory.res", "graph_trajectory.res", "fps.res",
                 "times.txt", "statistics.txt"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert len((tmp_path / "graph_trajectory.res").read_text()
               .splitlines()) == 3
    assert _stat_keys(tmp_path / "statistics.txt") == STAT_KEYS
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 3 and report["device"] == "cpu"


def test_run_loop_closure_on_cpu(tmp_path, capsys):
    assert run.main(["--synthetic", "3", "--loop-closure", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    for name in ("VO_trajectory.res", "graph_trajectory.res", "fps.res",
                 "times.txt", "statistics.txt"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert _stat_keys(tmp_path / "statistics.txt") == STAT_KEYS
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 3 and np.isfinite(report["ate_rmse_m"])


def test_run_tracking_vo_on_cpu(tmp_path, capsys):
    assert run.main(["--synthetic", "3", "--only-vo", "--vo-version", "1",
                     "--device", "cpu", "--out", str(tmp_path)]) == 0
    for name in ("VO_trajectory.res", "fps.res", "times.txt"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert not (tmp_path / "statistics.txt").exists()   # no SLAM outputs
    assert len((tmp_path / "VO_trajectory.res").read_text()
               .splitlines()) == 3
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 3 and np.isfinite(report["ate_rmse_m"])


def test_run_statistics_equal_the_jax_writer(tmp_path):
    """Both packages' write_run_statistics on the same SLAM outputs write
    the same file."""
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.io import synthetic as jsyn
    from putslam_tpu.utils import timing as jtiming
    from putslam_tpu_torch.models import slam as tslam
    from putslam_tpu_torch.utils import timing as ttiming

    cfg = tiny_test_config()
    poses = np.asarray(jsyn.orbit_trajectory(6, radius=0.10, yaw_amp=0.1))
    g, d = (np.asarray(x) for x in jsyn.render_sequence(cfg.camera, poses))
    _, _, outs, _ = tslam.run_slam_final(port_cfg(cfg), g, d,
                                         init_pose=poses[0], device="cpu")
    jtiming.write_run_statistics(str(tmp_path / "jax.txt"), outs)
    ttiming.write_run_statistics(str(tmp_path / "port.txt"), outs)
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    assert _stat_keys(tmp_path / "port.txt") == STAT_KEYS


@pytest.mark.parametrize("flag", [["--reference-eval"],
                                  ["--reference-eval", "--only-vo"],
                                  ["--global-ba", "--plots"],
                                  ["--only-vo", "--vo-version", "2"],
                                  ["--plots", "--only-vo"]])
def test_unported_flags_exit_with_error(flag, tmp_path, capsys):
    """The flags that exited "not yet ported" before the port was whole
    now run as in the JAX package: --reference-eval does nothing without a
    --dataset holding a groundtruth.txt (no *Ate.res, no ref_ key);
    --plots writes trajectory.png, and map.png and stats.png for a SLAM run
    (matplotlib, Agg); --vo-version 2 runs matching VO, the trajectory of
    --vo-version 0 to the byte."""
    out = tmp_path / "out"
    assert run.main(["--synthetic", "3", "--device", "cpu", "--out",
                     str(out), *flag]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 3 and np.isfinite(report["ate_rmse_m"])
    assert not [k for k in report if k.startswith("ref_")]
    assert not list(out.glob("*Ate.res")) and not list(out.glob("*Rpe.res"))
    pngs = sorted(p.name for p in out.glob("*.png"))
    if "--plots" in flag:
        assert pngs == (["trajectory.png"] if "--only-vo" in flag else
                        ["map.png", "stats.png", "trajectory.png"])
        for name in pngs:
            assert (out / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    else:
        assert pngs == []
    if "--vo-version" in flag:
        ref = tmp_path / "v0"
        assert run.main(["--synthetic", "3", "--device", "cpu", "--only-vo",
                         "--vo-version", "0", "--out", str(ref)]) == 0
        assert (out / "VO_trajectory.res").read_text() == \
            (ref / "VO_trajectory.res").read_text()


def test_needs_a_source_of_frames(capsys):
    with pytest.raises(SystemExit) as e:
        run.main(["--device", "cpu"])
    assert e.value.code != 0
    assert "--dataset or --synthetic" in capsys.readouterr().err


OUTPUTS = ("VO_trajectory.res", "graph_trajectory.res", "fps.res",
           "times.txt", "statistics.txt")


@pytest.fixture(scope="module")
def disk_sequence(tmp_path_factory):
    """Three handheld frames at the fr1 size, written in TUM layout with a
    camera.json by the port's tool."""
    import make_disk_dataset_torch as tool

    root = tmp_path_factory.mktemp("handheld3")
    assert tool.main(["--frames", "3", "--out", str(root), "--device",
                      "cpu"]) == 0
    return root


def test_disk_dataset_tool_writes_the_tum_layout(disk_sequence):
    from putslam_tpu_torch.io import synthetic, tum

    root = disk_sequence
    names = sorted(p.name for p in root.iterdir())
    assert names == ["camera.json", "depth", "depth.txt", "groundtruth.txt",
                     "rgb", "rgb.txt"]
    cam = json.loads((root / "camera.json").read_text())
    assert cam["k1"] == cam["k3"] == 0.0 and cam["width"] == 640
    ds = tum.TumDataset(str(root))
    assert len(ds) == 3 and ds[0].gray.shape == (480, 640)
    gt = synthetic.handheld_trajectory(3, seed=3).numpy()
    np.testing.assert_allclose(ds.groundtruth[1], gt, atol=1e-6)


def test_disk_dataset_tool_planes_renderer_matches_jax(tmp_path):
    """--renderer planes: the port's tool on the CPU and the JAX package's
    tool write the same 2-frame sequence: depth PNGs within one unit
    (1/5000 m), gray PNGs equal on at least 99.9 % of pixels (all of them
    on the CPU), the same index files and ground truth."""
    import make_disk_dataset as jtool
    import make_disk_dataset_torch as tool
    from putslam_tpu_torch.io import png

    args = ["--frames", "2", "--renderer", "planes", "--seed", "5"]
    assert tool.main([*args, "--out", str(tmp_path / "port"), "--device",
                      "cpu"]) == 0
    assert jtool.main([*args, "--out", str(tmp_path / "jax")]) == 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in ("rgb.txt", "depth.txt", "camera.json"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text(), name
    for kind in ("rgb", "depth"):
        files = sorted((tmp_path / "port" / kind).iterdir())
        assert len(files) == 2
        for f in files:
            a = png.read_png(str(f)).astype(np.int64)
            b = png.read_png(str(tmp_path / "jax" / kind / f.name)).astype(
                np.int64)
            assert a.shape == b.shape == (480, 640)
            if kind == "depth":
                assert np.abs(a - b).max() <= 1
            else:
                assert np.mean(a == b) >= 0.999
    gt = [np.loadtxt(str(tmp_path / side / "groundtruth.txt"))
          for side in ("port", "jax")]
    assert gt[0].shape == (2, 8)
    np.testing.assert_allclose(gt[0], gt[1], atol=1e-6)


@pytest.mark.parametrize("extra", [[], ["--global-ba"]],
                         ids=["final", "global_ba"])
def test_run_dataset_on_cpu(disk_sequence, tmp_path, capsys, extra):
    assert run.main(["--dataset", str(disk_sequence), "--device", "cpu",
                     "--out", str(tmp_path), *extra]) == 0
    for name in OUTPUTS:
        assert (tmp_path / name).stat().st_size > 0, name
    lines = (tmp_path / "graph_trajectory.res").read_text().splitlines()
    assert len(lines) == 3
    assert [ln.split()[0] for ln in lines] == ["0.000000", "0.033333",
                                               "0.066667"]
    assert "dataset" in (tmp_path / "times.txt").read_text()
    assert _stat_keys(tmp_path / "statistics.txt") == STAT_KEYS
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 3 and report["device"] == "cpu"
    assert report["loader"] in ("native", "python")
    # the timestamps line up with groundtruth.txt: the frame-aligned report
    assert np.isfinite(report["ate_rmse_m"])
    assert np.isfinite(report["ate_before_final_m"])
    assert np.isfinite(report["rpe_trans_m"])


def test_run_dataset_only_vo_max_frames_and_associated_ate(disk_sequence,
                                                           tmp_path, capsys):
    """--only-vo converts the wire format on the host; --max-frames cuts
    the sequence; ground truth whose timestamps do not line up frame by
    frame is scored by association."""
    import shutil

    root = tmp_path / "seq"
    shutil.copytree(disk_sequence, root)
    gt = (root / "groundtruth.txt").read_text().splitlines()
    shifted = [" ".join([f"{float(ln.split()[0]) + 0.004:.6f}",
                         *ln.split()[1:]]) for ln in gt]
    (root / "groundtruth.txt").write_text("\n".join(shifted) + "\n")
    out = tmp_path / "out"
    assert run.main(["--dataset", str(root), "--only-vo", "--device", "cpu",
                     "--out", str(out)]) == 0
    assert not (out / "statistics.txt").exists()
    assert len((out / "VO_trajectory.res").read_text().splitlines()) == 3
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 3 and np.isfinite(report["ate_rmse_m"])
    assert "rpe_trans_m" not in report           # no per-frame ground truth
    assert run.main(["--dataset", str(root), "--only-vo", "--max-frames", "2",
                     "--device", "cpu", "--out", str(out)]) == 0
    assert len((out / "VO_trajectory.res").read_text().splitlines()) == 2


def test_run_reference_resources(disk_sequence, tmp_path, capsys,
                                 monkeypatch):
    """--reference-resources / --dataset-name: the XML operating point
    reaches the engine (loop closure on, the matcher's RANSAC settings),
    and the dataset's camera.json still overrides the XML camera."""
    from putslam_tpu_torch.models import slam as tslam

    res = tmp_path / "resources"
    (res / "datasetConfig").mkdir(parents=True)
    (res / "putslamconfigGlobal.xml").write_text(
        '<PUTSLAM onlyVO="0" />\n<ThreadSettings '
        'loopClosureThreadVersion="1" />\n')
    (res / "putslammatcherOpenCVParameters.xml").write_text(
        '<Matcher VOVersion="0"><RANSAC usedPairs="4" '
        'minimalNumberOfMatches="12" /></Matcher>')
    (res / "datasetConfig" / "cam.xml").write_text(
        '<Model><focalLength fu="100.0" fv="100.0" />'
        '<rgbDistortion k1="0.2" /></Model>')
    seen = {}
    real = tslam.run_slam_final

    def spy(cfg, *a, **k):
        seen["cfg"] = cfg
        return real(cfg, *a, **k)

    monkeypatch.setattr(tslam, "run_slam_final", spy)
    out = tmp_path / "out"
    assert run.main(["--dataset", str(disk_sequence), "--device", "cpu",
                     "--reference-resources", str(res), "--dataset-name",
                     "cam", "--out", str(out)]) == 0
    cfg = seen["cfg"]
    assert cfg.loop_closure.enabled and cfg.ransac.used_pairs == 4
    assert cfg.ransac.minimal_num_matches == 12
    assert cfg.camera.fu == 517.3 and cfg.camera.k1 == 0.0   # camera.json
    for name in OUTPUTS:
        assert (out / name).stat().st_size > 0, name
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 3 and np.isfinite(report["ate_rmse_m"])


def test_cuda_requested_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--synthetic", "3", "--out", str(tmp_path)])


def test_run_reference_eval_with_stand_in_scripts(disk_sequence, tmp_path,
                                                  capsys, monkeypatch):
    """--reference-eval on a dataset with a groundtruth.txt scores both
    trajectories with the reference's scripts through
    tools/run_reference_eval.py (stand-ins here, written in Python 2 so
    that its shim runs; the real scripts wait for files): g2oAte.res,
    g2oRpe.res, VOAte.res and VORpe.res hold what the scripts printed, the
    report gains ref_ate_rmse_{tag}_m and ref_rpe_trans_{tag}_m; the JAX
    package's run.main on the same directory (VO only, to keep its compile
    short) writes the same files and reports the same ref_ keys."""
    import run_reference_eval
    from _torch_port import write_reference_stand_ins

    from putslam_tpu import run as jrun

    monkeypatch.setattr(run_reference_eval, "REF_SCRIPTS", str(
        write_reference_stand_ins(tmp_path / "scripts")))
    out = tmp_path / "slam"
    assert run.main(["--dataset", str(disk_sequence), "--device", "cpu",
                     "--reference-eval", "--out", str(out)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for tag in ("g2o", "VO"):
        assert (out / f"{tag}Ate.res").read_text().strip() == "0.013000"
        assert (out / f"{tag}Rpe.res").read_text().strip() == "0.023000"
        assert report[f"ref_ate_rmse_{tag}_m"] == 0.013
        assert report[f"ref_rpe_trans_{tag}_m"] == 0.023
    reports = {}
    for name, main in (("port", run.main), ("jax", jrun.main)):
        args = ["--dataset", str(disk_sequence), "--only-vo",
                "--reference-eval", "--out", str(tmp_path / name)]
        assert main(args + (["--device", "cpu"] if name == "port" else [])) \
            == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        reports[name] = {k: v for k, v in json.loads(line).items()
                         if k.startswith("ref_")}
    assert reports["port"] == reports["jax"] == {
        "ref_ate_rmse_VO_m": 0.013, "ref_rpe_trans_VO_m": 0.023}
    for name in ("VOAte.res", "VORpe.res"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    assert not (tmp_path / "port" / "g2oAte.res").exists()
