"""The port's command-line runner writes the reference's output files,
statistics.txt with the JAX package's keys and formats included."""

import json

import numpy as np
import pytest
from _torch_port import port_cfg

from putslam_tpu_torch import run

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


@pytest.mark.parametrize("flag", [["--reference-eval"], ["--dataset", "x"],
                                  ["--global-ba"],
                                  ["--reference-resources", "x"],
                                  ["--plots"]])
def test_unported_flags_exit_with_error(flag, capsys):
    with pytest.raises(SystemExit) as e:
        run.main(["--synthetic", "3", "--device", "cpu", *flag])
    assert e.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


def test_cuda_requested_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--synthetic", "3", "--out", str(tmp_path)])
