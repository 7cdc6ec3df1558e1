"""The port's programs around the package, on the CPU at tiny sizes:
bench_torch.py (the bench line's four keys, bench.py's detail keys plus the
card's, no BENCH_DETAIL.json), tools/profile_vo_torch.py (the five stages),
tools/run_experiments_torch.py (the presets the JAX tool finds, a sweep
through the port's run.main, resultSummary.json with the JAX tool's keys),
tools/export_reference_dataset_torch.py (the JAX tool's output directory
file for file) and tools/run_acceptance_torch.py (apply_overrides equal to
the JAX function's config tree, the engine half, main end to end with
stand-ins for the reference's scripts and a bounds file of its own)."""

import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch
from _torch_port import port_cfg, write_reference_stand_ins, write_resources

from putslam_tpu.config import tiny_test_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
sys.path.insert(0, TOOLS)
sys.path.insert(0, ROOT)

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
# bench.py's detail keys (bench.py:88-103)
BENCH_DETAIL_KEYS = {"slam_fps", "slam_ms_per_frame", "vo_fps", "n_keyframes",
                     "n_ba_calls", "n_landmarks", "ate_rmse_m", "frames",
                     "vs_measured_reference", "vs_design_point_30fps",
                     "solver", "note"}


def test_bench_runs_on_the_cpu_when_asked(tmp_path, capsys):
    import bench_torch

    jax_detail = os.path.join(ROOT, "BENCH_DETAIL.json")
    before = open(jax_detail, "rb").read()
    detail_path = tmp_path / "out" / "BENCH_DETAIL_torch.json"
    got = bench_torch.main(reps=1, trials=1, n_frames=4, device="cpu",
                           detail_path=str(detail_path),
                           cfg=port_cfg(tiny_test_config()))
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "slam_frames_per_sec_640x480_1chip"
    assert line["unit"] == "frames/s" and line["value"] > 0
    # both from the unrounded rate: within the two roundings
    assert abs(line["vs_baseline"] - line["value"] / 2.04) < 0.01
    detail = json.loads(detail_path.read_text())
    assert detail == got["detail"] == json.loads(
        out.err.strip().splitlines()[-1])
    assert BENCH_DETAIL_KEYS | {"device", "power_limit"} <= set(detail)
    assert detail["frames"] == 4 and detail["device"] == "cpu"
    assert detail["solver"] == tiny_test_config().backend.solver
    # (4 frames of the 64-frame orbit's shape: steps far over the VO gate,
    # so the ATE is gated only at full length, by chip_smoke.py phase 17a)
    assert np.isfinite(detail["ate_rmse_m"])
    assert detail["vo_fps"] > 0 and detail["n_keyframes"] >= 1
    assert f"rule in this run: {detail['n_keyframes']}, BA calls: " \
        f"{detail['n_ba_calls']}" in detail["note"]
    # the JAX package's detail file is never written
    assert open(jax_detail, "rb").read() == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_torch.main(reps=1, trials=1, n_frames=4,
                             detail_path=str(detail_path))


def test_profile_vo_stages(tmp_path, capsys):
    import profile_vo_torch

    out = tmp_path / "vo.json"
    assert profile_vo_torch.main(
        ["--frames", "3", "--device", "cpu", "--runs", "1", "--json-out",
         str(out)], cfg=port_cfg(tiny_test_config())) == 0
    got = json.loads(out.read_text())
    assert list(got["stages"]) == [
        "vo_sequence (end-to-end)", "detect_sequence (all levels)",
        "fast.detect (level 0)", "extract+describe (level 0)",
        "vo_step (match+ransac)"]
    for name, s in got["stages"].items():
        assert s["ms_per_call"] > 0 and np.isfinite(s["ms_per_frame"]), name
        assert s["frames"] == (2 if name.startswith("vo_step") else 3)
    printed = capsys.readouterr().out
    assert printed.count("ms/frame") == 5


def _presets(root):
    """Two preset directories of reference-style XML files and one
    directory that is not a preset."""
    write_resources(root / "full")
    (root / "lc_only").mkdir()
    (root / "lc_only" / "putslamconfigGlobal.xml").write_text(
        '<PUTSLAM onlyVO="0" />\n<ThreadSettings '
        'loopClosureThreadVersion="1" />\n')
    (root / "notes").mkdir()
    (root / "notes" / "readme.txt").write_text("not a preset\n")
    return root


def test_discover_presets_as_the_jax_tool(tmp_path):
    import run_experiments
    import run_experiments_torch

    root = _presets(tmp_path / "configs")
    assert run_experiments_torch.discover_presets(str(root)) == \
        run_experiments.discover_presets(str(root)) == [
            ("full", str(root / "full")), ("lc_only", str(root / "lc_only"))]
    # the configs directory itself is a preset when it holds the XMLs
    flat = write_resources(tmp_path / "flat")
    assert run_experiments_torch.discover_presets(str(flat)) == \
        run_experiments.discover_presets(str(flat))
    assert run_experiments_torch.discover_presets(str(flat))[0] == \
        ("default", str(flat))


def test_run_experiments_sweep(tmp_path, capsys):
    import run_experiments_torch

    root = _presets(tmp_path / "configs")
    out = tmp_path / "results"
    assert run_experiments_torch.main(
        ["--configs", str(root), "--synthetic", "3", "--device", "cpu",
         "--out", str(out)]) == 0
    summary = json.loads((out / "resultSummary.json").read_text())
    assert set(summary) == {"presets", "aggregate"}
    assert set(summary["presets"]) == {"full", "lc_only"}
    for name, rep in summary["presets"].items():
        assert rep["returncode"] == 0 and rep["frames"] == 3, name
        assert rep["device"] == "cpu" and np.isfinite(rep["ate_rmse_m"])
        assert (out / name / "graph_trajectory.res").exists()
    # the JAX tool's aggregate keys (tools/run_experiments.py:104-106)
    agg = summary["aggregate"]
    assert list(agg) == ["ate_rmse_m", "ate_before_final_m", "rpe_trans_m",
                         "rpe_rot_rad", "fps"]
    ates = [r["ate_rmse_m"] for r in summary["presets"].values()]
    assert agg["ate_rmse_m"] == {"min": min(ates), "max": max(ates),
                                 "mean": sum(ates) / 2, "n": 2}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == agg
    # no preset: exit 1
    assert run_experiments_torch.main(
        ["--configs", str(root / "notes"), "--device", "cpu"]) == 1


def test_export_reference_dataset_equals_the_jax_tool(tmp_path):
    import export_reference_dataset
    import export_reference_dataset_torch

    from putslam_tpu_torch.io import synthetic, tum

    rng = np.random.default_rng(0)
    grays = rng.uniform(0, 1, (3, 24, 32)).astype(np.float32)
    depths = rng.uniform(0.5, 3.0, (3, 24, 32)).astype(np.float32)
    gt = synthetic.handheld_trajectory(3, seed=3).numpy()
    src = tmp_path / "tum"
    tum.write_tum_dataset(str(src), grays, depths, gt_poses=gt)
    for tool, name in ((export_reference_dataset_torch, "port"),
                       (export_reference_dataset, "jax")):
        assert tool.main(["--tum", str(src), "--out",
                          str(tmp_path / name)]) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == ["depth_00000.png", "depth_00001.png", "depth_00002.png",
                     "groundtruth.txt", "initialPosition", "matched",
                     "rgb_00000.png", "rgb_00001.png", "rgb_00002.png"]
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", names, shallow=False)
    assert match == names and not mismatch and not errors


def test_apply_overrides_as_the_jax_function():
    import run_acceptance
    import run_acceptance_torch

    from putslam_tpu_torch.convert import config_from_jax

    cfg = tiny_test_config()
    ovs = ["matcher.retry_hamming_slack=0", "backend.gn_iterations=4",
           "map.min_keyframe_matches=77", "pose_blend_alpha=0.5",
           'backend.solver="dense_schur"', "ransac.used_pairs=5"]
    ours = run_acceptance_torch.apply_overrides(port_cfg(cfg), ovs)
    assert ours == config_from_jax(run_acceptance.apply_overrides(cfg, ovs))
    assert ours.backend.solver == "dense_schur" and ours.pose_blend_alpha == 0.5
    assert run_acceptance_torch.apply_overrides(port_cfg(cfg), None) == \
        port_cfg(cfg)


@pytest.fixture(scope="module")
def handheld4(tmp_path_factory):
    """Four handheld frames at fr1, in TUM layout with a camera.json,
    under the name of the acceptance's clean sequence."""
    import make_disk_dataset_torch

    root = tmp_path_factory.mktemp("accept") / "synth_handheld_640"
    assert make_disk_dataset_torch.main(["--frames", "4", "--out", str(root),
                                         "--device", "cpu"]) == 0
    return root


@pytest.fixture(scope="module")
def engine(handheld4):
    import run_acceptance_torch

    return run_acceptance_torch.run_engine(str(handheld4), device="cpu")


def test_acceptance_engine_half(engine):
    from putslam_tpu_torch.eval import ate

    r = engine
    assert r["frames"] == 4 and r["poses_after"].shape == (4, 7)
    assert np.isfinite(r["poses_after"]).all()
    assert ate.ate_rmse_aligned_frames(r["gt"], r["poses_after"]) < 0.03
    assert r["archive"].n_keyframes() >= 1 and len(r["archive"].obs) > 0
    assert r["wall_s"] > 0 and r["loader"] in ("native", "python")
    # the acceptance operating point reached the engine
    assert r["state"].map.kf_pose.shape[0] == 256


@pytest.mark.parametrize("rpe_bound", [0.05, 0.01])
def test_acceptance_main_with_stand_in_scripts(handheld4, engine, tmp_path,
                                               capsys, monkeypatch,
                                               rpe_bound):
    """Scored by the stand-ins (ATE 0.014, RPE 0.024 for 4 poses) against
    a bounds file of the test's own: inside the bounds exit 0 (the engine
    run end to end), over the RPE bound exit 1 (the engine's result reused
    from the engine-half test); --record stays off."""
    import run_acceptance_torch
    import run_reference_eval

    monkeypatch.setattr(run_reference_eval, "REF_SCRIPTS", str(
        write_reference_stand_ins(tmp_path / "scripts")))
    if rpe_bound < 0.024:
        monkeypatch.setattr(run_acceptance_torch, "run_engine",
                            lambda *a, **k: engine)
    bounds = tmp_path / "bounds.json"
    bounds.write_text(json.dumps({"golden_bounds": {
        "clean_ate_max_m": 0.015, "noisy_ate_max_m": 0.03,
        "hard_ate_max_m": 0.12, "clean_rpe_trans_max_m_per_s": rpe_bound}}))
    rc = run_acceptance_torch.main(
        ["--data-root", str(handheld4.parent), "--bounds", str(bounds),
         "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == (0 if rpe_bound > 0.024 else 1)
    assert "SKIP noisy" in out and "SKIP hard" in out
    assert ("clean: ATE 0.014 m (bound 0.015) RPE 0.024 (bound "
            f"{rpe_bound}) {'OK' if rc == 0 else 'FAIL'}") in out
    res = json.loads(out[out.index("{"):])
    clean = res["clean"]
    assert clean["ref_ate_rmse_g2o_m"] == 0.014
    assert clean["ref_rpe_trans_g2o_m_per_s"] == 0.024
    assert clean["frames"] == 4 and clean["n_keyframes"] >= 1
    assert np.isfinite(clean["our_ate_rmse_g2o_m"])
