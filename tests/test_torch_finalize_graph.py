"""The end-of-run runners (``models/compiled.py``) equal the eager path.

``FinalizeGraphs`` runs ``slam.finalize_map`` (release, BA, chi² prune,
BA, ``check_trajectory``) and ``WindowGraphs`` one window solve of the
global BA (``gauss_newton_mm``) on static buffers, as their CUDA graphs
replay them, each Gauss-Newton iteration a ``control.cond``. With
``capture=False`` each predicate is read on the host instead: on the CPU
both must equal the eager ``finalize(graph=False)`` and the eager window
solve bit for bit, and read nothing from the device but their predicates
(``PredicateReadsOnly``: no ``.item()`` outside a predicate, no
``nonzero``, no tensor made from host data), with every branch body
writing only to tensors it made (``control.checking``).

The map is the port's own: ``run_slam`` on the CPU over a tiny orbit with
a keyframe on every frame and a 16-slot ring that wraps, absorbed into a
``MapArchive`` at every chunk; its keyframes moved by a few millimetres,
so that the polish has work to do. Graph mode refuses a CPU device, and an
end-of-run runner never evicts the frame runner of the same run.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_compiled_step import PredicateReadsOnly

from putslam_tpu_torch.config import tiny_test_config
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.io import synthetic
from putslam_tpu_torch.models import compiled
from putslam_tpu_torch.models import slam as tslam
from putslam_tpu_torch.slam_map import archive as tarchive
from putslam_tpu_torch.utils import control

T, CHUNK = 20, 5
GBA = dict(window=8, kf_cap=32, lm_cap=512, obs_cap=1024, pp_cap=64,
           sweeps=2, gn_iterations=4)
SOLVERS = ("dense_schur", "dense_schur_mm", "pcg")


def _config(solver="dense_schur"):
    cfg = tiny_test_config()
    return cfg.replace(
        map=dataclasses.replace(cfg.map, max_keyframes=16,
                                min_keyframe_matches=10_000),
        backend=dataclasses.replace(cfg.backend, max_observations=1024,
                                    optimize_every_n_frames=4,
                                    solver=solver))


@pytest.fixture(scope="module")
def run():
    """(config, frames, final state, archive) of the port's CPU run."""
    cfg = _config()
    poses = synthetic.orbit_trajectory(T, radius=0.06, yaw_amp=0.08)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    archive = tarchive.MapArchive()
    _, _, state = tslam.run_slam(cfg, grays, depths, init_pose=poses[0],
                                 chunk_size=CHUNK, device="cpu",
                                 archive=archive)
    assert int(state.map.kf_valid.sum()) >= 8
    # the in-loop BA leaves little for the polish to do: move the
    # keyframes by a few millimetres so that both solves work
    gen = torch.Generator().manual_seed(0)
    xi = 3e-3 * torch.randn(state.map.kf_pose.shape[0], 6, generator=gen)
    kf_pose = se3.retract(state.map.kf_pose, xi)
    state = state._replace(map=state.map._replace(kf_pose=kf_pose))
    return cfg, grays, state, archive


def _equal_trees(a, b, what):
    la, lb = compiled._leaves(a), compiled._leaves(b)
    assert len(la) == len(lb), what
    for k, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, k)


@pytest.mark.parametrize("solver", SOLVERS)
def test_finalize_runner_equals_eager(run, solver):
    _, _, state, _ = run
    cfg = _config(solver)
    eager = tslam.finalize(cfg, state, graph=False)
    runner = compiled.FinalizeGraphs(cfg, state, capture=False)
    got = runner.run(state)
    _equal_trees(got, eager, solver)
    kv = state.map.kf_valid
    assert (got.map.kf_pose[kv] - state.map.kf_pose[kv]).abs().max() > 1e-6
    assert runner.chi2.shape == (2, cfg.backend.final_gn_iterations)
    # a second run on the same buffers gives the same state again
    _equal_trees(runner.run(state), eager, solver + ", second run")


@pytest.mark.parametrize("solver", SOLVERS)
def test_finalize_runner_reads_only_predicates(run, solver):
    """One read a Gauss-Newton iteration that ``dense_schur_mm`` runs or
    skips (its chi² stop), none for the solvers without one."""
    _, _, state, _ = run
    cfg = _config(solver)
    runner = compiled.FinalizeGraphs(cfg, state, capture=False)
    runner.run(state)
    with control.checking(), PredicateReadsOnly() as mode:
        runner.segment.run()
    conds = 2 * cfg.backend.final_gn_iterations \
        if solver == "dense_schur_mm" else 0
    assert mode.reads == mode.predicates == conds


def _recorded_windows(cfg, archive, monkeypatch):
    """The eager global BA with each window solve's arguments and result
    recorded."""
    windows = []
    real = tarchive.opt_mod.gauss_newton_mm

    def solve(bcfg, *args, **kw):
        res = real(bcfg, *args, **kw)
        windows.append((bcfg, args, res))
        return res

    monkeypatch.setattr(tarchive.opt_mod, "gauss_newton_mm", solve)
    out = tarchive.global_bundle_adjust(cfg, archive, device="cpu",
                                        graph=False, **GBA)
    monkeypatch.undo()
    return out, windows


def test_window_runner_equals_eager(run, monkeypatch):
    cfg, _, _, archive = run
    out, windows = _recorded_windows(cfg, archive, monkeypatch)
    assert len(windows) >= 4 and np.isfinite(out).all()
    runner = compiled.WindowGraphs(windows[0][0], cfg.camera,
                                   GBA["kf_cap"], GBA["lm_cap"], "cpu",
                                   capture=False)
    moved = 0
    for bcfg, args, res in windows:
        assert bcfg == windows[0][0]          # one set of caps: one runner
        kf, lm = runner.solve(*args)
        assert torch.equal(kf, res.kf_pose) and torch.equal(lm, res.lm_pos)
        moved += not torch.equal(kf, args[0])
    assert moved >= len(windows) // 2


def test_window_runner_reads_only_predicates(run, monkeypatch):
    cfg, _, _, archive = run
    _, windows = _recorded_windows(cfg, archive, monkeypatch)
    bcfg, args, _ = windows[-1]
    runner = compiled.WindowGraphs(bcfg, cfg.camera, GBA["kf_cap"],
                                   GBA["lm_cap"], "cpu", capture=False)
    runner.solve(*args)
    with control.checking(), PredicateReadsOnly() as mode:
        runner.segment.run()
    assert mode.reads == mode.predicates == bcfg.gn_iterations


def test_graph_mode_refuses_the_cpu(run):
    cfg, _, state, archive = run
    with pytest.raises(ValueError, match="CUDA"):
        tslam.finalize(cfg, state, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        tarchive.global_bundle_adjust(cfg, archive, device="cpu",
                                      graph=True, **GBA)
    with pytest.raises(ValueError, match="CUDA"):
        compiled.FinalizeGraphs(cfg, state, capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        compiled.WindowGraphs(cfg.backend, cfg.camera, 8, 64, "cpu",
                              capture=True)
    # graph=None is the eager path on the CPU
    _equal_trees(tslam.finalize(cfg, state), tslam.finalize(
        cfg, state, graph=False), "graph=None")


def test_end_of_run_runners_never_evict_the_frame_runner(run):
    """The finalize and window runners of many configs pass through their
    own cache; the frame runner of the run stays cached, the same object."""
    cfg, grays, state, _ = run
    compiled.clear_cache()
    try:
        frame = compiled.slam_runner(cfg, state, grays.shape[1:],
                                     capture=False)
        for k in range(compiled.MAX_END_CACHED + 2):
            c = cfg.replace(backend=dataclasses.replace(
                cfg.backend, final_gn_iterations=2 + k))
            fin = compiled.finalize_runner(c, state, capture=False)
            assert compiled.finalize_runner(c, state, capture=False) is fin
            compiled.window_runner(c.backend, c.camera, 8, 64, "cpu",
                                   capture=False)
        assert compiled.slam_runner(cfg, state, grays.shape[1:],
                                    capture=False) is frame
        assert len(compiled._RUNNERS) == 1
        assert len(compiled._END_RUNNERS) == compiled.MAX_END_CACHED
    finally:
        compiled.clear_cache()
