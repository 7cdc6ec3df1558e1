"""The compiled end of the run on the card.

``finalize`` replayed from its CUDA graph (``compiled.FinalizeGraphs``:
both solves' Gauss-Newton iterations IF nodes, the chi² prune and
``check_trajectory`` inside) follows the eager ``finalize(graph=False)``;
the global BA with its window solves replayed from one graph follows the
eager sweep; ``check_trajectory`` on the card equals the CPU's; a capture
that fails raises, and nothing falls back to the eager polish. The map is
the port's own run at ``tiny_test_config`` on the card, keyframe-dense,
its keyframes moved by a few millimetres. Poses within ``CARD_TOL`` of
eager: the BA's ``index_add_`` atomics order its sums differently from run
to run (ROADMAP 3p), which 15 free keyframes keep far below it (measured:
``dense_schur`` and ``dense_schur_mm`` 2.4e-7, eager twice as far apart).
``pcg`` diverges on this map in the JAX package as in the port, on the
CPU as on the card (chi² from 245 to ~1e9 over the 12 iterations), and
two eager runs part completely (2.0 in a pose component): its replay is held against eager after one
iteration of each solve (measured 3.5e-5, eager twice 2.0e-5).

Needs a CUDA card and skips without one. Imports no JAX, so on the machine
with the card it runs as:
python -m pytest tests/test_torch_finalize_cuda.py --noconftest -q"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port import port_trajectory_map, trajectory_map

pytestmark = pytest.mark.cuda

CARD_TOL = 1e-4
CT_TOL = 1e-5       # tests/test_torch_finalize.py: the CPU against JAX
GBA = dict(window=8, kf_cap=32, lm_cap=512, obs_cap=1024, pp_cap=64,
           sweeps=2, gn_iterations=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def _config(solver="dense_schur_mm"):
    from putslam_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    return cfg.replace(
        map=dataclasses.replace(cfg.map, max_keyframes=16,
                                min_keyframe_matches=10_000),
        backend=dataclasses.replace(cfg.backend, max_observations=1024,
                                    optimize_every_n_frames=4,
                                    solver=solver))


def _run(cuda):
    """(final state with its keyframes moved, archive) of a 20-frame run."""
    from putslam_tpu_torch.geometry import se3
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.models import slam as tslam
    from putslam_tpu_torch.slam_map import archive as tarchive

    cfg = _config()
    poses = synthetic.orbit_trajectory(20, radius=0.06, yaw_amp=0.08,
                                       device=cuda)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    archive = tarchive.MapArchive()
    _, _, state = tslam.run_slam(cfg, grays, depths, init_pose=poses[0],
                                 chunk_size=5, device=cuda, archive=archive)
    gen = torch.Generator().manual_seed(0)
    xi = 3e-3 * torch.randn(state.map.kf_pose.shape[0], 6, generator=gen)
    kf_pose = se3.retract(state.map.kf_pose, xi.to(cuda))
    return state._replace(map=state.map._replace(kf_pose=kf_pose)), archive


@pytest.mark.parametrize("solver", ["dense_schur", "dense_schur_mm", "pcg"])
def test_replayed_finalize_follows_eager(cuda, solver):
    from putslam_tpu_torch.models import compiled
    from putslam_tpu_torch.models import slam as tslam

    state, _ = _run(cuda)
    cfg = _config(solver)
    if solver == "pcg":
        cfg = cfg.replace(backend=dataclasses.replace(
            cfg.backend, final_gn_iterations=1))
    compiled.clear_cache()
    eager = tslam.finalize(cfg, state, graph=False)
    first = tslam.finalize(cfg, state)            # captures, then replays
    again = tslam.finalize(cfg, state)            # replays
    runner = compiled.finalize_runner(cfg, state)
    assert runner.captured and runner.pool_mib() is not None
    kv = state.map.kf_valid
    for got in (first, again):
        assert torch.equal(got.map.lm_valid, eager.map.lm_valid)
        assert torch.equal(got.graph.obs_valid, eager.graph.obs_valid)
        assert torch.allclose(got.map.kf_pose[kv], eager.map.kf_pose[kv],
                              atol=CARD_TOL, rtol=0)
    moved = (first.map.kf_pose[kv] - state.map.kf_pose[kv]).abs().max()
    assert float(moved) > 1e-6
    compiled.clear_cache()


def test_replayed_window_solves_follow_eager(cuda):
    from putslam_tpu_torch.models import compiled
    from putslam_tpu_torch.slam_map import archive as tarchive

    _, archive = _run(cuda)
    cfg = _config()
    compiled.clear_cache()
    eager = tarchive.global_bundle_adjust(cfg, archive, device=cuda,
                                          graph=False, **GBA)
    graph = tarchive.global_bundle_adjust(cfg, archive, device=cuda, **GBA)
    assert len(compiled._END_RUNNERS) == 1          # one capture, replayed
    assert np.isfinite(graph).all()
    np.testing.assert_allclose(graph, eager, atol=CARD_TOL, rtol=0)
    assert np.abs(graph - archive.dense()[0]).max() > 1e-5
    compiled.clear_cache()


def test_check_trajectory_on_the_card_equals_the_cpu(cuda):
    from putslam_tpu_torch.models import slam as tslam

    cfg = _config().replace(map=dataclasses.replace(
        _config().map, max_keyframes=32))
    arrays = trajectory_map(32, cfg.backend.max_pose_pose_edges, 4, 32,
                            corrupt=(5, 17, 30), invalid=(9,), shift=13,
                            duplicates=True)
    cpu = tslam.check_trajectory(cfg, *port_trajectory_map(cfg, arrays,
                                                           "cpu"))
    card = tslam.check_trajectory(cfg, *port_trajectory_map(cfg, arrays,
                                                            cuda))
    assert card[0].is_cuda and card[1].is_cuda
    assert int(card[1]) == int(cpu[1]) >= 4
    assert torch.allclose(card[0].cpu(), cpu[0], atol=CT_TOL, rtol=0)


def test_failed_capture_raises(cuda, monkeypatch):
    """A host read inside the captured polish (here planted in
    ``check_trajectory``) fails the capture: ``finalize`` raises and does
    not fall back to the eager polish, and leaves the card usable (the
    allocator no longer routes into the failed graph's pool)."""
    from putslam_tpu_torch.models import compiled
    from putslam_tpu_torch.models import slam as tslam

    state, _ = _run(cuda)
    cfg = _config()
    real = tslam.check_trajectory

    def reads_the_host(cfg, m, g):
        if int(m.n_kf) < 0:
            raise AssertionError("unreachable")
        return real(cfg, m, g)

    compiled.clear_cache()
    monkeypatch.setattr(tslam, "check_trajectory", reads_the_host)
    with pytest.raises(RuntimeError):
        tslam.finalize(cfg, state)
    monkeypatch.undo()
    # the card stays usable: the failed runner's pools are freed, the
    # eager polish runs, and a new capture replays
    compiled.clear_cache()
    eager = tslam.finalize(cfg, state, graph=False)
    graph = tslam.finalize(cfg, state)
    kv = state.map.kf_valid
    assert torch.allclose(graph.map.kf_pose[kv], eager.map.kf_pose[kv],
                          atol=CARD_TOL, rtol=0)
    compiled.clear_cache()
    torch.cuda.synchronize()
