"""The tracking VO (``vo_version=1``) through its graph runner.

``compiled.TrackGraphs(capture=False)`` runs the step a CUDA graph replays
(KLT, the patch refine, RANSAC, the masked refill with its level-0
detection, the pose update) on the runner's static buffers without a graph.
Over a tiny orbit it must equal the eager ``vo_sequence_tracking`` bit for
bit (poses, every per-step result, the generator's state after the run),
read nothing from the device on the host, and follow the JAX package's
``run_vo(vo_version=1)`` fed the same uniforms within
``tests/test_torch_klt.py``'s tolerance (poses 1e-4, per-step counts
exact)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t
from test_torch_compiled_step import NoHostRead
from test_torch_klt import _frames, _tracking_cfg, _uniforms

from putslam_tpu.models import vo as jvo
from putslam_tpu_torch.config import tiny_test_config
from putslam_tpu_torch.io import synthetic as tsyn
from putslam_tpu_torch.models import compiled
from putslam_tpu_torch.models import vo as tvo


def _port_tracking_cfg(patch_refine):
    cfg = tiny_test_config().replace(vo_version=1)
    return cfg.replace(tracker=dataclasses.replace(
        cfg.tracker, min_tracked_features=60, patch_refine=patch_refine))


@pytest.mark.parametrize("patch_refine", [False, True])
def test_tracking_runner_equals_eager(patch_refine):
    cfg = _port_tracking_cfg(patch_refine)
    g, d, p = _frames()
    grays, depths, poses = t(g), t(d), t(p)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    p_eager, s_eager = tvo.vo_sequence_tracking(
        cfg, grays, depths, generator=gens[0], init_pose=poses[0],
        graph=False)
    with NoHostRead():
        p_run, s_run = compiled.track_run_sequence(
            cfg, grays, depths, poses[0], generator=gens[1], capture=False)
    assert torch.equal(p_eager, p_run)
    for a, b in zip(s_eager, s_run):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert float(s_run.ok.float().mean()) > 0.5


def test_tracking_runner_follows_jax():
    cfg = _tracking_cfg()
    g, d, poses = _frames()
    ref_poses, ref_stats = jvo.run_vo(cfg, g, d, seed=0, init_pose=poses[0])
    key = jax.random.PRNGKey(0)
    draws = []
    for _ in range(len(g) - 1):
        key, sub = jax.random.split(key)
        draws.append(_uniforms(cfg, sub))
    got_poses, got_stats = compiled.track_run_sequence(
        port_cfg(cfg), t(g), t(d), t(poses[0]), draws=draws, capture=False)
    np.testing.assert_allclose(n(got_poses), ref_poses, atol=1e-4)
    for f in ("n_matches", "n_inliers", "ok"):
        np.testing.assert_array_equal(n(getattr(got_stats, f)),
                                      np.asarray(getattr(ref_stats, f)))
    assert ref_stats.ok.mean() > 0.5


def test_tracking_graph_is_cuda_only():
    """``graph=None`` is eager on the CPU, ``graph=True`` there raises, and
    ``run_vo`` takes ``graph`` for the tracking VO too."""
    cfg = _port_tracking_cfg(False)
    poses = tsyn.orbit_trajectory(3, radius=0.12, yaw_amp=0.1)
    grays, depths = tsyn.render_sequence(cfg.camera, poses)
    with pytest.raises(ValueError, match="CUDA"):
        tvo.vo_sequence_tracking(cfg, grays, depths, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        tvo.run_vo(cfg, grays, depths, device="cpu", graph=True)
    p, s = tvo.run_vo(cfg, grays, depths, device="cpu")
    assert p.shape == (3, 7) and s.ok.shape == (2,)
    with pytest.raises(ValueError, match="CUDA"):
        compiled.TrackGraphs(cfg, tvo.init_tracking(cfg, grays[0], depths[0]),
                             poses[0], grays.shape[1:], capture=True)
