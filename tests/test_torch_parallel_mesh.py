"""The rank mesh and session-parallel VO (parallel/mesh.py).

``vo_sessions_sharded`` is held exactly against the port's own
single-session ``vo_sequence`` run with the same generator (the session's
seed, ``session_seed``), and statistically against the JAX package's
``vo_sessions_sharded`` on the same JAX-rendered frames: the draws differ
(torch's generator is not ``jax.random``, ROADMAP 3f), so each session's
ATE must pass the golden table's VO gate (tests/golden_ate.json, orbit30_vo
0.08 m) in both packages, and the two packages' trajectories lie within
that gate of each other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.parallel import mesh as jmesh
from putslam_tpu_torch.eval import ate as tate
from putslam_tpu_torch.models import vo as tvo
from putslam_tpu_torch.parallel import mesh as tmesh

VO_GATE_M = 0.08          # tests/golden_ate.json orbit30_vo


def _sessions(B, T):
    """B orbits of T frames, the golden table's (radius 0.15 m, yaw 0.15)
    and narrower ones (radius 0.15 − 0.03·b), rendered by the JAX package:
    (grays, depths, poses) as (B, T, ...) numpy."""
    cfg = tiny_test_config()
    gs, ds, ps = [], [], []
    for b in range(B):
        poses = jsyn.orbit_trajectory(T, radius=0.15 - 0.03 * b,
                                      yaw_amp=0.15)
        g, d = jsyn.render_sequence(cfg.camera, poses)
        gs.append(np.asarray(g))
        ds.append(np.asarray(d))
        ps.append(np.asarray(poses))
    return cfg, np.stack(gs), np.stack(ds), np.stack(ps)


@pytest.mark.parametrize("size,B", [(1, 2), (2, 2), (2, 4)])
def test_vo_sessions_sharded_equals_each_session_alone(size, B):
    cfg, g, d, _ = _sessions(B, 4)
    mesh = tmesh.make_mesh(size, device="cpu")
    out = tmesh.vo_sessions_sharded(port_cfg(cfg), mesh, g, d, seed=5)
    assert out.shape == (B, 4, 7) and out.device.type == "cpu"
    for b in range(B):
        gen = torch.Generator()
        gen.manual_seed(tmesh.session_seed(5, b, B))
        ref, _ = tvo.vo_sequence(port_cfg(cfg), torch.as_tensor(g[b]),
                                 torch.as_tensor(d[b]), generator=gen)
        assert torch.equal(out[b], ref), b


def test_session_seeds_differ_and_sessions_must_split():
    seeds = {tmesh.session_seed(s, b, 4) for s in range(3) for b in range(4)}
    assert len(seeds) == 12
    cfg, g, d, _ = _sessions(3, 2)
    with pytest.raises(ValueError, match="split"):
        tmesh.vo_sessions_sharded(port_cfg(cfg),
                                  tmesh.make_mesh(2, device="cpu"), g, d)


def test_vo_sessions_sharded_against_jax():
    cfg, g, d, gt = _sessions(2, 30)
    ref = np.asarray(jmesh.vo_sessions_sharded(
        cfg, jmesh.make_mesh(2), jnp.asarray(g), jnp.asarray(d), seed=0))
    got = n(tmesh.vo_sessions_sharded(
        port_cfg(cfg), tmesh.make_mesh(2, device="cpu"), g, d, seed=0))
    assert got.shape == ref.shape == (2, 30, 7)
    for b in range(2):
        e_port = tate.ate_rmse_aligned_frames(gt[b], got[b])
        e_jax = tate.ate_rmse_aligned_frames(gt[b], ref[b])
        assert e_port < VO_GATE_M and e_jax < VO_GATE_M, (b, e_port, e_jax)
        assert np.abs(got[b, :, :3] - ref[b, :, :3]).max() < VO_GATE_M


def test_mesh_kinds_and_their_reduction():
    one = tmesh.make_mesh(device="cpu")
    assert (one.size, one.ranks, one.axis_names) == (1, (0,), ("session",))
    assert "identity" in repr(one)
    eight = tmesh.make_mesh(8, axis="lm", device="cpu")
    assert eight.ranks == tuple(range(8)) and eight.group is None
    assert "8 virtual ranks" in repr(eight)
    x = torch.ones(4)
    assert eight.all_reduce_(x) is x and torch.equal(x, torch.ones(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present")
        tmesh.make_mesh()
