"""The landmark-sharded BA (parallel/dist_ba.py) against the JAX package's.

The port's per-rank body, run for every rank of a mesh of 1, 2, 4 and 8
virtual ranks in one process and summed, against the JAX function on
conftest.py's 8 virtual CPU devices at the same mesh size, on the same
numpy inputs: chi² per iteration within 1e-3 relative, poses and landmarks
within 1e-4, ``overflow`` equal (the tolerances of the single-device solver
parity, tests/test_torch_ba.py). Against the port's own ``gauss_newton``
(dense f32 Schur) the tolerances of tests/test_dist_ba.py:36-42: chi² 5e-3
relative + 1e-4, poses 1e-3, landmarks 5e-3 (the bf16-rounded coupling
bends the step). The owner partition's overflow on tests/test_dist_ba.py's
skewed graph equals the JAX count, host and in-solver."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t
from test_backend import build_problem
from test_torch_ba import _problem

from putslam_tpu.config import BackendConfig, CameraConfig
from putslam_tpu.parallel import dist_ba as jdist
from putslam_tpu.parallel import mesh as jmesh
from putslam_tpu_torch import convert
from putslam_tpu_torch.backend import optimize as topt
from putslam_tpu_torch.parallel import dist_ba as tdist
from putslam_tpu_torch.parallel import mesh as tmesh


def _toy(seed=0, **kw):
    """tests/test_dist_ba.py's graph: 6 keyframes, 64 landmarks."""
    rng = np.random.default_rng(seed)
    _, _, kf0, lm0, g = build_problem(rng, **kw)
    K, L = kf0.shape[0], lm0.shape[0]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(kf_pose=kf0, kf_valid=np.ones(K, bool), lm_pos=lm0,
                lm_valid=np.ones(L, bool), g=jax.tree.map(np.asarray, g),
                fixed_kf=fixed, lm_gen=np.zeros(L, np.int32),
                kf_gen=np.zeros(K, np.int32))


ARGS = ("kf_pose", "kf_valid", "lm_pos", "lm_valid")


def _jax(bcfg, size, p, cam=None):
    return jdist.dist_gauss_newton(
        bcfg, jmesh.make_mesh(size, axis="lm"),
        *(jnp.asarray(p[k]) for k in ARGS),
        jax.tree.map(jnp.asarray, p["g"]), jnp.asarray(p["fixed_kf"]),
        jnp.asarray(p["lm_gen"]), jnp.asarray(p["kf_gen"]), cam=cam)


def _port(bcfg, size, p, cam=None):
    return tdist.dist_gauss_newton(
        port_cfg(bcfg), tmesh.make_mesh(size, axis="lm", device="cpu"),
        *(t(p[k]) for k in ARGS), convert.from_numpy(p["g"], "cpu"),
        t(p["fixed_kf"]), t(p["lm_gen"]), t(p["kf_gen"]),
        cam=None if cam is None else port_cfg(cam))


def _close_to_jax(got, ref):
    kf, lm, chi2, ovf = got
    np.testing.assert_allclose(n(chi2), np.asarray(ref[2]), rtol=1e-3)
    np.testing.assert_allclose(n(kf), np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_allclose(n(lm), np.asarray(ref[1]), atol=1e-4)
    assert int(ovf) == int(ref[3])


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_dist_gauss_newton_matches_jax(size):
    p = _toy(noise=0.003, K=6, L=64, obs_per_kf=48)
    bcfg = BackendConfig(gn_iterations=4, robust_kernel="cauchy",
                         damping=1e-5)
    got = _port(bcfg, size, p)
    _close_to_jax(got, _jax(bcfg, size, p))
    assert int(got[3]) == 0
    # and the port's own dense f32 Schur solver on the same graph
    res = topt.gauss_newton(
        port_cfg(bcfg), *(t(p[k]) for k in ARGS),
        convert.from_numpy(p["g"], "cpu"), t(p["fixed_kf"]), t(p["lm_gen"]))
    np.testing.assert_allclose(n(res.chi2), n(got[2]), rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(n(res.kf_pose), n(got[0]), atol=1e-3)
    np.testing.assert_allclose(n(res.lm_pos), n(got[1]), atol=5e-3)


@pytest.mark.parametrize("size", [2, 4])
def test_pose_edges_stale_observations_and_window_masks_match_jax(size):
    """tests/test_torch_ba.py's graph: 9 of 12 keyframes valid, 300 of 400
    landmarks, stale observations by generation, outliers, odometry edges
    (assembled on rank 0 alone), two keyframes fixed."""
    p = _problem(2)
    bcfg = dataclasses.replace(BackendConfig(), gn_iterations=3)
    cam = CameraConfig()
    _close_to_jax(_port(bcfg, size, p, cam), _jax(bcfg, size, p, cam))


@pytest.mark.parametrize("option", ["use_obs_info", "error_type_1"])
def test_factor_options_match_jax(option):
    """The whitening by stored 3×3 information (on some rows; the others
    fall back to √w·I) and the reprojection factor, at 2 ranks. Damping
    1e-2: at the default the reprojection step overshoots on this toy graph
    in both packages (ROADMAP 3t)."""
    p = _problem(3)
    rng = np.random.default_rng(3)
    A = rng.normal(size=(p["g"].obs_info.shape[0], 3, 3)).astype(np.float32)
    info = np.einsum("mij,mkj->mik", A, A) + 0.5 * np.eye(3, dtype=np.float32)
    info[rng.uniform(size=len(info)) < 0.5] = 0.0
    p["g"] = p["g"]._replace(obs_info=(info * 400.0).astype(np.float32))
    bcfg = BackendConfig(gn_iterations=3, damping=1e-2)
    bcfg = (dataclasses.replace(bcfg, use_obs_info=True)
            if option == "use_obs_info" else
            dataclasses.replace(bcfg, error_type=1))
    cam = CameraConfig()
    got = _port(bcfg, 2, p, cam)
    ref = _jax(bcfg, 2, p, cam)
    chi = n(got[2])
    assert chi[-1] < chi[0]
    _close_to_jax(got, ref)


def test_rank_partials_sum_to_one_rank():
    """The per-rank body alone: the packed partials (S, b_red, chi²) of the
    four ranks of a size-4 mesh sum to the one rank's of a size-1 mesh,
    within float32 summation order; each rank's S part is symmetric."""
    p = _problem(4)
    bcfg = port_cfg(dataclasses.replace(BackendConfig(), gn_iterations=1))
    g = convert.from_numpy(p["g"], "cpu")
    K, L = p["kf_pose"].shape[0], p["lm_pos"].shape[0]
    kf_pose, lm_pos = t(p["kf_pose"]), t(p["lm_pos"])
    lm_valid, lm_gen, kf_gen = t(p["lm_valid"]), t(p["lm_gen"]), t(p["kf_gen"])

    def total(size):
        Ls = L // size
        idx, inb, ovf = tdist.owner_partition(g, size, Ls)
        assert int(ovf) == 0
        parts = []
        for r in range(size):
            s = slice(r * Ls, (r + 1) * Ls)
            packed, _ = tdist.rank_partial(
                bcfg, None, r, kf_pose, kf_gen, lm_pos[s], lm_valid[s],
                lm_gen[s], tdist.make_shard(g, idx, inb, r, K, Ls), g)
            S, _, _ = tdist.unpack(packed, K)
            assert torch.allclose(S, S.T, atol=1e-2)
            parts.append(packed)
        return torch.stack(parts).sum(0)

    one, four = total(1), total(4)
    S1, b1, c1 = tdist.unpack(one, K)
    S4, b4, c4 = tdist.unpack(four, K)
    scale = float(S1.abs().max())
    assert float((S1 - S4).abs().max()) <= 1e-5 * scale
    assert float((b1 - b4).abs().max()) <= 1e-5 * float(b1.abs().max())
    np.testing.assert_allclose(float(c4), float(c1), rtol=1e-5)


def test_dist_ba_converges():
    """tests/test_dist_ba.py:45-58 on the port: noise-free graph, 8 ranks."""
    rng = np.random.default_rng(5)
    kf_true, _, kf0, lm0, g = build_problem(rng, noise=0.0)
    K, L = kf0.shape[0], lm0.shape[0]
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    kf, _, chi2, ovf = tdist.dist_gauss_newton(
        port_cfg(BackendConfig(gn_iterations=6, robust_kernel="none",
                               damping=1e-5)),
        tmesh.make_mesh(8, axis="lm", device="cpu"), t(kf0),
        torch.ones(K, dtype=torch.bool), t(lm0), torch.ones(L, dtype=torch.bool),
        convert.from_numpy(jax.tree.map(np.asarray, g), "cpu"), fixed,
        torch.zeros(L, dtype=torch.int32))
    chi = n(chi2)
    assert chi[-1] < 1e-4 * chi[0] + 1e-8
    assert np.abs(n(kf)[:, :3] - kf_true[:, :3]).max() < 2e-3
    assert int(ovf) == 0


def test_partition_overflow_on_a_skewed_graph_matches_jax():
    """tests/test_dist_ba.py:60-82: every observation remapped onto
    landmarks 0..7 (rank 0's block of an 8-rank mesh), so rank 0 owns all M
    and keeps Ms = 2M/8: the dropped count, on the host and in the solver,
    equals the JAX package's."""
    p = _toy(seed=6, K=4, L=64, obs_per_kf=64, noise=0.0, cap=256)
    p["g"] = p["g"]._replace(obs_lm=p["g"].obs_lm % 8)
    bcfg = BackendConfig(gn_iterations=1, robust_kernel="none", damping=1e-5)
    ref = _jax(bcfg, 8, p)
    got = _port(bcfg, 8, p)
    M = int(p["g"].obs_valid.sum())
    slack = max(8, (2 * p["g"].obs_kf.shape[0]) // 8)
    assert int(got[3]) == int(ref[3]) == max(M - slack, 0) > 0
    L = p["lm_pos"].shape[0]
    tg = convert.from_numpy(p["g"], "cpu")
    assert tdist.partition_overflow(tg, 8, L) == jdist.partition_overflow(
        jax.tree.map(jnp.asarray, p["g"]), 8, L) == int(got[3])
    assert tdist.partition_overflow(tg, 1, L) == 0


def test_duplicate_lanes_reach_no_live_row():
    """The lanes past a rank's count duplicate other ranks' edges (the
    clipped ``order[take]``); they point at the sentinel keyframe and
    landmark (ROADMAP 3a)."""
    p = _toy(seed=7, K=4, L=64, obs_per_kf=20, cap=256)
    g = convert.from_numpy(p["g"], "cpu")
    K, L, size = 4, 64, 4
    Ls = L // size
    idx, inb, _ = tdist.owner_partition(g, size, Ls)
    for r in range(size):
        sh = tdist.make_shard(g, idx, inb, r, K, Ls)
        live = inb[r]
        assert bool((sh.kf[~live] == K).all() and (sh.lm[~live] == Ls).all())
        assert bool((sh.lm[live] < Ls).all() and (sh.lm[live] >= 0).all())
        assert not bool(sh.g.obs_valid[~live].any())
        # each owned observation appears once, in its owner's slice
        own = (g.obs_lm.long() // Ls == r) & g.obs_valid
        assert int(live.sum()) == int(own.sum())


def test_landmark_capacity_must_divide_the_mesh():
    p = _toy(K=4, L=64, obs_per_kf=20, cap=256)
    with pytest.raises(ValueError, match="divide"):
        _port(BackendConfig(gn_iterations=1), 3, p)
