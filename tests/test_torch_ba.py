"""Bundle-adjustment parity: the three solvers on the same graph in both
packages — gauss_newton_mm (dense_schur_mm) windowed + landmark-blocked
and full, gauss_newton (dense_schur) and gauss_newton_pcg (pcg) with gauge
and window masks and with a failed factorisation — plus the closed-form
pose-pose Jacobians, the final error pass, and the port's solvers against
each other. Chi² per iteration ≤ 1e-3 relative; poses and landmarks
≤ 1e-4."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t

from putslam_tpu.backend import factors as jfactors
from putslam_tpu.backend import graph as jgraph
from putslam_tpu.backend import optimize as jopt
from putslam_tpu.config import BackendConfig, CameraConfig
from putslam_tpu.geometry import se3 as jse3
from putslam_tpu_torch import convert
from putslam_tpu_torch.backend import factors as tfactors
from putslam_tpu_torch.backend import optimize as topt

K, L, M, E = 12, 400, 2048, 16


def _problem(seed=0):
    """A noisy graph: 9 valid keyframes on an arc, ~300 valid landmarks,
    observations (some stale by generation), odometry edges."""
    rng = np.random.default_rng(seed)
    nk, nl = 9, 300
    tr = np.stack([0.1 * np.arange(K), 0.02 * np.sin(np.arange(K)),
                   np.zeros(K)], -1).astype(np.float32)
    q = np.concatenate([np.ones((K, 1)), 0.03 * rng.normal(size=(K, 3))], -1)
    gt = np.asarray(jse3.make_pose(jnp.asarray(tr), jnp.asarray(q, np.float32)))
    lm_gt = (rng.uniform(-1.5, 1.5, (L, 3)) + [0.4, 0, 3.0]).astype(np.float32)
    kf_valid = np.arange(K) < nk
    lm_valid = np.zeros(L, bool)
    lm_valid[rng.permutation(L)[:nl]] = True

    obs_kf, obs_lm = [], []
    for k in range(nk):
        seen = np.nonzero(lm_valid & (rng.uniform(size=L) < 0.35))[0]
        obs_kf += [k] * len(seen)
        obs_lm += list(seen)
    m = len(obs_kf)
    assert m < M
    pad = M - m
    obs_kf = np.array(obs_kf + [0] * pad, np.int32)
    obs_lm = np.array(obs_lm + [0] * pad, np.int32)
    z = np.asarray(jse3.apply(jse3.inverse(jnp.asarray(gt[obs_kf])),
                              jnp.asarray(lm_gt[obs_lm])))
    z = (z + rng.normal(0, 0.003, z.shape)).astype(np.float32)
    z[rng.uniform(size=M) < 0.02] += 0.3                   # a few outliers
    obs_valid = np.arange(M) < m
    obs_gen = np.zeros(M, np.int32)
    obs_gen[rng.uniform(size=M) < 0.03] = 1                # stale edges

    pp_i = np.array(list(range(nk - 1)) + [0] * (E - nk + 1), np.int32)
    pp_j = np.array(list(range(1, nk)) + [0] * (E - nk + 1), np.int32)
    rel = np.asarray(jse3.relative(jnp.asarray(gt[pp_i]), jnp.asarray(gt[pp_j])))
    g = jgraph.GraphState(
        obs_kf=obs_kf, obs_lm=obs_lm, obs_xyz=z,
        obs_w=np.full(M, 625.0, np.float32), obs_gen=obs_gen,
        obs_kfgen=np.zeros(M, np.int32), obs_seq=np.arange(M, dtype=np.int32),
        obs_valid=obs_valid, n_obs=np.int32(m),
        obs_info=np.zeros((M, 3, 3), np.float32),
        pp_i=pp_i, pp_j=pp_j, pp_rel=rel.astype(np.float32),
        pp_w=np.full(E, 100.0, np.float32), pp_gen_i=np.zeros(E, np.int32),
        pp_gen_j=np.zeros(E, np.int32), pp_valid=np.arange(E) < nk - 1,
        n_pp=np.int32(nk - 1))
    noise = np.concatenate([rng.normal(0, 0.01, (K, 3)),
                            rng.normal(0, 0.005, (K, 3))], -1)
    kf0 = np.asarray(jse3.retract(jnp.asarray(gt), jnp.asarray(
        noise, np.float32)))
    lm0 = (lm_gt + rng.normal(0, 0.01, lm_gt.shape)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    return dict(kf_pose=kf0, kf_valid=kf_valid, lm_pos=lm0, lm_valid=lm_valid,
                g=g, fixed_kf=fixed, lm_gen=np.zeros(L, np.int32),
                kf_gen=np.zeros(K, np.int32))


@pytest.mark.parametrize("window,block", [(4, 128), (0, 0)])
def test_gauss_newton_mm_matches_jax(window, block):
    """(4, 128): the active window (4 < K) and the landmark block (128 <
    300 valid: the surplus is dropped from the call); (0, 0): full axes."""
    bcfg = dataclasses.replace(BackendConfig(), gn_iterations=3,
                               ba_window=window, ba_lm_block=block,
                               chi2_ratio_termination=0.0)
    cam = CameraConfig()
    p = _problem()
    ref = jopt.gauss_newton_mm(
        bcfg, *(jnp.asarray(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos",
                                             "lm_valid")),
        jgraph.GraphState(*map(jnp.asarray, p["g"])), jnp.asarray(p["fixed_kf"]),
        jnp.asarray(p["lm_gen"]), jnp.asarray(p["kf_gen"]), cam=cam)
    got = topt.gauss_newton_mm(
        port_cfg(bcfg), *(t(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos",
                                  "lm_valid")),
        convert.from_numpy(p["g"], "cpu"), t(p["fixed_kf"]), t(p["lm_gen"]),
        t(p["kf_gen"]), cam=port_cfg(cam))
    chi2 = np.asarray(ref.chi2)
    assert chi2[-1] < chi2[0]                 # the step does descend
    np.testing.assert_allclose(n(got.chi2), chi2, rtol=1e-3)
    np.testing.assert_allclose(n(got.kf_pose), np.asarray(ref.kf_pose),
                               atol=1e-4)
    np.testing.assert_allclose(n(got.lm_pos), np.asarray(ref.lm_pos),
                               atol=1e-4)
    np.testing.assert_allclose(n(got.obs_sq_err), np.asarray(ref.obs_sq_err),
                               rtol=1e-3, atol=1e-3)


def test_chi2_ratio_termination_matches_jax():
    """With the default 0.999 ratio the later iterations stop early and
    report the last chi² — the same iterations in both packages."""
    bcfg = dataclasses.replace(BackendConfig(), gn_iterations=6, ba_window=4,
                               ba_lm_block=256)
    p = _problem(1)
    ref = jopt.gauss_newton_mm(
        bcfg, *(jnp.asarray(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos",
                                             "lm_valid")),
        jgraph.GraphState(*map(jnp.asarray, p["g"])), jnp.asarray(p["fixed_kf"]),
        jnp.asarray(p["lm_gen"]), jnp.asarray(p["kf_gen"]))
    got = topt.gauss_newton_mm(
        port_cfg(bcfg), *(t(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos",
                                  "lm_valid")),
        convert.from_numpy(p["g"], "cpu"), t(p["fixed_kf"]), t(p["lm_gen"]),
        t(p["kf_gen"]))
    np.testing.assert_allclose(n(got.chi2), np.asarray(ref.chi2), rtol=1e-3)
    np.testing.assert_allclose(n(got.kf_pose), np.asarray(ref.kf_pose),
                               atol=1e-4)


def test_pp_jacobians_match_jax_closed_form():
    rng = np.random.default_rng(4)

    def poses(scale):
        tr = rng.normal(0, scale, (64, 3)).astype(np.float32)
        q = np.concatenate([np.ones((64, 1)), scale * rng.normal(size=(64, 3))],
                           -1).astype(np.float32)
        return np.asarray(jse3.make_pose(jnp.asarray(tr), jnp.asarray(q)))

    pi, pj, z = poses(0.5), poses(0.5), poses(0.3)
    ref = jfactors.pp_jacobians(jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(z))
    got = tfactors.pp_jacobians(t(pi), t(pj), t(z))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        n(tfactors.pp_residual(t(pi), t(pj), t(z))),
        np.asarray(jfactors.pp_residual(jnp.asarray(pi), jnp.asarray(pj),
                                        jnp.asarray(z))), atol=1e-5)


def test_unported_solver_raises():
    """The reprojection factor, full-information whitening and unknown
    solver names still raise at the front door."""
    p = _problem()
    for over in (dict(error_type=1), dict(use_obs_info=True),
                 dict(solver="sparse_cholesky")):
        bcfg = dataclasses.replace(BackendConfig(), **over)
        with pytest.raises(NotImplementedError):
            topt.optimize_graph(port_cfg(bcfg), t(p["kf_pose"]),
                                t(p["kf_valid"]),
                                t(p["lm_pos"]), t(p["lm_valid"]),
                                convert.from_numpy(p["g"], "cpu"),
                                torch.as_tensor(p["fixed_kf"]))


def _run_both(solver, bcfg, p, cam=None):
    jfn = {"dense_schur": jopt.gauss_newton, "pcg": jopt.gauss_newton_pcg,
           "dense_schur_mm": jopt.gauss_newton_mm}[solver]
    ref = jfn(bcfg, *(jnp.asarray(p[k]) for k in ("kf_pose", "kf_valid",
                                                   "lm_pos", "lm_valid")),
              jgraph.GraphState(*map(jnp.asarray, p["g"])),
              jnp.asarray(p["fixed_kf"]), jnp.asarray(p["lm_gen"]),
              jnp.asarray(p["kf_gen"]), cam=cam)
    got = topt.optimize_graph(
        port_cfg(dataclasses.replace(bcfg, solver=solver)),
        *(t(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos", "lm_valid")),
        convert.from_numpy(p["g"], "cpu"), t(p["fixed_kf"]), t(p["lm_gen"]),
        t(p["kf_gen"]), cam=cam and port_cfg(cam))
    return ref, got


@pytest.mark.parametrize("solver", ["dense_schur", "pcg"])
@pytest.mark.parametrize("n_fixed", [2, 5])
def test_dense_schur_and_pcg_match_jax(solver, n_fixed):
    """gauss_newton (dense_schur) and gauss_newton_pcg on the toy graph,
    with the gauge (2 fixed keyframes) or a window (5 fixed)."""
    bcfg = dataclasses.replace(BackendConfig(), gn_iterations=3,
                               pcg_iterations=32)
    p = _problem(2)
    p["fixed_kf"] = np.arange(K) < n_fixed
    ref, got = _run_both(solver, bcfg, p, CameraConfig())
    chi2 = np.asarray(ref.chi2)
    assert chi2[-1] < chi2[0]
    np.testing.assert_allclose(n(got.chi2), chi2, rtol=1e-3)
    np.testing.assert_allclose(n(got.kf_pose), np.asarray(ref.kf_pose),
                               atol=1e-4)
    np.testing.assert_allclose(n(got.lm_pos), np.asarray(ref.lm_pos),
                               atol=1e-4)
    np.testing.assert_allclose(n(got.obs_sq_err), np.asarray(ref.obs_sq_err),
                               rtol=1e-3, atol=1e-3)
    fixed = p["fixed_kf"] | ~p["kf_valid"]
    np.testing.assert_array_equal(n(got.kf_pose)[fixed], p["kf_pose"][fixed])


@pytest.mark.parametrize("solver", ["dense_schur", "pcg"])
def test_failed_factorisation_gives_a_zero_step(solver):
    """A NaN measurement poisons the camera system: the Cholesky (or the
    preconditioner) fails, the guards turn the step into zero — no
    exception — and every pose stays put, as in the JAX package."""
    bcfg = dataclasses.replace(BackendConfig(), gn_iterations=2)
    p = _problem(3)
    g = p["g"]
    xyz = g.obs_xyz.copy()
    xyz[5] = np.nan
    p["g"] = g._replace(obs_xyz=xyz)
    ref, got = _run_both(solver, bcfg, p)
    np.testing.assert_array_equal(np.asarray(ref.kf_pose), p["kf_pose"])
    np.testing.assert_array_equal(n(got.kf_pose), p["kf_pose"])
    np.testing.assert_allclose(n(got.lm_pos), np.asarray(ref.lm_pos),
                               atol=1e-4)
    assert np.isnan(n(got.chi2)).all() and np.isnan(np.asarray(ref.chi2)).all()


def test_port_solvers_agree():
    """The port's three solvers on one problem: poses within 2e-4 of
    dense_schur and the final chi² within 2 % (the JAX package's
    test_round3.py::test_solvers_agree tolerances)."""
    p = _problem(4)
    sols = {}
    for solver in ("dense_schur", "dense_schur_mm", "pcg"):
        bcfg = dataclasses.replace(BackendConfig(), solver=solver,
                                   gn_iterations=6, robust_kernel="none",
                                   ba_window=0, pcg_iterations=32)
        sols[solver] = topt.optimize_graph(
            port_cfg(bcfg), *(t(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos",
                                      "lm_valid")),
            convert.from_numpy(p["g"], "cpu"), t(p["fixed_kf"]),
            t(p["lm_gen"]), t(p["kf_gen"]))
    ref = n(sols["dense_schur"].kf_pose)
    chi_ref = float(sols["dense_schur"].chi2[-1])
    for solver in ("dense_schur_mm", "pcg"):
        np.testing.assert_allclose(n(sols[solver].kf_pose), ref, atol=2e-4)
        chi = float(sols[solver].chi2[-1])
        assert abs(chi - chi_ref) < 0.02 * max(chi_ref, 1e-6), solver
