"""Bundle-adjustment parity: the three solvers on the same graph in both
packages — gauss_newton_mm (dense_schur_mm) windowed + landmark-blocked
and full, gauss_newton (dense_schur) and gauss_newton_pcg (pcg) with gauge
and window masks and with a failed factorisation — plus the closed-form
pose-pose Jacobians, the final error pass, and the port's solvers against
each other. Chi² per iteration ≤ 1e-3 relative; poses and landmarks
≤ 1e-4. The reprojection factor (residual 1e-4 px, Jacobians 1e-4 relative,
and against autograd), each solver with error_type=1 and with use_obs_info
on a graph whose obs_info is symmetric positive on some rows and zero on
others (poses 1e-5, chi² 1e-5 relative), and pose_covariances (1e-4
relative, zero blocks for fixed keyframes, NaN blocks where the reduced
system is not positive definite)."""

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
    """Unknown solver names raise NotImplementedError at the front door and
    in each solver; an unknown factor type raises ValueError, as the JAX
    package's assemble_obs_terms does."""
    p = _problem()
    args = (t(p["kf_pose"]), t(p["kf_valid"]), t(p["lm_pos"]),
            t(p["lm_valid"]), convert.from_numpy(p["g"], "cpu"),
            torch.as_tensor(p["fixed_kf"]))
    for solver in ("sparse_cholesky", "g2o", ""):
        bcfg = port_cfg(dataclasses.replace(BackendConfig(), solver=solver))
        for fn in (topt.optimize_graph, topt.gauss_newton,
                   topt.gauss_newton_mm, topt.gauss_newton_pcg,
                   topt.pose_covariances):
            with pytest.raises(NotImplementedError):
                fn(bcfg, *args)
    with pytest.raises(ValueError):
        topt.optimize_graph(port_cfg(dataclasses.replace(
            BackendConfig(), error_type=2)), *args)


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


# ---------------------------------------------------------------------------
# The reprojection factor, full-information whitening, pose covariances
# ---------------------------------------------------------------------------


def _edges(seed, N=128):
    rng = np.random.default_rng(seed)
    tr = rng.normal(0, 0.3, (N, 3)).astype(np.float32)
    q = np.concatenate([np.ones((N, 1)), 0.2 * rng.normal(size=(N, 3))],
                       -1).astype(np.float32)
    pose = np.asarray(jse3.make_pose(jnp.asarray(tr), jnp.asarray(q)))
    p_cam = (rng.uniform(-1, 1, (N, 3)) + [0, 0, 2.5]).astype(np.float32)
    lm = np.asarray(jse3.apply(jnp.asarray(pose), jnp.asarray(p_cam)))
    z = (p_cam + rng.normal(0, 0.01, p_cam.shape)).astype(np.float32)
    return pose, lm, z


@pytest.mark.parametrize("f", [(80.0, 80.0), (517.3, 516.5)])
def test_reprojection_factor_matches_jax(f):
    """Residual ≤ 1e-4 px, Jacobians ≤ 1e-4 relative to their largest
    entry, assemble_obs_terms for both factor types."""
    fu, fv = f
    pose, lm, z = _edges(0)
    ref = jfactors.reproj_residual(jnp.asarray(pose), jnp.asarray(lm),
                                   jnp.asarray(z), fu, fv)
    got = tfactors.reproj_residual(t(pose), t(lm), t(z), fu, fv)
    assert got.shape == (len(pose), 2)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-4)
    for a, b in zip(tfactors.reproj_jacobians(t(pose), t(lm), fu, fv),
                    jfactors.reproj_jacobians(jnp.asarray(pose),
                                              jnp.asarray(lm), fu, fv)):
        b = np.asarray(b)
        assert np.abs(n(a) - b).max() <= 1e-4 * np.abs(b).max()
    for et in (0, 1):
        for a, b in zip(
                tfactors.assemble_obs_terms(t(pose), t(lm), t(z), et, fu, fv),
                jfactors.assemble_obs_terms(jnp.asarray(pose), jnp.asarray(lm),
                                            jnp.asarray(z), et, fu, fv)):
            b = np.asarray(b)
            assert n(a).shape == b.shape
            assert np.abs(n(a) - b).max() <= 1e-4 * max(np.abs(b).max(), 1.0)
    with pytest.raises(ValueError):
        tfactors.assemble_obs_terms(t(pose), t(lm), t(z), 2)
    # the z guard: a point on the camera plane projects with z = 1e-6
    p0 = np.array([[0.1, 0.2, 0.0]], np.float32)
    np.testing.assert_allclose(
        n(tfactors._project(t(p0), fu, fv)),
        np.asarray(jfactors._project(jnp.asarray(p0), fu, fv)), rtol=1e-6)


def test_reprojection_jacobians_match_autograd():
    """The closed form against torch.autograd.functional.jacobian of the
    residual under a right perturbation T∘exp(ξ) and a landmark step, in
    float64: ≤ 1e-5 relative."""
    from putslam_tpu_torch.geometry import se3 as tse3

    fu, fv = 517.3, 516.5
    pose, lm, z = (t(x).double() for x in _edges(1, N=6))
    Jp, Jl = tfactors.reproj_jacobians(pose, lm, fu, fv)
    for i in range(pose.shape[0]):
        def r_pose(xi):
            return tfactors.reproj_residual(tse3.retract(pose[i], xi), lm[i],
                                            z[i], fu, fv)

        def r_lm(dl):
            return tfactors.reproj_residual(pose[i], lm[i] + dl, z[i], fu, fv)

        # at ξ = 1e-7, not 0: the exponential map's norm has no gradient at
        # the origin, and the Jacobian moves by O(|ξ|) only
        Jp_ad = torch.autograd.functional.jacobian(
            r_pose, torch.full((6,), 1e-7, dtype=torch.float64))
        Jl_ad = torch.autograd.functional.jacobian(
            r_lm, torch.zeros(3, dtype=torch.float64))
        np.testing.assert_allclose(n(Jp[i]), n(Jp_ad),
                                   atol=1e-5 * float(Jp_ad.abs().max()))
        np.testing.assert_allclose(n(Jl[i]), n(Jl_ad),
                                   atol=1e-5 * float(Jl_ad.abs().max()))


def _with_info(p, seed=7, sig_lo=0.003):
    """The toy graph with a symmetric positive obs_info on ~70 % of the
    rows (information of a ``sig_lo``–30 mm anisotropic noise) and zero on
    the rest, which fall back to √obs_w·I."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, 3, 3)).astype(np.float32)
    Q, _ = np.linalg.qr(A)
    sig = rng.uniform(sig_lo, 0.03, (M, 3)).astype(np.float32)
    info = np.einsum("mij,mj,mkj->mik", Q, 1.0 / sig ** 2, Q)
    info = (0.5 * (info + np.swapaxes(info, -1, -2))).astype(np.float32)
    info[rng.uniform(size=M) < 0.3] = 0.0
    return dict(p, g=p["g"]._replace(obs_info=info))


SOLVER_NAMES = ["dense_schur", "dense_schur_mm", "pcg"]


@pytest.mark.parametrize("solver", SOLVER_NAMES)
@pytest.mark.parametrize("mode", ["error_type_1", "use_obs_info"])
def test_solvers_with_reprojection_and_obs_info_match_jax(solver, mode):
    """Each solver with the reprojection factor (weights gate/σ_px², never
    obs_w; the tiny camera's intrinsics through ``cam``) and with the stored
    information matrices whitening the 3D residual: poses ≤ 1e-5, chi² ≤
    1e-5 relative, the final errors 1e-3. Damping 1e-2 keeps the toy graph
    well-posed for every solver: at the default 1e-5 the Gauss-Newton step
    of the reprojection problem overshoots (chi² rises, pcg diverges) in
    both packages, and float32 rounding is amplified to 0.5 %."""
    from putslam_tpu.config import tiny_test_config

    over = dict(error_type=1) if mode == "error_type_1" \
        else dict(use_obs_info=True)
    bcfg = dataclasses.replace(BackendConfig(), gn_iterations=3,
                               pcg_iterations=32, ba_window=0, ba_lm_block=0,
                               chi2_ratio_termination=0.0, damping=1e-2,
                               **over)
    p = _with_info(_problem(5))
    cam = tiny_test_config().camera
    ref, got = _run_both(solver, bcfg, p, cam)
    chi2 = np.asarray(ref.chi2)
    assert np.all(np.isfinite(chi2)) and chi2[-1] < chi2[0]
    np.testing.assert_allclose(n(got.chi2), chi2, rtol=1e-5)
    np.testing.assert_allclose(n(got.kf_pose), np.asarray(ref.kf_pose),
                               atol=1e-5)
    np.testing.assert_allclose(n(got.lm_pos), np.asarray(ref.lm_pos),
                               atol=1e-4)
    np.testing.assert_allclose(n(got.obs_sq_err), np.asarray(ref.obs_sq_err),
                               rtol=1e-3, atol=1e-3)
    # the other branch really is another problem
    plain, _ = _run_both(solver, dataclasses.replace(
        bcfg, error_type=0, use_obs_info=False), p, cam)
    assert abs(float(plain.chi2[0]) - float(chi2[0])) > 1e-3 * chi2[0]


def test_error_type_1_without_a_camera_uses_525():
    bcfg = dataclasses.replace(BackendConfig(), gn_iterations=2, error_type=1,
                               damping=1e-2)
    p = _problem(6)
    ref, got = _run_both("dense_schur", bcfg, p, None)
    np.testing.assert_allclose(n(got.chi2), np.asarray(ref.chi2), rtol=1e-5)
    ref2, _ = _run_both("dense_schur", bcfg, p,
                        dataclasses.replace(CameraConfig(), fu=525.0,
                                            fv=525.0))
    np.testing.assert_allclose(np.asarray(ref2.chi2), np.asarray(ref.chi2),
                               rtol=1e-6)


def test_whitening_falls_back_to_the_scalar_weight():
    """obs_info all zero with use_obs_info: every observation whitens with
    √obs_w·I, so the solve equals the scalar-weighted one."""
    p = _problem(8)
    outs = []
    for use in (False, True):
        bcfg = dataclasses.replace(BackendConfig(), gn_iterations=2,
                                   use_obs_info=use)
        outs.append(topt.gauss_newton(
            port_cfg(bcfg), *(t(p[k]) for k in ("kf_pose", "kf_valid",
                                                "lm_pos", "lm_valid")),
            convert.from_numpy(p["g"], "cpu"), t(p["fixed_kf"]),
            t(p["lm_gen"]), t(p["kf_gen"])))
    np.testing.assert_allclose(n(outs[1].chi2), n(outs[0].chi2), rtol=1e-5)
    np.testing.assert_allclose(n(outs[1].kf_pose), n(outs[0].kf_pose),
                               atol=1e-6)
    Lw = n(topt._whitening_chol(convert.from_numpy(_with_info(p)["g"], "cpu")))
    ref = np.asarray(jopt._whitening_chol(
        jgraph.GraphState(*map(jnp.asarray, _with_info(p)["g"])),
        jnp.float32))
    np.testing.assert_allclose(Lw, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["plain", "use_obs_info", "error_type_1"])
def test_pose_covariances_match_jax(mode):
    """(K, 6, 6) marginal covariances ≤ 1e-4 relative to each block's
    largest entry; fixed and invalid keyframes get exact zero blocks. A
    well-posed problem: damping 1e-2 and information matrices of 10–30 mm
    noise (at 3 mm the float32 result of either package is 4e-4 from the
    float64 one, above this tolerance). The reprojection factor's reduced
    system is worse conditioned (depth is weakly observed): there either
    package's float32 result is 1.2e-3 from the float64 one, and the
    packages are held to 2e-3."""
    over = {"plain": {}, "use_obs_info": dict(use_obs_info=True),
            "error_type_1": dict(error_type=1)}[mode]
    bcfg = dataclasses.replace(BackendConfig(), damping=1e-2, **over)
    p = _with_info(_problem(9), sig_lo=0.01)
    cam = CameraConfig()
    ref = np.asarray(jopt.pose_covariances(
        bcfg, *(jnp.asarray(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos",
                                             "lm_valid")),
        jgraph.GraphState(*map(jnp.asarray, p["g"])),
        jnp.asarray(p["fixed_kf"]), jnp.asarray(p["lm_gen"]),
        jnp.asarray(p["kf_gen"]), cam=cam))
    got = n(topt.pose_covariances(
        port_cfg(bcfg), *(t(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos",
                                            "lm_valid")),
        convert.from_numpy(p["g"], "cpu"), t(p["fixed_kf"]), t(p["lm_gen"]),
        t(p["kf_gen"]), cam=port_cfg(cam)))
    assert got.shape == (K, 6, 6) and np.all(np.isfinite(ref))
    frozen = p["fixed_kf"] | ~p["kf_valid"]
    assert np.all(got[frozen] == 0) and np.all(ref[frozen] == 0)
    free = ~frozen
    scale = np.abs(ref[free]).max(axis=(-1, -2), keepdims=True)
    assert np.all(scale > 0)
    tol = 2e-3 if mode == "error_type_1" else 1e-4
    assert np.all(np.abs(got[free] - ref[free]) <= tol * scale), \
        float((np.abs(got[free] - ref[free]) / scale).max())
    # a covariance: symmetric with a positive diagonal
    assert np.all(np.einsum("kii->ki", got[free]) > 0)


def test_pose_covariances_of_an_indefinite_system_are_nan():
    """A NaN measurement makes the reduced system fail its Cholesky: the
    JAX package returns NaN blocks silently, and so does the port (no
    exception); frozen blocks stay zero."""
    bcfg = BackendConfig()
    p = _problem(3)
    xyz = p["g"].obs_xyz.copy()
    xyz[5] = np.nan
    p["g"] = p["g"]._replace(obs_xyz=xyz)
    ref = np.asarray(jopt.pose_covariances(
        bcfg, *(jnp.asarray(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos",
                                             "lm_valid")),
        jgraph.GraphState(*map(jnp.asarray, p["g"])),
        jnp.asarray(p["fixed_kf"]), jnp.asarray(p["lm_gen"]),
        jnp.asarray(p["kf_gen"])))
    got = n(topt.pose_covariances(
        port_cfg(bcfg), *(t(p[k]) for k in ("kf_pose", "kf_valid", "lm_pos",
                                            "lm_valid")),
        convert.from_numpy(p["g"], "cpu"), t(p["fixed_kf"]), t(p["lm_gen"]),
        t(p["kf_gen"])))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    frozen = p["fixed_kf"] | ~p["kf_valid"]
    assert np.isnan(got[~frozen]).all() and np.all(got[frozen] == 0)


def test_prune_mask_from_errors():
    sq = np.array([0.0, 5.0, 25.1, np.inf], np.float32)
    np.testing.assert_array_equal(
        n(topt.prune_mask_from_errors(port_cfg(BackendConfig()), t(sq), 25.0)),
        np.asarray(jopt.prune_mask_from_errors(BackendConfig(),
                                               jnp.asarray(sq), 25.0)))


@pytest.mark.slow
def test_dumped_card_map_matches_jax():
    """Both packages on a map that ``chip_smoke.py --dump-map`` wrote on the
    card (fr1 capacities: K = 256, L = 8192; the path in the environment
    variable PUTSLAM_MAP_DUMP; skipped without it), on the CPU:
    dense_schur_mm with the reprojection factor, with the whitening and
    plain, 3 iterations, the newest 16 keyframes free: chi² ≤ 1e-3
    relative, poses ≤ 1e-4; pose_covariances with the gauge alone fixed:
    the same blocks non-finite. Prints both packages' numbers."""
    import os

    from putslam_tpu.config import tum_fr1_config

    path = os.environ.get("PUTSLAM_MAP_DUMP", "")
    if not os.path.exists(path):
        pytest.skip("PUTSLAM_MAP_DUMP names no map dump")
    z = np.load(path)
    cfg = tum_fr1_config()
    jg = jgraph.GraphState(**{k: jnp.asarray(z["graph_" + k])
                              for k in jgraph.GraphState._fields})
    tg = convert.from_numpy(jgraph.GraphState(
        **{k: z["graph_" + k] for k in jgraph.GraphState._fields}), "cpu")
    names = ("kf_pose", "kf_valid", "lm_pos", "lm_valid")
    valid = z["map_kf_valid"]
    for over in (dict(error_type=1), dict(use_obs_info=True), {}):
        bcfg = dataclasses.replace(cfg.backend, gn_iterations=3, ba_window=0,
                                   robust_kernel="none", **over)
        ref = jopt.optimize_graph(
            bcfg, *(jnp.asarray(z["map_" + k]) for k in names), jg,
            jnp.asarray(z["window_fixed"]), lm_gen=jnp.asarray(z["map_lm_gen"]),
            kf_gen=jnp.asarray(z["map_kf_gen"]), cam=cfg.camera)
        got = topt.optimize_graph(
            port_cfg(bcfg), *(t(z["map_" + k]) for k in names), tg,
            t(z["window_fixed"]), lm_gen=t(z["map_lm_gen"]),
            kf_gen=t(z["map_kf_gen"]), cam=port_cfg(cfg.camera))
        moved = [float(np.abs(n(x.kf_pose) - z["map_kf_pose"])[valid].max())
                 for x in (ref, got)]
        print(f"{over}: chi2 JAX {np.asarray(ref.chi2)} port {n(got.chi2)}; "
              f"poses moved JAX {moved[0]:.4e} port {moved[1]:.4e} m")
        np.testing.assert_allclose(n(got.chi2), np.asarray(ref.chi2),
                                   rtol=1e-3)
        np.testing.assert_allclose(n(got.kf_pose), np.asarray(ref.kf_pose),
                                   atol=1e-4)
    bcfg = dataclasses.replace(cfg.backend, use_obs_info=True)
    ref = np.asarray(jopt.pose_covariances(
        bcfg, *(jnp.asarray(z["map_" + k]) for k in names), jg,
        jnp.asarray(z["gauge"]), lm_gen=jnp.asarray(z["map_lm_gen"]),
        kf_gen=jnp.asarray(z["map_kf_gen"]), cam=cfg.camera))
    got = n(topt.pose_covariances(
        port_cfg(bcfg), *(t(z["map_" + k]) for k in names), tg, t(z["gauge"]),
        lm_gen=t(z["map_lm_gen"]), kf_gen=t(z["map_kf_gen"]),
        cam=port_cfg(cfg.camera)))
    free = valid & ~z["gauge"]
    bad = [int((~np.isfinite(c[free]).all(axis=(1, 2))).sum())
           for c in (ref, got)]
    print(f"pose_covariances, gauge alone fixed: non-finite blocks JAX "
          f"{bad[0]} port {bad[1]} of {int(free.sum())}")
    assert bad[0] == bad[1]
