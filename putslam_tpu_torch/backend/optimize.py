"""Bundle adjustment: Gauss-Newton with a Schur complement over landmarks.

Port of ``putslam_tpu/backend/optimize.py``: the three solvers behind
``optimize_graph`` — ``gauss_newton`` (``dense_schur``: a dense
(K, L, 6, 3) coupling buffer, ``S = H_cc − H_cl·H_ll⁻¹·H_clᵀ``, Cholesky),
``gauss_newton_mm`` (``dense_schur_mm``, the fr1 default) and
``gauss_newton_pcg`` (``pcg``: block-Jacobi preconditioned conjugate
gradients on the reduced camera system, matrix-free). ``dense_schur`` and
``pcg`` run every iteration (no chi² termination), as the JAX package's do.
The behaviour is the JAX package's; the formulation is the GPU's: the
one-hot matmuls that fed the TPU's MXU are gathers (``index_select``) and
segment sums here, and ``dense_schur``'s 2-D scatters (``.at[kf, lm].add``)
are segment sums on a flattened K·L axis. Every floating-point segment sum
goes through an ``ops/segment.py::SegmentPlan``, built once per call
before the Gauss-Newton loop (the index sets do not change inside it), as
the JAX package builds its one-hot matrices once: the rows of a segment are
added in ascending order (the CPU's ``index_add_``; on the card the
hand-written ``csrc/segment_sum.cu``), so a solve gives the same bits on
every run, eager or replayed from a CUDA graph. Where several scatters
feed one buffer (the pose-pose edges after the observations), their rows
are concatenated in the order the scatters ran and summed by one plan.

``gauss_newton_mm``:

Both compactions are kept: the active window (the ≤ ``ba_window`` free
keyframes get compact slots, so the reduced camera system is (6·W)²) and
the landmark block (the first ≤ ``ba_lm_block`` valid landmarks). Index
``KC`` / ``LC`` is the sentinel slot of a dropped observation.

Precision contract (``gauss_newton_mm``'s docstring): the whitened coupling
G (6·KC × 3·LC) is built in float32, rounded to bfloat16, upcast and
squared with a float32 matmul; the gradient stays exact float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from putslam_tpu_torch.backend import factors
from putslam_tpu_torch.backend.graph import GraphState
from putslam_tpu_torch.config import BackendConfig, CameraConfig
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.geometry.uncertainty import chol3x3, inv3x3
from putslam_tpu_torch.ops.segment import SegmentPlan
from putslam_tpu_torch.utils import control
from putslam_tpu_torch.utils.indexing import nonzero_fixed, set_rows


class BAResult(NamedTuple):
    kf_pose: torch.Tensor     # (K, 7) optimised poses
    lm_pos: torch.Tensor      # (L, 3) optimised landmarks
    chi2: torch.Tensor        # (iters,) weighted squared error per iteration
    obs_sq_err: torch.Tensor  # (M,) final per-observation weighted sq. error


SOLVERS = ("dense_schur", "dense_schur_mm", "pcg")


def check_backend_config(bcfg: BackendConfig) -> None:
    """Raise NotImplementedError for a solver the port does not have, and
    ValueError for an unknown factor type."""
    if bcfg.solver not in SOLVERS:
        raise NotImplementedError(
            f"backend.solver={bcfg.solver!r} is not ported yet")
    if bcfg.error_type not in (0, 1):
        raise ValueError(f"unknown error_type {bcfg.error_type}")


def _focal(cam: CameraConfig):
    """Intrinsics of the reprojection factor (525 px without a camera)."""
    return (cam.fu, cam.fv) if cam is not None else (525.0, 525.0)


def _whitening_chol(g: GraphState):
    """Per-observation whitening factor L with Info = L·Lᵀ. Observations
    stored without a full information matrix (``obs_info`` all zero: states
    made with ``use_uncertainty=False``) fall back to their scalar weight,
    √obs_w·I, instead of being annihilated by chol(0)."""
    tr = (g.obs_info[..., 0, 0] + g.obs_info[..., 1, 1]
          + g.obs_info[..., 2, 2])
    eye3 = torch.eye(3, dtype=g.obs_info.dtype, device=g.obs_info.device)
    scalar = torch.sqrt(torch.clamp(g.obs_w, min=0.0))[:, None, None] * eye3
    return torch.where((tr > 0.0)[:, None, None], chol3x3(g.obs_info), scalar)


def _whitens(bcfg: BackendConfig) -> bool:
    return bcfg.use_obs_info and bcfg.error_type == 0


def _info_weights(bcfg: BackendConfig, g: GraphState, gate):
    """Information weight of each observation: the gate alone where the
    stored 3×3 information whitens the residual, gate / σ_px² for the
    reprojection factor (pixels, never the metres⁻² ``obs_w``), else
    ``obs_w`` · gate."""
    if _whitens(bcfg):
        return gate.to(g.obs_w.dtype)
    if bcfg.error_type == 1:
        return gate.to(g.obs_w.dtype) / (bcfg.obs_pixel_sigma ** 2)
    return g.obs_w * gate


def _obs_terms(bcfg: BackendConfig, g: GraphState, kf_p, lm_p, gate, Lw,
               cam: CameraConfig):
    """Residuals, Jacobians, weights and weighted squared errors of the
    observations at the gathered poses and landmarks: (r, Jp, Jl, w, sq).
    ``Lw``: the whitening factors, or None without ``use_obs_info``."""
    r, Jp, Jl = factors.assemble_obs_terms(kf_p, lm_p, g.obs_xyz,
                                           bcfg.error_type, *_focal(cam))
    if Lw is not None:
        r = torch.einsum("msr,ms->mr", Lw, r)
        Jp = torch.einsum("msr,msj->mrj", Lw, Jp)
        Jl = torch.einsum("msr,msj->mrj", Lw, Jl)
    w_info = _info_weights(bcfg, g, gate)
    sq = w_info * torch.sum(r * r, dim=-1)
    w = w_info * factors.robust_weight(sq, bcfg.robust_kernel,
                                       bcfg.robust_delta)
    return r, Jp, Jl, w, sq


def _obs_gate(g: GraphState, lm_valid, lm_gen, kf_gen):
    """Live observations: valid, landmark valid, generations current."""
    gate = g.obs_valid & lm_valid[g.obs_lm]
    if lm_gen is not None:
        gate = gate & (g.obs_gen == lm_gen[g.obs_lm])
    if kf_gen is not None:
        gate = gate & (g.obs_kfgen == kf_gen[g.obs_kf])
    return gate


def _final_sq_errors(bcfg: BackendConfig, kf_pose, lm_pos, lm_valid,
                     g: GraphState, lm_gen=None, kf_gen=None,
                     cam: CameraConfig = None):
    """Per-observation weighted squared errors at a state (the prune
    signal), without Jacobians."""
    kf_p = kf_pose[g.obs_kf]
    lm_p = lm_pos[g.obs_lm]
    if bcfg.error_type == 0:
        r = factors.obs_residual(kf_p, lm_p, g.obs_xyz)
    else:
        r = factors.reproj_residual(kf_p, lm_p, g.obs_xyz, *_focal(cam))
    if _whitens(bcfg):
        r = torch.einsum("msr,ms->mr", _whitening_chol(g), r)
    w_info = _info_weights(bcfg, g, _obs_gate(g, lm_valid, lm_gen, kf_gen))
    return w_info * torch.sum(r * r, dim=-1)


def _live(idx, gate, n: int):
    """``idx`` where ``gate`` holds, else the sentinel n. A plan's rows
    whose gate is off carry zero weight, so every term they would add is
    ±0, which leaves a sum that starts at +0 unchanged: they go to the
    dropped segment rather than lengthen a real one (the empty slots of
    the stores point at slot 0)."""
    return torch.where(gate, idx, torch.full_like(idx, n))


def _pair_key(a, b, n: int):
    """a·n + b for a pair of slots in [0, n]; n·n (dropped) where either is
    the sentinel n."""
    return torch.where((a < n) & (b < n), a * n + b, torch.full_like(a, n * n))


def _pp_pairs(pi, pj):
    """The (row, column) slot lists of a pose-pose edge's four Hessian
    blocks, in the order their rows are summed: ii, jj, ij, ji."""
    return ((pi, pi), (pj, pj), (pi, pj), (pj, pi))


def _pp_blocks(wpp, Ji, Jj):
    """The four weighted Hessian blocks of each pose-pose edge, stacked in
    the order of ``_pp_pairs``: (4E, 6, 6)."""
    return torch.cat([torch.einsum("e,eri,erj->eij", wpp, Ja, Jb)
                      for Ja, Jb in ((Ji, Ji), (Jj, Jj), (Ji, Jj), (Jj, Ji))])


def _pp_gradients(wpp, Ji, Jj, r6):
    """The gradient rows of each pose-pose edge at its two ends: (2E, 6),
    the i ends first."""
    return torch.cat([-torch.einsum("e,eri,er->ei", wpp, Ji, r6),
                      -torch.einsum("e,eri,er->ei", wpp, Jj, r6)])


def hessian_plan(diag, n: int, pi=None, pj=None) -> SegmentPlan:
    """The plan of a pose Hessian (n·n blocks of 6×6): one row per slot of
    ``diag`` on the diagonal, then, given edge ends ``pi`` / ``pj``, the four
    blocks of each pose-pose edge (``_pp_blocks``); a slot at the sentinel n
    is dropped."""
    keys = [_pair_key(diag, diag, n)]
    if pi is not None:
        keys += [_pair_key(a, b, n) for a, b in _pp_pairs(pi, pj)]
    return SegmentPlan(torch.cat(keys), n * n)


def coupling_plan(obs_kf, obs_lm, K: int, L: int) -> SegmentPlan:
    """The plan of the coupling G (K·L blocks of 6×3) over (kf, lm) of each
    observation; kf = K or lm = L is dropped."""
    obs_kf, obs_lm = obs_kf.long(), obs_lm.long()
    key = torch.where((obs_kf < K) & (obs_lm < L), obs_kf * L + obs_lm,
                      torch.full_like(obs_kf, K * L))
    return SegmentPlan(key, K * L)


def _gather_pad(x, idx):
    """x[idx] with idx ∈ [0, len(x)]; the sentinel index reads zeros."""
    return torch.cat([x, torch.zeros_like(x[:1])], dim=0)[idx]


def _assemble_obs(bcfg: BackendConfig, kf_pose, lm_pos, lm_valid,
                  g: GraphState, lm_gen, kf_gen, cam: CameraConfig = None):
    """Residuals, Jacobians, robust weights and weighted squared errors of
    every pose-landmark observation: (r, Jp, Jl, w, sq). The factor type
    follows ``bcfg.error_type``; with ``bcfg.use_obs_info`` the stored 3×3
    information matrices whiten the 3D residual and Jacobians (r' = Lᵀr
    with Info = L·Lᵀ)."""
    return _obs_terms(bcfg, g, kf_pose[g.obs_kf], lm_pos[g.obs_lm],
                      _obs_gate(g, lm_valid, lm_gen, kf_gen),
                      _whitening_chol(g) if _whitens(bcfg) else None, cam)


def _pp_gate(g: GraphState, kf_gen):
    """Live pose-pose edges: valid, both generations current."""
    gate = g.pp_valid
    if kf_gen is not None:
        gate = gate & (g.pp_gen_i == kf_gen[g.pp_i]) \
            & (g.pp_gen_j == kf_gen[g.pp_j])
    return gate


def _live_slots(g: GraphState, K: int, L: int, lm_valid, lm_gen, kf_gen):
    """The plans' indices of an unwindowed solve: (keyframe, landmark) of
    each live observation and (i, j) of each live pose-pose edge, the
    sentinel K or L elsewhere (``_live``)."""
    live = _obs_gate(g, lm_valid, lm_gen, kf_gen)
    pp_live = _pp_gate(g, kf_gen)
    return (_live(g.obs_kf.long(), live, K), _live(g.obs_lm.long(), live, L),
            _live(g.pp_i.long(), pp_live, K), _live(g.pp_j.long(), pp_live, K))


def _pp_terms(bcfg: BackendConfig, g: GraphState, kf_pose, kf_gen):
    """Pose-pose edges with stale-generation masking: (r6, Ji, Jj, wpp,
    sq_pp)."""
    pi = kf_pose[g.pp_i]
    pj = kf_pose[g.pp_j]
    r6 = factors.pp_residual(pi, pj, g.pp_rel)
    Ji, Jj = factors.pp_jacobians(pi, pj, g.pp_rel)
    wpp_info = g.pp_w * _pp_gate(g, kf_gen)
    sq_pp = wpp_info * torch.sum(r6 * r6, dim=-1)
    wpp = wpp_info * factors.robust_weight(sq_pp, bcfg.robust_kernel,
                                           bcfg.robust_delta)
    return r6, Ji, Jj, wpp, sq_pp


def _damped_ll_inverse(H_ll, lam: float):
    """(H_ll + λ(1 + tr/3)·I)⁻¹ per landmark, closed form."""
    tr_ll = (H_ll[..., 0, 0] + H_ll[..., 1, 1] + H_ll[..., 2, 2]) / 3.0
    eye3 = torch.eye(3, dtype=H_ll.dtype, device=H_ll.device)
    return inv3x3(H_ll + (lam * (1.0 + tr_ll))[:, None, None] * eye3)


def _gauge_fixed(S, dead, lam: float):
    """The reduced system with identity rows for the ``dead`` (n,) slots,
    symmetrised and damped by λ·max|diag|."""
    frozen6 = dead.repeat_interleave(6)
    S = torch.where(frozen6[:, None] | frozen6[None, :], torch.zeros_like(S),
                    S)
    S = S + torch.diag(frozen6.to(S.dtype))
    S = 0.5 * (S + S.T)
    max_diag = torch.clamp(torch.max(torch.abs(torch.diagonal(S))), min=1.0)
    return S + (lam * max_diag) * torch.eye(S.shape[0], dtype=S.dtype,
                                            device=S.device)


def _solve_reduced(S, b_red, dead, lam: float):
    """Gauge-fix (identity rows for ``dead`` (n,) slots), symmetrise, damp
    by λ·max|diag| and solve S·dc = b by Cholesky. A failed factorisation
    gives NaN (as ``lax.linalg.cholesky``), and a non-finite or ≥ 1e3 step
    is replaced by zero: never an exception, never a host sync."""
    S = _gauge_fixed(S, dead, lam)
    b_red = torch.where(dead.repeat_interleave(6), torch.zeros_like(b_red),
                        b_red)
    Lc, info = torch.linalg.cholesky_ex(S)
    Lc = torch.where(info != 0, torch.full_like(Lc, math.nan), Lc)
    # L·Lᵀ·dc = b as two triangular solves: on the card cholesky_solve's
    # cuSOLVER route cannot sit in a conditional graph node's body (the
    # graph fails to instantiate), cuBLAS's triangular solve can
    y = torch.linalg.solve_triangular(Lc, b_red[:, None], upper=False)
    dc = torch.linalg.solve_triangular(Lc.T, y, upper=True)[:, 0]
    dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
    return torch.where(torch.all(torch.abs(dc) < 1e3), dc,
                       torch.zeros_like(dc))


def _apply_step(kf_pose, lm_pos, dc_mat, dl, frozen, lm_live):
    """Retract the free poses by dc, move the live landmarks whose step is
    finite and < 1e3."""
    dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))
    new_pose = torch.where(frozen[:, None], kf_pose,
                           se3.retract(kf_pose, dc_mat))
    moved = lm_live & (torch.amax(torch.abs(dl), dim=-1) < 1e3)
    return new_pose, torch.where(moved[:, None], lm_pos + dl, lm_pos)


def gauss_newton(bcfg: BackendConfig, kf_pose, kf_valid, lm_pos, lm_valid,
                 g: GraphState, fixed_kf, lm_gen=None, kf_gen=None,
                 cam: CameraConfig = None) -> BAResult:
    """``dense_schur``: ``bcfg.gn_iterations`` Gauss-Newton steps over the
    full K keyframes and L landmarks with a dense (K, L, 6, 3) coupling
    buffer — 1.2 MB at the tiny config, 151 MB at fr1 (K = 256, L = 8192).
    The 2-D scatters are segment sums on a flattened K·L (K·K) axis."""
    check_backend_config(bcfg)
    K = kf_pose.shape[0]
    L = lm_pos.shape[0]
    lam = bcfg.damping
    lm = g.obs_lm.long()
    frozen = fixed_kf | ~kf_valid
    kf_l, lm_l, pi_l, pj_l = _live_slots(g, K, L, lm_valid, lm_gen, kf_gen)
    cc_plan = hessian_plan(kf_l, K, pi_l, pj_l)
    cl_plan = coupling_plan(kf_l, lm, K, L)
    lm_plan = SegmentPlan(lm_l, L)
    c_plan = SegmentPlan(torch.cat([kf_l, pi_l, pj_l]), K)
    chi2s = []
    for _ in range(bcfg.gn_iterations):
        r, Jp, Jl, w, sq = _assemble_obs(bcfg, kf_pose, lm_pos, lm_valid, g,
                                         lm_gen, kf_gen, cam)
        r6, Ji, Jj, wpp, sq_pp = _pp_terms(bcfg, g, kf_pose, kf_gen)
        chi2 = torch.sum(sq) + torch.sum(sq_pp)
        H_cc = cc_plan.sum(torch.cat([
            torch.einsum("m,mri,mrj->mij", w, Jp, Jp),
            _pp_blocks(wpp, Ji, Jj)]))
        H_ll = lm_plan.sum(torch.einsum("m,mri,mrj->mij", w, Jl, Jl))
        H_cl = cl_plan.sum(torch.einsum("m,mri,mrj->mij", w, Jp, Jl))
        b_c = c_plan.sum(torch.cat([-torch.einsum("m,mri,mr->mi", w, Jp, r),
                                    _pp_gradients(wpp, Ji, Jj, r6)]))
        b_l = lm_plan.sum(-torch.einsum("m,mri,mr->mi", w, Jl, r))

        # --- Schur complement over landmarks ----------------------------
        H_ll_inv = _damped_ll_inverse(H_ll, lam)
        Hcl = H_cl.view(K, L, 6, 3).permute(0, 2, 1, 3).reshape(K * 6, L * 3)
        HclWinv = torch.einsum("kla,lab->klb", Hcl.view(K * 6, L, 3),
                               H_ll_inv)
        S = (H_cc.view(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
             - HclWinv.reshape(K * 6, L * 3) @ Hcl.T)
        Winv_bl = torch.einsum("lab,lb->la", H_ll_inv, b_l)
        b_red = b_c.reshape(K * 6) - Hcl @ Winv_bl.reshape(L * 3)
        dc = _solve_reduced(S, b_red, frozen, lam)

        # δl = H_ll⁻¹ (b_l − H_lc δc)
        Hlc_dc = torch.einsum("kla,k->la", Hcl.view(K * 6, L, 3), dc)
        dl = torch.einsum("lab,lb->la", H_ll_inv, b_l - Hlc_dc)
        kf_pose, lm_pos = _apply_step(kf_pose, lm_pos, dc.reshape(K, 6), dl,
                                      frozen, lm_valid)
        chi2s.append(chi2)
    sq_final = _final_sq_errors(bcfg, kf_pose, lm_pos, lm_valid, g, lm_gen,
                                kf_gen, cam)
    return BAResult(kf_pose, lm_pos, torch.stack(chi2s), sq_final)


def gauss_newton_pcg(bcfg: BackendConfig, kf_pose, kf_valid, lm_pos,
                     lm_valid, g: GraphState, fixed_kf, lm_gen=None,
                     kf_gen=None, cam: CameraConfig = None) -> BAResult:
    """``pcg``: the reduced camera system S·x = b solved matrix-free by
    exactly ``pcg_iterations`` block-Jacobi preconditioned CG steps
    (guards |denom| > 1e-20, no early exit), applying
    S·v = H_cc·v − H_cl·(H_ll⁻¹·(H_lc·v)) through per-observation 6×3
    products and segment sums."""
    check_backend_config(bcfg)
    dev = kf_pose.device
    K = kf_pose.shape[0]
    L = lm_pos.shape[0]
    lam = bcfg.damping
    f32 = torch.float32
    kf = g.obs_kf.long()
    lm = g.obs_lm.long()
    pi = g.pp_i.long()
    pj = g.pp_j.long()
    frozen = fixed_kf | ~kf_valid
    eye6 = torch.eye(6, dtype=f32, device=dev)
    kf_l, lm_l, pi_l, pj_l = _live_slots(g, K, L, lm_valid, lm_gen, kf_gen)
    kf_plan = SegmentPlan(kf_l, K)
    lm_plan = SegmentPlan(lm_l, L)
    c_plan = SegmentPlan(torch.cat([kf_l, pi_l, pj_l]), K)
    # S·v's pose-pose part: H_cc_diag·v, then the off-diagonal blocks of
    # the edges at their i ends and at their j ends
    u_plan = SegmentPlan(torch.cat([torch.arange(K, device=dev), pi_l,
                                    pj_l]), K)
    chi2s = []
    for _ in range(bcfg.gn_iterations):
        r, Jp, Jl, w, sq = _assemble_obs(bcfg, kf_pose, lm_pos, lm_valid, g,
                                         lm_gen, kf_gen, cam)
        r6, Ji, Jj, wpp, sq_pp = _pp_terms(bcfg, g, kf_pose, kf_gen)
        chi2 = torch.sum(sq) + torch.sum(sq_pp)
        B = torch.einsum("m,mri,mrj->mij", w, Jp, Jl)            # (M, 6, 3)
        H_cc_diag = c_plan.sum(torch.cat([
            torch.einsum("m,mri,mrj->mij", w, Jp, Jp),
            torch.einsum("e,eri,erj->eij", wpp, Ji, Ji),
            torch.einsum("e,eri,erj->eij", wpp, Jj, Jj)]))
        H_ll = lm_plan.sum(torch.einsum("m,mri,mrj->mij", w, Jl, Jl))
        b_c = c_plan.sum(torch.cat([-torch.einsum("m,mri,mr->mi", w, Jp, r),
                                    _pp_gradients(wpp, Ji, Jj, r6)]))
        b_l = lm_plan.sum(-torch.einsum("m,mri,mr->mi", w, Jl, r))
        Hij = torch.einsum("e,eri,erj->eij", wpp, Ji, Jj)

        H_ll_inv = _damped_ll_inverse(H_ll, lam)
        diag_scale = torch.clamp(torch.max(torch.abs(
            torch.einsum("kii->k", H_cc_diag))), min=1.0) / 6.0

        def S_matvec(v):
            v = torch.where(frozen[:, None], torch.zeros_like(v), v)
            u = u_plan.sum(torch.cat([
                torch.einsum("kij,kj->ki", H_cc_diag, v),
                torch.einsum("eij,ej->ei", Hij, v[pj]),
                torch.einsum("eji,ej->ei", Hij, v[pi])]))
            t1 = lm_plan.sum(torch.einsum("mij,mi->mj", B, v[kf]))
            t2 = torch.einsum("lab,lb->la", H_ll_inv, t1)
            c = torch.einsum("mij,mj->mi", B, t2[lm])
            u = u - kf_plan.sum(c) + (lam * diag_scale) * v
            return torch.where(frozen[:, None], v, u)

        M_inv = torch.linalg.inv_ex(
            H_cc_diag + (lam * diag_scale + 1e-6) * eye6)[0]

        def M_solve(v):
            return torch.where(frozen[:, None], v,
                               torch.einsum("kij,kj->ki", M_inv, v))

        b_vec = torch.where(frozen[:, None], torch.zeros_like(b_c), b_c)
        x = torch.zeros_like(b_vec)
        rr = b_vec
        p = M_solve(b_vec)
        rz = torch.sum(b_vec * p)
        zero = torch.zeros_like(rz)
        for _ in range(bcfg.pcg_iterations):
            Sp = S_matvec(p)
            denom = torch.sum(p * Sp)
            alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, zero)
            x = x + alpha * p
            rr = rr - alpha * Sp
            z = M_solve(rr)
            rz_new = torch.sum(rr * z)
            beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, zero)
            p = z + beta * p
            rz = rz_new
        dc = x.reshape(K * 6)
        dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
        dc = torch.where(torch.all(torch.abs(dc) < 1e3), dc,
                         torch.zeros_like(dc))
        dc_mat = dc.reshape(K, 6)

        Hlc_dc = lm_plan.sum(torch.einsum("mij,mi->mj", B, dc_mat[kf]))
        dl = torch.einsum("lab,lb->la", H_ll_inv, b_l - Hlc_dc)
        kf_pose, lm_pos = _apply_step(kf_pose, lm_pos, dc_mat, dl, frozen,
                                      lm_valid)
        chi2s.append(chi2)
    sq_final = _final_sq_errors(bcfg, kf_pose, lm_pos, lm_valid, g, lm_gen,
                                kf_gen, cam)
    return BAResult(kf_pose, lm_pos, torch.stack(chi2s), sq_final)


def schur_subtrahend_mm(obs_kf, obs_lm, F, K: int, L: int,
                        plan: SegmentPlan = None):
    """S_sub = G·Gᵀ (6K × 6K) with G[6k+i, 3l+a] = Σ_{m: kf=k, lm=l}
    F[m, i, a], the whitened coupling. Observations with kf = K or lm = L
    are dropped. F and G are rounded to bfloat16 as the reference rounds
    its one-hot products; G·Gᵀ is a float32 matmul of the upcast values
    (exact products, float32 sums). ``plan``: ``coupling_plan(obs_kf,
    obs_lm, K, L)``, built here when not given."""
    if plan is None:
        plan = coupling_plan(obs_kf, obs_lm, K, L)
    Fb = F.to(torch.bfloat16).float()                         # (M, 6, 3)
    G = plan.sum(Fb).view(K, L, 6, 3).permute(0, 2, 1, 3)
    G = G.reshape(K * 6, L * 3).to(torch.bfloat16).float()
    return G @ G.T


def gauss_newton_mm(bcfg: BackendConfig, kf_pose, kf_valid, lm_pos, lm_valid,
                    g: GraphState, fixed_kf, lm_gen=None, kf_gen=None,
                    cam: CameraConfig = None) -> BAResult:
    """``bcfg.gn_iterations`` Gauss-Newton steps on poses and landmarks,
    stopping early (chi² reported unchanged) once an iteration fails to
    improve chi² by ``chi2_ratio_termination``: each iteration is a
    ``control.cond`` on the device flag ``~done`` (masked by default, an IF
    node in a captured frame, a host read under
    ``control.branching("host")``). ``fixed_kf`` (K,) bool
    freezes the gauge/window; generations mask stale edges."""
    check_backend_config(bcfg)
    dev = kf_pose.device
    K = kf_pose.shape[0]
    L = lm_pos.shape[0]
    lam = bcfg.damping
    f32 = torch.float32

    # --- active-window compaction --------------------------------------
    windowed = 0 < bcfg.ba_window < K
    KC = bcfg.ba_window if windowed else K
    frozen_full = fixed_kf | ~kf_valid
    if windowed:
        sel = nonzero_fixed(~frozen_full, KC, K)                 # (KC,)
        comp_of = torch.full((K + 1,), KC, dtype=torch.int64, device=dev)
        comp_of[sel] = torch.arange(KC, device=dev)
        comp_of = comp_of[:K]
        ck_obs = comp_of[g.obs_kf]
        cpp_i = comp_of[g.pp_i]
        cpp_j = comp_of[g.pp_j]
        dead_c = sel >= K
    else:
        sel = torch.arange(K, device=dev)
        ck_obs = g.obs_kf.long()
        cpp_i = g.pp_i.long()
        cpp_j = g.pp_j.long()
        dead_c = frozen_full

    # --- landmark-block compaction -------------------------------------
    lm_blocked = 0 < bcfg.ba_lm_block < L
    LC = bcfg.ba_lm_block if lm_blocked else L
    if lm_blocked:
        sel_lm = nonzero_fixed(lm_valid, LC, L)                  # (LC,)
        comp_lm = torch.full((L + 1,), LC, dtype=torch.int64, device=dev)
        comp_lm[sel_lm] = torch.arange(LC, device=dev)
        cl_obs = comp_lm[:L][g.obs_lm]
        lm_dead_c = sel_lm >= L
    else:
        sel_lm = torch.arange(L, device=dev)
        cl_obs = torch.where(lm_valid[g.obs_lm], g.obs_lm.long(),
                             torch.full_like(g.obs_lm, L, dtype=torch.int64))
        lm_dead_c = ~lm_valid
    # a dropped landmark (sentinel LC) contributes nothing at all
    gate = _obs_gate(g, lm_valid, lm_gen, kf_gen) & (cl_obs < LC)
    ck_obs = torch.where(cl_obs < LC, ck_obs, torch.full_like(ck_obs, KC))
    Lw = _whitening_chol(g) if _whitens(bcfg) else None
    ck_l = _live(ck_obs, gate, KC)
    pp_live = _pp_gate(g, kf_gen)
    cpp_il, cpp_jl = _live(cpp_i, pp_live, KC), _live(cpp_j, pp_live, KC)
    kf_plan = SegmentPlan(ck_l, KC)
    lm_plan = SegmentPlan(_live(cl_obs, gate, LC), LC)
    cc_plan = hessian_plan(torch.arange(KC, device=dev), KC, cpp_il, cpp_jl)
    pp_plan = SegmentPlan(torch.cat([cpp_il, cpp_jl]), KC)
    g_plan = coupling_plan(ck_l, cl_obs, KC, LC)

    def do_iteration(kf_pose, lm_pos_c):
        kf_p = kf_pose[g.obs_kf]
        lm_p = _gather_pad(lm_pos_c, cl_obs)
        r, Jp, Jl, w, sq = _obs_terms(bcfg, g, kf_p, lm_p, gate, Lw, cam)
        chi2 = torch.sum(sq)

        C = torch.einsum("m,mri,mra->mia", w, Jp, Jl)           # (M, 6, 3)
        JpT_Jp = torch.einsum("m,mri,mrj->mij", w, Jp, Jp)      # (M, 6, 6)
        JlT_Jl = torch.einsum("m,mri,mrj->mij", w, Jl, Jl)      # (M, 3, 3)
        bp = -torch.einsum("m,mri,mr->mi", w, Jp, r)            # (M, 6)
        bl = -torch.einsum("m,mri,mr->mi", w, Jl, r)            # (M, 3)

        H_cc_diag = kf_plan.sum(JpT_Jp)
        b_c = kf_plan.sum(bp)
        H_ll = lm_plan.sum(JlT_Jl)
        b_l = lm_plan.sum(bl)

        # pose-pose edges: a frozen endpoint lands in the sentinel block,
        # so the edge acts as a prior on the free endpoint
        r6, Ji, Jj, wpp, sq_pp = _pp_terms(bcfg, g, kf_pose, kf_gen)
        chi2 = chi2 + torch.sum(sq_pp)
        H_cc = cc_plan.sum(torch.cat([H_cc_diag, _pp_blocks(wpp, Ji, Jj)]))
        H_cc = H_cc.view(KC, KC, 6, 6)
        b_c = b_c + pp_plan.sum(_pp_gradients(wpp, Ji, Jj, r6))

        # --- landmark elimination ---------------------------------------
        H_ll_inv = _damped_ll_inverse(H_ll, lam)
        Linv = chol3x3(H_ll_inv)
        F = torch.einsum("mia,mab->mib", C, _gather_pad(Linv, cl_obs))
        S = H_cc.permute(0, 2, 1, 3).reshape(KC * 6, KC * 6) \
            - schur_subtrahend_mm(ck_obs, cl_obs, F, KC, LC, g_plan)

        # exact f32 gradient of the reduced system
        t = torch.einsum("lab,lb->la", H_ll_inv, b_l)
        c_m = torch.einsum("mia,ma->mi", C, _gather_pad(t, cl_obs))
        b_red = (b_c - kf_plan.sum(c_m)).reshape(KC * 6)

        # --- gauge fixing + solve ----------------------------------------
        dc_mat = _solve_reduced(S, b_red, dead_c, lam).reshape(KC, 6)
        dc_full = set_rows(torch.zeros((K, 6), dtype=f32, device=dev), sel,
                           dc_mat) if windowed else dc_mat

        # --- landmark back-substitution: δl = H_ll⁻¹ (b_l − H_lc δc) ------
        u_m = torch.einsum("mia,mi->ma", C, _gather_pad(dc_mat, ck_obs))
        dl = torch.einsum("lab,lb->la", H_ll_inv,
                          b_l - lm_plan.sum(u_m))
        new_pose, new_lm_c = _apply_step(kf_pose, lm_pos_c, dc_full, dl,
                                         frozen_full, ~lm_dead_c)
        return new_pose, new_lm_c, chi2

    # the carry of the JAX package's scan, on the device: the chi²-ratio
    # stop is the lax.cond of putslam_tpu/backend/optimize.py:680, one
    # control.cond per iteration; a stopped run repeats its last chi²
    kf_pose = kf_pose.clone()
    lm_pos_c = lm_pos[torch.clamp(sel_lm, max=L - 1)]
    prev_chi2 = torch.full((), math.inf, dtype=f32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    chi2s = []

    def iteration():
        new_pose, new_lm_c, chi2 = do_iteration(kf_pose, lm_pos_c)
        return (new_pose, new_lm_c, chi2,
                chi2 >= bcfg.chi2_ratio_termination * prev_chi2)

    for _ in range(bcfg.gn_iterations):
        control.cond(~done, iteration, (kf_pose, lm_pos_c, prev_chi2, done))
        chi2s.append(prev_chi2.clone())
    lm_out = set_rows(lm_pos, torch.where(lm_dead_c, torch.full_like(
        sel_lm, L), sel_lm), lm_pos_c)
    sq_final = _final_sq_errors(bcfg, kf_pose, lm_out, lm_valid, g, lm_gen,
                                kf_gen, cam)
    return BAResult(kf_pose, lm_out, torch.stack(chi2s), sq_final)


def optimize_graph(bcfg: BackendConfig, kf_pose, kf_valid, lm_pos, lm_valid,
                   g: GraphState, fixed_kf, lm_gen=None, kf_gen=None,
                   cam: CameraConfig = None) -> BAResult:
    """Solver front door: dispatches on ``bcfg.solver`` ("dense_schur",
    "dense_schur_mm", "pcg"); raises for any other solver."""
    check_backend_config(bcfg)
    fn = {"dense_schur": gauss_newton, "dense_schur_mm": gauss_newton_mm,
          "pcg": gauss_newton_pcg}[bcfg.solver]
    return fn(bcfg, kf_pose, kf_valid, lm_pos, lm_valid, g, fixed_kf, lm_gen,
              kf_gen, cam=cam)


def prune_mask_from_errors(bcfg: BackendConfig, sq_err, threshold: float):
    """Edges whose weighted squared error exceeds ``threshold`` (the chi²
    edge pruning)."""
    return sq_err > threshold


def pose_covariances(bcfg: BackendConfig, kf_pose, kf_valid, lm_pos, lm_valid,
                     g: GraphState, fixed_kf, lm_gen=None, kf_gen=None,
                     cam: CameraConfig = None):
    """Marginal 6×6 pose covariances: the diagonal blocks of S⁻¹, S the
    reduced camera system at the current estimate (pose-pose edges
    included, the Schur subtrahend from the bfloat16-rounded coupling of
    ``schur_subtrahend_mm``). Returns (K, 6, 6); fixed and invalid keyframes
    get zero blocks. Where S is not positive definite every free block is
    NaN (what the reference's silent Cholesky gives), never an exception."""
    check_backend_config(bcfg)
    dev = kf_pose.device
    K = kf_pose.shape[0]
    L = lm_pos.shape[0]
    lam = bcfg.damping
    lm = g.obs_lm.long()
    r, Jp, Jl, w, _ = _assemble_obs(bcfg, kf_pose, lm_pos, lm_valid, g,
                                    lm_gen, kf_gen, cam)
    C = torch.einsum("m,mri,mra->mia", w, Jp, Jl)
    r6, Ji, Jj, wpp, _ = _pp_terms(bcfg, g, kf_pose, kf_gen)
    kf_l, lm_l, pi_l, pj_l = _live_slots(g, K, L, lm_valid, lm_gen, kf_gen)
    H_cc = hessian_plan(kf_l, K, pi_l, pj_l).sum(torch.cat([
        torch.einsum("m,mri,mrj->mij", w, Jp, Jp), _pp_blocks(wpp, Ji, Jj)]))
    H_ll = SegmentPlan(lm_l, L).sum(torch.einsum("m,mri,mrj->mij", w, Jl, Jl))
    Linv = chol3x3(_damped_ll_inverse(H_ll, lam))
    F = torch.einsum("mia,mab->mib", C, Linv[lm])
    S = (H_cc.view(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
         - schur_subtrahend_mm(kf_l, lm, F, K, L))
    frozen = fixed_kf | ~kf_valid
    S = _gauge_fixed(S, frozen, lam)
    Lc, info = torch.linalg.cholesky_ex(S)
    Lc = torch.where(info != 0, torch.full_like(Lc, math.nan), Lc)
    S_inv = torch.cholesky_solve(
        torch.eye(K * 6, dtype=S.dtype, device=dev), Lc)
    diag = torch.einsum("kikj->kij", S_inv.view(K, 6, K, 6))
    return torch.where(frozen[:, None, None], torch.zeros_like(diag), diag)
