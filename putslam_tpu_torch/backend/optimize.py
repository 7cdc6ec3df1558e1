"""Bundle adjustment: Gauss-Newton with a dense Schur complement.

Port of ``putslam_tpu/backend/optimize.py::gauss_newton_mm`` (the
``dense_schur_mm`` solver, the fr1 default) with its helpers. The behaviour
is the JAX package's; the formulation is the GPU's: the one-hot matmuls
that fed the TPU's MXU are gathers (``index_select``) and segment sums
(``index_add_``) here.

Both compactions are kept: the active window (the ≤ ``ba_window`` free
keyframes get compact slots, so the reduced camera system is (6·W)²) and
the landmark block (the first ≤ ``ba_lm_block`` valid landmarks). Index
``KC`` / ``LC`` is the sentinel slot of a dropped observation.

Precision contract (``gauss_newton_mm``'s docstring): the whitened coupling
G (6·KC × 3·LC) is built in float32, rounded to bfloat16, upcast and
squared with a float32 matmul; the gradient stays exact float32. On CUDA
``index_add_`` sums with atomics, in an order that changes between runs.
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
from putslam_tpu_torch.utils.indexing import nonzero_fixed, set_rows


class BAResult(NamedTuple):
    kf_pose: torch.Tensor     # (K, 7) optimised poses
    lm_pos: torch.Tensor      # (L, 3) optimised landmarks
    chi2: torch.Tensor        # (iters,) weighted squared error per iteration
    obs_sq_err: torch.Tensor  # (M,) final per-observation weighted sq. error


def check_backend_config(bcfg: BackendConfig) -> None:
    """Raise NotImplementedError for the backend options not ported."""
    if bcfg.solver != "dense_schur_mm":
        raise NotImplementedError(
            f"backend.solver={bcfg.solver!r} is not ported yet "
            "(only 'dense_schur_mm')")
    if bcfg.error_type != 0:
        raise NotImplementedError(
            f"backend.error_type={bcfg.error_type} is not ported yet")
    if bcfg.use_obs_info:
        raise NotImplementedError("backend.use_obs_info is not ported yet")


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
    r = factors.obs_residual(kf_pose[g.obs_kf], lm_pos[g.obs_lm], g.obs_xyz)
    gate = _obs_gate(g, lm_valid, lm_gen, kf_gen)
    return g.obs_w * gate * torch.sum(r * r, dim=-1)


def _segment_sum(x, idx, n: int):
    """(M, ...) rows summed into n groups by idx ∈ [0, n] (n = dropped)."""
    out = torch.zeros((n + 1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    out.index_add_(0, idx, x)
    return out[:n]


def _gather_pad(x, idx):
    """x[idx] with idx ∈ [0, len(x)]; the sentinel index reads zeros."""
    return torch.cat([x, torch.zeros_like(x[:1])], dim=0)[idx]


def schur_subtrahend_mm(obs_kf, obs_lm, F, K: int, L: int):
    """S_sub = G·Gᵀ (6K × 6K) with G[6k+i, 3l+a] = Σ_{m: kf=k, lm=l}
    F[m, i, a], the whitened coupling. Observations with kf = K or lm = L
    are dropped. F and G are rounded to bfloat16 as the reference rounds
    its one-hot products; G·Gᵀ is a float32 matmul of the upcast values
    (exact products, float32 sums)."""
    Fb = F.to(torch.bfloat16).float()                         # (M, 6, 3)
    G = torch.zeros(((K + 1) * (L + 1), 6, 3), dtype=torch.float32,
                    device=F.device)
    G.index_add_(0, obs_kf * (L + 1) + obs_lm, Fb)
    G = G.view(K + 1, L + 1, 6, 3)[:K, :L].permute(0, 2, 1, 3)
    G = G.reshape(K * 6, L * 3).to(torch.bfloat16).float()
    return G @ G.T


def gauss_newton_mm(bcfg: BackendConfig, kf_pose, kf_valid, lm_pos, lm_valid,
                    g: GraphState, fixed_kf, lm_gen=None, kf_gen=None,
                    cam: CameraConfig = None) -> BAResult:
    """``bcfg.gn_iterations`` Gauss-Newton steps on poses and landmarks,
    stopping early (chi² reported unchanged) once an iteration fails to
    improve chi² by ``chi2_ratio_termination``. ``fixed_kf`` (K,) bool
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

    pp_gate = g.pp_valid
    if kf_gen is not None:
        pp_gate = pp_gate & (g.pp_gen_i == kf_gen[g.pp_i]) \
            & (g.pp_gen_j == kf_gen[g.pp_j])
    eye3 = torch.eye(3, dtype=f32, device=dev)

    def do_iteration(kf_pose, lm_pos_c):
        kf_p = kf_pose[g.obs_kf]
        lm_p = _gather_pad(lm_pos_c, cl_obs)
        r, Jp, Jl = factors.assemble_obs_terms(kf_p, lm_p, g.obs_xyz,
                                               bcfg.error_type)
        w_info = g.obs_w * gate
        sq = w_info * torch.sum(r * r, dim=-1)
        w = w_info * factors.robust_weight(sq, bcfg.robust_kernel,
                                           bcfg.robust_delta)
        chi2 = torch.sum(sq)

        C = torch.einsum("m,mri,mra->mia", w, Jp, Jl)           # (M, 6, 3)
        JpT_Jp = torch.einsum("m,mri,mrj->mij", w, Jp, Jp)      # (M, 6, 6)
        JlT_Jl = torch.einsum("m,mri,mrj->mij", w, Jl, Jl)      # (M, 3, 3)
        bp = -torch.einsum("m,mri,mr->mi", w, Jp, r)            # (M, 6)
        bl = -torch.einsum("m,mri,mr->mi", w, Jl, r)            # (M, 3)

        H_cc_diag = _segment_sum(JpT_Jp, ck_obs, KC)
        b_c = _segment_sum(bp, ck_obs, KC)
        H_ll = _segment_sum(JlT_Jl, cl_obs, LC)
        b_l = _segment_sum(bl, cl_obs, LC)

        # pose-pose edges: a frozen endpoint lands in the sentinel block,
        # so the edge acts as a prior on the free endpoint
        pi = kf_pose[g.pp_i]
        pj = kf_pose[g.pp_j]
        r6 = factors.pp_residual(pi, pj, g.pp_rel)
        Ji, Jj = factors.pp_jacobians(pi, pj, g.pp_rel)
        wpp_info = g.pp_w * pp_gate
        sq_pp = wpp_info * torch.sum(r6 * r6, dim=-1)
        wpp = wpp_info * factors.robust_weight(sq_pp, bcfg.robust_kernel,
                                               bcfg.robust_delta)
        chi2 = chi2 + torch.sum(sq_pp)
        H_cc = torch.zeros((KC + 1, KC + 1, 6, 6), dtype=f32, device=dev)
        ar = torch.arange(KC, device=dev)
        H_cc[ar, ar] = H_cc_diag
        for a, b, Ja, Jb in ((cpp_i, cpp_i, Ji, Ji), (cpp_j, cpp_j, Jj, Jj),
                             (cpp_i, cpp_j, Ji, Jj), (cpp_j, cpp_i, Jj, Ji)):
            H_cc.index_put_((a, b), torch.einsum("e,eri,erj->eij", wpp, Ja, Jb),
                            accumulate=True)
        H_cc = H_cc[:KC, :KC]
        b_cp = torch.zeros((KC + 1, 6), dtype=f32, device=dev)
        b_cp.index_add_(0, cpp_i, -torch.einsum("e,eri,er->ei", wpp, Ji, r6))
        b_cp.index_add_(0, cpp_j, -torch.einsum("e,eri,er->ei", wpp, Jj, r6))
        b_c = b_c + b_cp[:KC]

        # --- landmark elimination ---------------------------------------
        tr_ll = (H_ll[..., 0, 0] + H_ll[..., 1, 1] + H_ll[..., 2, 2]) / 3.0
        H_ll_inv = inv3x3(H_ll + (lam * (1.0 + tr_ll))[:, None, None] * eye3)
        Linv = chol3x3(H_ll_inv)
        F = torch.einsum("mia,mab->mib", C, _gather_pad(Linv, cl_obs))
        S = H_cc.permute(0, 2, 1, 3).reshape(KC * 6, KC * 6) \
            - schur_subtrahend_mm(ck_obs, cl_obs, F, KC, LC)

        # exact f32 gradient of the reduced system
        t = torch.einsum("lab,lb->la", H_ll_inv, b_l)
        c_m = torch.einsum("mia,ma->mi", C, _gather_pad(t, cl_obs))
        b_red = (b_c - _segment_sum(c_m, ck_obs, KC)).reshape(KC * 6)

        # --- gauge fixing + solve ----------------------------------------
        frozen6 = dead_c.repeat_interleave(6)
        S = torch.where(frozen6[:, None] | frozen6[None, :],
                        torch.zeros_like(S), S)
        S = S + torch.diag(frozen6.to(f32))
        S = 0.5 * (S + S.T)
        max_diag = torch.clamp(torch.max(torch.abs(torch.diagonal(S))), min=1.0)
        S = S + (lam * max_diag) * torch.eye(KC * 6, dtype=f32, device=dev)
        b_red = torch.where(frozen6, torch.zeros_like(b_red), b_red)
        # a failed factorisation yields NaN (as lax.linalg.cholesky), which
        # the guard below turns into a skipped update
        Lc, info = torch.linalg.cholesky_ex(S)
        Lc = torch.where(info != 0, torch.full_like(Lc, math.nan), Lc)
        dc = torch.cholesky_solve(b_red[:, None], Lc)[:, 0]
        dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
        dc = torch.where(torch.all(torch.abs(dc) < 1e3), dc,
                         torch.zeros_like(dc))
        dc_mat = dc.reshape(KC, 6)
        dc_full = set_rows(torch.zeros((K, 6), dtype=f32, device=dev), sel,
                           dc_mat) if windowed else dc_mat

        # --- landmark back-substitution: δl = H_ll⁻¹ (b_l − H_lc δc) ------
        u_m = torch.einsum("mia,mi->ma", C, _gather_pad(dc_mat, ck_obs))
        dl = torch.einsum("lab,lb->la", H_ll_inv,
                          b_l - _segment_sum(u_m, cl_obs, LC))
        dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))

        new_pose = se3.retract(kf_pose, dc_full)
        new_pose = torch.where(frozen_full[:, None], kf_pose, new_pose)
        moved = ~lm_dead_c & (torch.amax(torch.abs(dl), dim=-1) < 1e3)
        new_lm_c = torch.where(moved[:, None], lm_pos_c + dl, lm_pos_c)
        return new_pose, new_lm_c, chi2

    lm_pos_c = lm_pos[torch.clamp(sel_lm, max=L - 1)]
    prev_chi2 = torch.tensor(math.inf, dtype=f32, device=dev)
    done = False
    chi2s = []
    for _ in range(bcfg.gn_iterations):
        if not done:
            kf_pose, lm_pos_c, chi2 = do_iteration(kf_pose, lm_pos_c)
            # one host sync per iteration: the chi²-ratio termination
            done = bool(chi2 >= bcfg.chi2_ratio_termination * prev_chi2)
            prev_chi2 = chi2
        chi2s.append(prev_chi2)
    lm_out = set_rows(lm_pos, torch.where(lm_dead_c, torch.full_like(
        sel_lm, L), sel_lm), lm_pos_c)
    sq_final = _final_sq_errors(bcfg, kf_pose, lm_out, lm_valid, g, lm_gen,
                                kf_gen, cam)
    return BAResult(kf_pose, lm_out, torch.stack(chi2s), sq_final)


def optimize_graph(bcfg: BackendConfig, kf_pose, kf_valid, lm_pos, lm_valid,
                   g: GraphState, fixed_kf, lm_gen=None, kf_gen=None,
                   cam: CameraConfig = None) -> BAResult:
    """Solver front door; only ``dense_schur_mm`` is ported (it checks
    the configuration)."""
    return gauss_newton_mm(bcfg, kf_pose, kf_valid, lm_pos, lm_valid, g,
                           fixed_kf, lm_gen, kf_gen, cam=cam)
