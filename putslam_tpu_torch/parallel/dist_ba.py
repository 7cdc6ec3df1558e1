"""Landmark-sharded bundle adjustment over a rank mesh, the port's
counterpart of ``putslam_tpu/parallel/dist_ba.py``.

The landmark axis (L) is cut into ``mesh.size`` contiguous blocks of
Ls = L / size; rank d owns block d and every observation of a landmark in
it. Each rank assembles its observations' Hessian blocks, eliminates its
own landmarks and forms its share of the reduced camera system:

    S = H_cc − Σ_d  H_cl^(d) · blkdiag(H_ll^(d))⁻¹ · H_cl^(d)ᵀ

S (6K × 6K), the reduced gradient (6K) and chi² are packed into one buffer
and summed over the ranks by a single ``all_reduce`` per Gauss-Newton
iteration; every rank then solves the same system (replicated Cholesky)
and back-substitutes its own landmark block. At the end the blocks are
gathered by all-reducing a zero-padded full (L, 3) array.

The edge store is partitioned by owner as in the JAX package
(``:92-115``): a stable sort of the observations by owning rank, each rank
taking a slice of Ms = min(M, max(8, 2·M / size)) slots (2× slack). A rank
that owns more than Ms observations drops the rest from the call;
``overflow`` counts them, and ``partition_overflow`` computes the same count
on the host beforehand. The slice's lanes past the rank's count hold
duplicates of other ranks' edges (the clipped ``order[take]``); here they
point at the sentinel keyframe K and landmark Ls, so their (zero) terms land
in rows that are sliced off and never in a live row (ROADMAP 3a).
Pose-pose edges are assembled on rank 0 alone.

The per-rank work is ``rank_partial`` (assembly, elimination, the packed
partial) and ``rank_landmark_step`` (the back-substitution), plain
functions of the rank and its shard; ``dist_gauss_newton`` runs them for the
ranks of this process and reduces over the mesh. The Schur subtrahend is
``backend/optimize.py::schur_subtrahend_mm``: G rounded to bfloat16 and
squared in float32, as the reference rounds it (ROADMAP 3d, 3ac); the
reduced gradient is exact float32. Every floating-point segment sum of a
rank goes through an ``ops/segment.py::SegmentPlan`` (``shard_plans``,
built once per call, before the Gauss-Newton loop): the same bits on every
run, on the card as on the CPU. The summation order still differs from
the JAX package's psum, so results agree with it to a tolerance, not bit
for bit. ``owner_partition``'s per-rank counts are integer sums, exact in
any order, and stay an ``index_add_``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from putslam_tpu_torch.backend import optimize as opt_mod
from putslam_tpu_torch.backend.graph import GraphState
from putslam_tpu_torch.backend.optimize import (_damped_ll_inverse,
                                                _gather_pad, _obs_terms,
                                                _live, _pp_blocks,
                                                _pp_gradients,
                                                _pp_terms, _whitening_chol,
                                                _whitens, coupling_plan,
                                                hessian_plan,
                                                schur_subtrahend_mm)
from putslam_tpu_torch.config import BackendConfig, CameraConfig
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.geometry.uncertainty import chol3x3
from putslam_tpu_torch.ops import pp_edge
from putslam_tpu_torch.ops.segment import SegmentPlan
from putslam_tpu_torch.utils.device import as_numpy


def _slice_size(M: int, size: int) -> int:
    """Ms: the observation slots of one rank's slice (2× slack)."""
    return min(M, max(8, (2 * M) // size))


def partition_overflow(g: GraphState, ndev: int, L: int) -> int:
    """Observations the 2×-slack owner partition drops for this graph over
    ``ndev`` ranks (0 when balanced): the host pre-check of
    ``dist_gauss_newton``'s ``overflow``, the same formula
    (``putslam_tpu/parallel/dist_ba.py:46-60``). ``g``: the port's
    ``GraphState`` or any with array leaves."""
    Ls = L // ndev
    M = g.obs_kf.shape[0]
    Ms = _slice_size(M, ndev)
    owner = np.where(as_numpy(g.obs_valid), as_numpy(g.obs_lm) // Ls, ndev)
    counts = np.bincount(owner, minlength=ndev + 1)[:ndev]
    return int(np.maximum(counts - Ms, 0).sum())


def owner_partition(g: GraphState, size: int, Ls: int):
    """(idx (size, Ms) observation slots of each rank's slice, inb
    (size, Ms) lanes within the rank's count, overflow () int32): the stable
    argsort by owner and the 2×-slack cut, on the device, no host sync."""
    M = g.obs_capacity
    Ms = _slice_size(M, size)
    dev = g.obs_kf.device
    owner = torch.where(g.obs_valid, g.obs_lm.long() // Ls,
                        torch.full((M,), size, dtype=torch.int64, device=dev))
    order = torch.sort(owner, stable=True).indices
    counts = torch.zeros((size + 1,), dtype=torch.int64, device=dev)
    counts = counts.index_add_(0, owner, torch.ones_like(owner))[:size]
    overflow = torch.sum(torch.clamp(counts - Ms, min=0)).to(torch.int32)
    starts = torch.cumsum(counts, 0) - counts
    jj = torch.arange(Ms, device=dev)
    take = torch.clamp(starts[:, None] + jj[None, :], 0, M - 1)
    inb = jj[None, :] < counts[:, None]
    return order[take], inb, overflow


class Shard(NamedTuple):
    """One rank's slice of the edge store."""
    g: GraphState       # the graph with its obs_* fields cut to the slice
    kf: torch.Tensor    # (Ms,) int64 keyframe, K on lanes past the count
    lm: torch.Tensor    # (Ms,) int64 landmark within the block, Ls past it


def make_shard(g: GraphState, idx, inb, rank: int, K: int, Ls: int) -> Shard:
    """Rank ``rank``'s slice of ``g`` (``idx``, ``inb`` from
    ``owner_partition``)."""
    sel, ok = idx[rank], inb[rank]
    gs = g._replace(
        obs_kf=g.obs_kf[sel], obs_lm=g.obs_lm[sel], obs_xyz=g.obs_xyz[sel],
        obs_w=g.obs_w[sel], obs_gen=g.obs_gen[sel],
        obs_kfgen=g.obs_kfgen[sel], obs_seq=g.obs_seq[sel],
        obs_valid=ok & g.obs_valid[sel], obs_info=g.obs_info[sel])
    kf = torch.where(ok, gs.obs_kf.long(), torch.full_like(sel, K))
    lm = torch.where(ok, gs.obs_lm.long() - rank * Ls,
                     torch.full_like(sel, Ls))
    return Shard(gs, kf, lm)


class ShardPlans(NamedTuple):
    """The segment plans of one rank's sums (``ops/segment.py``)."""
    kf: SegmentPlan        # the shard's keyframes (K)
    lm: SegmentPlan        # its landmarks within the block (Ls)
    c: SegmentPlan         # the pose gradient: keyframes, then (rank 0)
    #                        the pose-pose edges' i and j ends (K)
    hessian: SegmentPlan   # H_cc: the diagonal, then (rank 0) the edges
    coupling: SegmentPlan  # G over (kf, lm)


def _shard_gate(shard: Shard, kf_gen, lm_valid_l, lm_gen_l):
    """Live observations of a shard: valid, landmark valid, generations
    current (lanes past the rank's count point at the sentinels)."""
    gs, kf, lm = shard
    return (gs.obs_valid & _gather_pad(lm_valid_l, lm)
            & (gs.obs_gen == _gather_pad(lm_gen_l, lm))
            & (gs.obs_kfgen == _gather_pad(kf_gen, kf)))


def shard_plans(shard: Shard, g: GraphState, rank: int, K: int, Ls: int,
                live, kf_gen) -> ShardPlans:
    """The plans of rank ``rank``'s sums over ``shard``, its observations
    gated by ``live`` (``_shard_gate``); the pose-pose edges of ``g`` are
    summed on rank 0 alone, gated by ``kf_gen``. A row whose gate is off
    adds zero and goes to the dropped segment
    (``backend/optimize.py::_live``)."""
    ar = torch.arange(K, device=shard.kf.device)
    kf, lm = _live(shard.kf, live, K), _live(shard.lm, live, Ls)
    if rank == 0:
        pp_live = pp_edge.gate(g, kf_gen)
        pi, pj = _live(g.pp_i.long(), pp_live, K), _live(g.pp_j.long(),
                                                        pp_live, K)
        c = SegmentPlan(torch.cat([kf, pi, pj]), K)
        hessian = hessian_plan(ar, K, pi, pj)
    else:
        c = SegmentPlan(kf, K)
        hessian = hessian_plan(ar, K)
    return ShardPlans(SegmentPlan(kf, K), SegmentPlan(lm, Ls), c, hessian,
                      coupling_plan(kf, shard.lm, K, Ls))


def rank_partial(bcfg: BackendConfig, cam: CameraConfig, rank: int,
                 kf_pose, kf_gen, lm_pos_l, lm_valid_l, lm_gen_l,
                 shard: Shard, g: GraphState, plans: ShardPlans = None):
    """The body of one rank for one Gauss-Newton iteration
    (``putslam_tpu/parallel/dist_ba.py:129-214``): this rank's observation
    factors (whitened with ``use_obs_info``, the reprojection factor with
    ``error_type`` 1), the pose-pose edges on rank 0 only, the elimination of
    its landmark block (``lm_*_l``, Ls rows) and its share of the reduced
    system. Returns (packed (36K² + 6K + 1,): S, b_red, chi² — the buffer
    that is summed over the ranks —, the cache ``rank_landmark_step``
    reads). The shard carries the cut of the edge store; ``plans``:
    ``shard_plans`` of it, built here when not given."""
    K = kf_pose.shape[0]
    Ls = lm_pos_l.shape[0]
    lam = bcfg.damping
    gs, kf, lm = shard
    gate = _shard_gate(shard, kf_gen, lm_valid_l, lm_gen_l)
    Lw = _whitening_chol(gs) if _whitens(bcfg) else None
    r, Jp, Jl, w, sq = _obs_terms(bcfg, gs, _gather_pad(kf_pose, kf),
                                  _gather_pad(lm_pos_l, lm), gate, Lw, cam)
    chi2 = torch.sum(sq)
    C = torch.einsum("m,mri,mra->mia", w, Jp, Jl)               # (Ms, 6, 3)
    if plans is None:
        plans = shard_plans(shard, g, rank, K, Ls, gate, kf_gen)
    H_ll = plans.lm.sum(torch.einsum("m,mri,mrj->mij", w, Jl, Jl))
    b_l = plans.lm.sum(-torch.einsum("m,mri,mr->mi", w, Jl, r))
    H_cc_diag = plans.kf.sum(torch.einsum("m,mri,mrj->mij", w, Jp, Jp))
    bp = -torch.einsum("m,mri,mr->mi", w, Jp, r)
    if rank == 0:                 # pose-pose edges, then summed to all
        r6, Ji, Jj, wpp, sq_pp = _pp_terms(bcfg, g, kf_pose, kf_gen)
        chi2 = chi2 + torch.sum(sq_pp)
        H_cc = plans.hessian.sum(torch.cat([H_cc_diag,
                                            _pp_blocks(wpp, Ji, Jj)]))
        b_c = plans.c.sum(torch.cat([bp, _pp_gradients(wpp, Ji, Jj, r6)]))
    else:
        H_cc = plans.hessian.sum(H_cc_diag)
        b_c = plans.c.sum(bp)

    # local elimination: the whitened coupling F through the bf16 G·Gᵀ
    H_ll_inv = _damped_ll_inverse(H_ll, lam)
    F = torch.einsum("mia,mab->mib", C, _gather_pad(chol3x3(H_ll_inv), lm))
    S = (H_cc.view(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
         - schur_subtrahend_mm(kf, lm, F, K, Ls, plans.coupling))
    # exact f32 gradient of the reduced system
    t = torch.einsum("lab,lb->la", H_ll_inv, b_l)
    c_m = torch.einsum("mia,ma->mi", C, _gather_pad(t, lm))
    b_red = (b_c - plans.kf.sum(c_m)).reshape(K * 6)
    packed = torch.cat([S.reshape(-1), b_red, chi2.reshape(1)])
    return packed, (C, H_ll_inv, b_l)


def rank_landmark_step(cache, shard: Shard, dc_mat, lm_pos_l, lm_valid_l,
                       lm_plan: SegmentPlan):
    """Back-substitution of one rank's landmark block
    (``putslam_tpu/parallel/dist_ba.py:233-242``): δl = H_ll⁻¹ (b_l − H_lc
    δc); a live landmark moves when its step is finite and < 1e3.
    ``lm_plan``: the shard's landmark plan (``ShardPlans.lm``)."""
    C, H_ll_inv, b_l = cache
    u_m = torch.einsum("mia,mi->ma", C, _gather_pad(dc_mat, shard.kf))
    dl = torch.einsum("lab,lb->la", H_ll_inv, b_l - lm_plan.sum(u_m))
    dl = torch.where(torch.isfinite(dl), dl, torch.zeros_like(dl))
    moved = lm_valid_l & (torch.amax(torch.abs(dl), dim=-1) < 1e3)
    return torch.where(moved[:, None], lm_pos_l + dl, lm_pos_l)


def unpack(total, K: int):
    """The summed buffer → (S (6K, 6K), b_red (6K,), chi² ())."""
    n = 6 * K
    return total[:n * n].view(n, n), total[n * n:n * n + n], total[-1]


def dist_gauss_newton(bcfg: BackendConfig, mesh, kf_pose, kf_valid, lm_pos,
                      lm_valid, g: GraphState, fixed_kf, lm_gen, kf_gen=None,
                      cam: CameraConfig = None):
    """Sharded Gauss-Newton (``putslam_tpu/parallel/dist_ba.py:63-268``):
    the math of ``backend.optimize.gauss_newton`` with the landmark axis
    split over ``mesh`` (a ``parallel.mesh.Mesh``), ``bcfg.gn_iterations``
    iterations, no chi² termination, no window (every keyframe of K is a
    row of the reduced system). Every rank passes the same full inputs.

    Returns (kf_pose (K, 7), lm_pos (L, 3) — the full array on every rank
    —, chi2 (iters,), overflow () int32: observations dropped by the
    2×-slack owner partition; non-zero means a skewed ownership weakened
    the solve and the caller must rebalance or re-solve on one rank).
    Raises ValueError unless ``L % mesh.size == 0``."""
    size = mesh.size
    K, L = kf_pose.shape[0], lm_pos.shape[0]
    if L % size:
        raise ValueError(f"landmark capacity {L} must divide the mesh size "
                         f"{size}")
    Ls = L // size
    dev = kf_pose.device
    if kf_gen is None:
        kf_gen = torch.zeros((K,), dtype=torch.int32, device=dev)
    frozen = fixed_kf | ~kf_valid
    idx, inb, overflow = owner_partition(g, size, Ls)
    blocks = {r: slice(r * Ls, (r + 1) * Ls) for r in mesh.ranks}
    shards = {r: make_shard(g, idx, inb, r, K, Ls) for r in mesh.ranks}
    plans = {r: shard_plans(shards[r], g, r, K, Ls, _shard_gate(
        shards[r], kf_gen, lm_valid[s], lm_gen[s]), kf_gen)
        for r, s in blocks.items()}
    lm_l = {r: lm_pos[s] for r, s in blocks.items()}
    chi2s = []
    for _ in range(bcfg.gn_iterations):
        total, caches = None, {}
        for r, s in blocks.items():
            packed, caches[r] = rank_partial(
                bcfg, cam, r, kf_pose, kf_gen, lm_l[r], lm_valid[s],
                lm_gen[s], shards[r], g, plans[r])
            total = packed if total is None else total + packed
        S, b_red, chi2 = unpack(mesh.all_reduce_(total), K)
        # the replicated solve (:219-231): frozen rows, symmetrise,
        # λ·max|diag|, Cholesky, the finite and |dc| < 1e3 guards
        dc = opt_mod._solve_reduced(S, b_red, frozen, bcfg.damping)
        dc_mat = dc.reshape(K, 6)
        for r, s in blocks.items():
            lm_l[r] = rank_landmark_step(caches[r], shards[r], dc_mat,
                                         lm_l[r], lm_valid[s], plans[r].lm)
        kf_pose = torch.where(frozen[:, None], kf_pose,
                              se3.retract(kf_pose, dc_mat))
        chi2s.append(chi2)
    lm_out = torch.zeros_like(lm_pos)
    for r, s in blocks.items():
        lm_out[s] = lm_l[r]
    lm_out = mesh.all_reduce_(lm_out)
    chi2 = torch.stack(chi2s) if chi2s else torch.zeros((0,), device=dev)
    return kf_pose, lm_out, chi2, overflow
