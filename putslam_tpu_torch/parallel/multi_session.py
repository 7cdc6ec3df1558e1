"""Several SLAM sessions merged into one problem and optimised jointly,
the port's counterpart of ``putslam_tpu/parallel/multi_session.py``.

Sessions are run independently (``parallel/mesh.py`` runs them side by
side); their final states are then stacked into one problem:

* keyframes, landmarks and edges concatenated with per-session index
  offsets (``merge_sessions``);
* cross-session loop closures found by scoring every keyframe signature of
  session a against every one of session b (one matmul per pair a < b),
  keeping the best ``top_per_pair`` candidates of each pair and verifying
  them geometrically (``find_cross_session_closures``);
* the joint graph optimised by the landmark-sharded BA
  (``parallel/dist_ba.py``) over a mesh (``joint_optimize``).

Gauge: the first keyframe of every session stays fixed until
cross-session edges exist; with edges only session 0's anchor stays fixed,
so the closures can pull the sessions into one frame.

The observation count per keyframe is an integer ``index_add_``, exact in
any order (the float sums of the joint BA go through
``ops/segment.py``).
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional

import torch

from putslam_tpu_torch.backend import graph as graph_mod
from putslam_tpu_torch.backend import optimize as opt_mod
from putslam_tpu_torch.config import SlamConfig
from putslam_tpu_torch.loopclosure import verify as lc_verify
from putslam_tpu_torch.parallel import dist_ba
from putslam_tpu_torch.slam_map import features_map as fm
from putslam_tpu_torch.utils.indexing import set_rows, take_row

# weight of an accepted cross-session correction edge
CROSS_EDGE_WEIGHT = 200.0


class MergedProblem(NamedTuple):
    kf_pose: torch.Tensor        # (B·K, 7)
    kf_valid: torch.Tensor       # (B·K,) bool
    kf_gen: torch.Tensor         # (B·K,) int32 keyframe slot generations
    lm_pos: torch.Tensor         # (B·L, 3)
    lm_valid: torch.Tensor       # (B·L,) bool
    lm_gen: torch.Tensor         # (B·L,) int32
    graph: graph_mod.GraphState  # stacked edge stores, indices offset
    session_of_kf: torch.Tensor  # (B·K,) int32
    anchors: torch.Tensor        # (B,) int32 first valid keyframe per session
    map_states: List[fm.MapState]


def merge_sessions(cfg: SlamConfig, states) -> MergedProblem:
    """Stack the final ``SlamState``s of B sessions into one problem
    (``putslam_tpu/parallel/multi_session.py:51-101``). One host sync: the
    anchors."""
    del cfg
    B = len(states)
    K = states[0].map.kf_pose.shape[0]
    L = states[0].map.lm_pos.shape[0]
    dev = states[0].map.kf_pose.device

    def cat(get, offset=0):
        return torch.cat([get(s) + b * offset if offset else get(s)
                          for b, s in enumerate(states)])

    gs = [s.graph for s in states]
    g = graph_mod.GraphState(
        obs_kf=cat(lambda s: s.graph.obs_kf, K),
        obs_lm=cat(lambda s: s.graph.obs_lm, L),
        **{f: torch.cat([getattr(x, f) for x in gs]) for f in
           ("obs_xyz", "obs_w", "obs_gen", "obs_kfgen", "obs_seq",
            "obs_valid")},
        n_obs=sum((x.n_obs for x in gs),
                  torch.zeros((), dtype=gs[0].n_obs.dtype, device=dev)),
        obs_info=torch.cat([x.obs_info for x in gs]),
        pp_i=cat(lambda s: s.graph.pp_i, K),
        pp_j=cat(lambda s: s.graph.pp_j, K),
        **{f: torch.cat([getattr(x, f) for x in gs]) for f in
           ("pp_rel", "pp_w", "pp_gen_i", "pp_gen_j", "pp_valid")},
        n_pp=sum((x.n_pp for x in gs),
                 torch.zeros((), dtype=gs[0].n_pp.dtype, device=dev)))

    kf_valid = cat(lambda s: s.map.kf_valid)
    kfv = kf_valid.view(B, K).cpu()
    first = torch.argmax(kfv.to(torch.int32), dim=1)    # 0 when none valid
    anchors = (torch.arange(B) * K + first).to(torch.int32).to(dev)
    return MergedProblem(
        kf_pose=cat(lambda s: s.map.kf_pose), kf_valid=kf_valid,
        kf_gen=cat(lambda s: s.map.kf_gen), lm_pos=cat(lambda s: s.map.lm_pos),
        lm_valid=cat(lambda s: s.map.lm_valid),
        lm_gen=cat(lambda s: s.map.lm_gen), graph=g,
        session_of_kf=torch.arange(B, dtype=torch.int32,
                                   device=dev).repeat_interleave(K),
        anchors=anchors, map_states=[s.map for s in states])


class _MapView(NamedTuple):
    """The merged landmark and keyframe arrays that the verifier reads."""
    lm_gen: torch.Tensor
    lm_valid: torch.Tensor
    lm_desc: torch.Tensor
    lm_pos: torch.Tensor
    lm_view_dir: torch.Tensor
    lm_slot_used: torch.Tensor
    kf_pose: torch.Tensor
    kf_gen: torch.Tensor


def find_cross_session_closures(cfg: SlamConfig, merged: MergedProblem,
                                states,
                                generator: Optional[torch.Generator] = None,
                                u: Optional[torch.Tensor] = None,
                                top_per_pair: int = 3,
                                min_score: float = 0.3):
    """Score and verify inter-session keyframe pairs
    (``putslam_tpu/parallel/multi_session.py:117-182``). Returns (the
    merged graph with the accepted pose-pose correction edges, the number
    accepted).

    Pairs of sessions a < b only. A keyframe takes part when its signature
    is valid and it holds at least ``min_features_lc`` observations. The
    best ``top_per_pair`` scores of each pair come from a stable descending
    sort (``lax.top_k``'s order: equal scores lowest index first). Every
    candidate is verified by ``loopclosure/verify.py::verify_candidate``
    without a host sync between them; one sync reads the accept decisions.
    RANSAC draws come from ``generator``, or from ``u`` (n_candidates,
    used_pairs, H): the uniforms of candidate t (the JAX package draws them
    from ``split(key, n)[t]``)."""
    B = len(states)
    K = states[0].map.kf_pose.shape[0]
    g = merged.graph
    dev = merged.kf_pose.device
    view = _MapView(
        merged.lm_gen, merged.lm_valid,
        torch.cat([s.map.lm_desc for s in states]), merged.lm_pos,
        torch.cat([s.map.lm_view_dir for s in states]),
        torch.cat([s.map.lm_slot_used for s in states]),
        merged.kf_pose, merged.kf_gen)

    obs_count = torch.zeros((B * K,), dtype=torch.int32, device=dev)
    obs_count.index_add_(0, g.obs_kf.long(), g.obs_valid.to(torch.int32))
    has_obs = obs_count >= cfg.loop_closure.min_features_lc
    sigs = torch.stack([s.kf_sig for s in states])               # (B, K, V)
    valid = torch.stack([s.sig_valid for s in states]) & has_obs.view(B, K)
    pairs = [(a, b) for a in range(B) for b in range(a + 1, B)]
    scores = torch.stack([sigs[a] @ sigs[b].T for a, b in pairs])
    mask = torch.stack([valid[a][:, None] & valid[b][None, :]
                        for a, b in pairs])
    scores = torch.where(mask, scores, torch.full_like(scores, -torch.inf))
    top_v, top_i = torch.sort(scores.reshape(len(pairs), K * K), dim=1,
                              descending=True, stable=True)
    top_v, top_i = top_v[:, :top_per_pair], top_i[:, :top_per_pair]
    a_idx = torch.tensor([a for a, _ in pairs], device=dev)[:, None]
    b_idx = torch.tensor([b for _, b in pairs], device=dev)[:, None]
    ka = (a_idx * K + top_i // K).reshape(-1).to(torch.int32)
    kb = (b_idx * K + top_i % K).reshape(-1).to(torch.int32)
    cand_ok = (top_v >= min_score).reshape(-1)

    res = [lc_verify.verify_candidate(
        cfg, view, g, ka[t], kb[t], u=None if u is None else u[t],
        generator=generator) for t in range(ka.shape[0])]
    accept = (torch.stack([r.ok for r in res]) & cand_ok).cpu()  # one sync
    n_accepted = 0
    for t in torch.nonzero(accept)[:, 0].tolist():
        # stamp the keyframe slots' current generations: without them the
        # joint BA masks these edges out of any session whose ring wrapped
        g = graph_mod.add_pose_pose(
            g, ka[t], kb[t], res[t].rel_pose, CROSS_EDGE_WEIGHT, True,
            gen_i=take_row(merged.kf_gen, ka[t]),
            gen_j=take_row(merged.kf_gen, kb[t]))
        n_accepted += 1
    return g, n_accepted


def joint_fixed(merged: MergedProblem, n_cross_edges: int) -> torch.Tensor:
    """The gauge of the joint BA: every session's anchor, or only session
    0's once cross-session edges exist."""
    anchors = merged.anchors[:1] if n_cross_edges > 0 else merged.anchors
    return set_rows(torch.zeros_like(merged.kf_valid), anchors, True)


def joint_optimize(cfg: SlamConfig, mesh, merged: MergedProblem,
                   g: graph_mod.GraphState, n_cross_edges: int):
    """The landmark-sharded BA over the merged problem
    (``putslam_tpu/parallel/multi_session.py:185-220``). Returns (kf_pose,
    lm_pos, chi2).

    Merged graphs are where landmark ownership may be skewed, so the owner
    partition's overflow is read: when it dropped observations, the problem
    is solved again by ``gauss_newton_mm`` on one rank, with a warning, as
    the reference does (``dist_ba.partition_overflow`` gives the count)."""
    fixed = joint_fixed(merged, n_cross_edges)
    kf_out, lm_out, chi2, overflow = dist_ba.dist_gauss_newton(
        cfg.backend, mesh, merged.kf_pose, merged.kf_valid, merged.lm_pos,
        merged.lm_valid, g, fixed, merged.lm_gen, merged.kf_gen,
        cam=cfg.camera)
    n_over = int(overflow)
    if n_over > 0:
        warnings.warn(
            f"dist-BA owner partition dropped {n_over} edges on the merged "
            f"graph (skewed landmark ownership); re-solving on one rank. "
            f"Rebalance landmark ids across blocks to restore the sharded "
            f"path.", stacklevel=2)
        res = opt_mod.gauss_newton_mm(
            cfg.backend, merged.kf_pose, merged.kf_valid, merged.lm_pos,
            merged.lm_valid, g, fixed, merged.lm_gen, merged.kf_gen,
            cam=cfg.camera)
        return res.kf_pose, res.lm_pos, res.chi2
    return kf_out, lm_out, chi2
