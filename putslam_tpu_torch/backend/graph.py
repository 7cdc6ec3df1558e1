"""Fixed-capacity factor-graph edge storage — port of
``putslam_tpu/backend/graph.py``: pose→landmark observations (a measured 3D
point in the observing camera's frame) and pose→pose relative-motion edges,
as flat tensors with masks. Masked appends go to a sentinel row (see
``utils/indexing.set_rows``), where JAX drops out-of-bounds writes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.utils.indexing import set_rows


class GraphState(NamedTuple):
    obs_kf: torch.Tensor     # (M,) int32 keyframe index
    obs_lm: torch.Tensor     # (M,) int32 landmark index
    obs_xyz: torch.Tensor    # (M, 3) measured point, observing-camera frame
    obs_w: torch.Tensor      # (M,) float32 scalar information weight
    obs_gen: torch.Tensor    # (M,) int32 landmark-slot generation at insert
    obs_kfgen: torch.Tensor  # (M,) int32 keyframe-slot generation at insert
    obs_seq: torch.Tensor    # (M,) int32 append sequence number
    obs_valid: torch.Tensor  # (M,) bool
    n_obs: torch.Tensor      # () int32 total ever appended
    obs_info: torch.Tensor   # (M, 3, 3) float32 (zero: scalar weights only)
    pp_i: torch.Tensor       # (E,) int32
    pp_j: torch.Tensor       # (E,) int32
    pp_rel: torch.Tensor     # (E, 7) measured T_i⁻¹∘T_j
    pp_w: torch.Tensor       # (E,) float32
    pp_gen_i: torch.Tensor   # (E,) int32
    pp_gen_j: torch.Tensor   # (E,) int32
    pp_valid: torch.Tensor   # (E,) bool
    n_pp: torch.Tensor       # () int32

    @property
    def obs_capacity(self) -> int:
        return self.obs_kf.shape[0]

    @property
    def pp_capacity(self) -> int:
        return self.pp_i.shape[0]


def init_graph(max_observations: int, max_pose_pose: int,
               device) -> GraphState:
    M, E = max_observations, max_pose_pose
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return GraphState(
        obs_kf=torch.zeros((M,), **i32), obs_lm=torch.zeros((M,), **i32),
        obs_xyz=torch.zeros((M, 3), **f32), obs_w=torch.zeros((M,), **f32),
        obs_gen=torch.zeros((M,), **i32), obs_kfgen=torch.zeros((M,), **i32),
        obs_seq=torch.zeros((M,), **i32), obs_valid=torch.zeros((M,), **b),
        n_obs=torch.zeros((), **i32), obs_info=torch.zeros((M, 3, 3), **f32),
        pp_i=torch.zeros((E,), **i32), pp_j=torch.zeros((E,), **i32),
        pp_rel=se3.identity((E,), device=device),
        pp_w=torch.zeros((E,), **f32),
        pp_gen_i=torch.zeros((E,), **i32), pp_gen_j=torch.zeros((E,), **i32),
        pp_valid=torch.zeros((E,), **b), n_pp=torch.zeros((), **i32),
    )


def add_observations(g: GraphState, kf_idx, lm_idx, xyz, weight, mask,
                     gen=None, kf_gen=None, info=None) -> GraphState:
    """Append the masked observations. Slots go dead-first: until the store
    has ever filled, the append cursor; after that, invalid slots first,
    then the oldest valid ones in append order (FIFO). ``info``: optional
    (N, 3, 3) full information matrices (the uncertainty mode); zeros are
    stored without it."""
    M = g.obs_capacity
    m32 = mask.to(torch.int32)
    rank = torch.cumsum(m32, dim=0) - 1
    n_new = torch.sum(m32)
    cursor = torch.remainder(g.n_obs + rank, M)
    key = torch.where(g.obs_valid, g.obs_seq, torch.full_like(g.obs_seq, -1))
    order = torch.sort(key, stable=True).indices
    sorted_slots = order[torch.clamp(rank, 0, M - 1).long()]
    slot = torch.where(g.n_obs + n_new >= M, sorted_slots, cursor.long())
    slot = torch.where(mask, slot, torch.full_like(slot, M))
    n = mask.shape[0]
    zeros_i = torch.zeros((n,), dtype=torch.int32, device=mask.device)
    return g._replace(
        obs_kf=set_rows(g.obs_kf, slot, kf_idx),
        obs_lm=set_rows(g.obs_lm, slot, lm_idx),
        obs_xyz=set_rows(g.obs_xyz, slot, xyz),
        obs_w=set_rows(g.obs_w, slot, weight),
        obs_gen=set_rows(g.obs_gen, slot, gen if gen is not None else zeros_i),
        obs_kfgen=set_rows(g.obs_kfgen, slot,
                           kf_gen if kf_gen is not None else zeros_i),
        obs_info=set_rows(g.obs_info, slot, 0.0 if info is None else info),
        obs_seq=set_rows(g.obs_seq, slot, (g.n_obs + rank).to(torch.int32)),
        obs_valid=set_rows(g.obs_valid, slot, True),
        n_obs=g.n_obs + n_new,
    )


def reclaim_observation_slots(g: GraphState, lm_gen, kf_gen) -> GraphState:
    """Clear edges whose landmark or keyframe slot was recycled since."""
    fresh = (g.obs_gen == lm_gen[g.obs_lm]) & (g.obs_kfgen == kf_gen[g.obs_kf])
    return g._replace(obs_valid=g.obs_valid & fresh)


def add_pose_pose(g: GraphState, i, j, rel, weight, valid=True,
                  gen_i=None, gen_j=None) -> GraphState:
    """Append one pose-pose edge at slot n_pp mod E when ``valid``."""
    E = g.pp_capacity
    dev = g.pp_i.device
    v = torch.as_tensor(valid, device=dev)
    slot = torch.where(v, torch.remainder(g.n_pp, E),
                       torch.full_like(g.n_pp, E)).reshape(1)
    return g._replace(
        pp_i=set_rows(g.pp_i, slot, i),
        pp_j=set_rows(g.pp_j, slot, j),
        pp_rel=set_rows(g.pp_rel, slot, rel),
        pp_w=set_rows(g.pp_w, slot, weight),
        pp_gen_i=set_rows(g.pp_gen_i, slot, gen_i if gen_i is not None else 0),
        pp_gen_j=set_rows(g.pp_gen_j, slot, gen_j if gen_j is not None else 0),
        pp_valid=set_rows(g.pp_valid, slot, True),
        n_pp=g.n_pp + v.to(torch.int32),
    )


def prune_observations(g: GraphState, drop_mask) -> GraphState:
    """Disable observations (chi²-based edge pruning)."""
    return g._replace(obs_valid=g.obs_valid & ~drop_mask)
