"""Geometric verification of loop-closure candidates.

Port of ``putslam_tpu/loopclosure/verify.py``: each keyframe's observation
set (≤ ``LC_SET``) is gathered from the edge store with view-aware
descriptors, matched by the Hamming matmul with cross-check, and the
relative transform is estimated by RANSAC on the camera-frame measured
points of both keyframes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from putslam_tpu_torch.backend.graph import GraphState
from putslam_tpu_torch.config import SlamConfig
from putslam_tpu_torch.frontend import ransac as ransac_mod
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.ops import matching
from putslam_tpu_torch.slam_map.features_map import MapState
from putslam_tpu_torch.utils.indexing import nonzero_fixed, take_row

LC_SET = 128  # max landmarks gathered per keyframe for verification


class LCVerifyResult(NamedTuple):
    ok: torch.Tensor         # () bool — candidate geometrically confirmed
    rel_pose: torch.Tensor   # (7,) T with z_a ≈ T · z_b (edge A→B)
    ratio: torch.Tensor      # () float32 — matched fraction
    n_inliers: torch.Tensor  # () int32


def _gather_kf_set(m: MapState, g: GraphState, kf):
    """Live landmark observations of keyframe ``kf``: (lm_idx (P,),
    z_cam (P, 3), desc (P, 256), valid (P,)). Of each landmark's view
    slots, the one whose stored viewing direction is closest to the
    direction from this keyframe's camera is used."""
    sel = (g.obs_kf == kf) & g.obs_valid \
        & (g.obs_gen == m.lm_gen[g.obs_lm]) & m.lm_valid[g.obs_lm] \
        & (g.obs_kfgen == take_row(m.kf_gen, kf))
    idx = nonzero_fixed(sel, LC_SET, -1)
    ok = idx >= 0
    safe = torch.clamp(idx, min=0)
    lm = g.obs_lm[safe].long()
    z = g.obs_xyz[safe]
    vd = m.lm_pos[lm] - se3.translation(take_row(m.kf_pose, kf))[None, :]
    vd = vd / torch.clamp(torch.linalg.norm(vd, dim=-1, keepdim=True),
                          min=1e-9)
    cosang = torch.einsum("pdk,pk->pd", m.lm_view_dir[lm], vd)
    cosang = torch.where(m.lm_slot_used[lm], cosang,
                         torch.full_like(cosang, -np.inf))
    slot = torch.argmax(cosang, dim=-1)
    desc = m.lm_desc[lm, slot]
    return lm, z, torch.where(ok[:, None], desc, torch.zeros_like(desc)), ok


def verify_candidate(cfg: SlamConfig, m: MapState, g: GraphState, kf_a, kf_b,
                     u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> LCVerifyResult:
    """Check the pair (kf_a ↔ kf_b) and estimate the correction edge.
    ``u``: optional RANSAC uniforms, else drawn from ``generator``."""
    lc = cfg.loop_closure
    _, z_a, d_a, ok_a = _gather_kf_set(m, g, kf_a)
    _, z_b, d_b, ok_b = _gather_kf_set(m, g, kf_b)
    dist = matching.hamming_matrix(d_a, d_b, ok_a, ok_b)
    mm = matching.mutual_nn(dist, cfg.matcher.max_hamming)
    idx_b = mm.idx_b.long()
    pair_valid = mm.valid & ok_a & ok_b[idx_b]
    res = ransac_mod.estimate(cfg.ransac, cfg.camera, z_b[idx_b], z_a,
                              pair_valid, u=u, generator=generator)
    n_a = torch.sum(ok_a)
    n_b = torch.sum(ok_b)
    enough = (n_a >= lc.min_features_lc) & (n_b >= lc.min_features_lc)
    ratio = (res.n_inliers / torch.clamp(torch.minimum(n_a, n_b), min=1)
             ).to(torch.float32)
    ok = enough & res.ok & (ratio > lc.matching_ratio_threshold)
    return LCVerifyResult(ok, res.pose, ratio, res.n_inliers)
