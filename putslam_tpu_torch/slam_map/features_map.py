"""Fixed-capacity global feature map with keyframes and covisibility.

Port of ``putslam_tpu/slam_map/features_map.py``. Every store is a
fixed-capacity tensor + mask; allocation writes into invalid slots, deletion
clears the mask. Functions return new states and leave their inputs
untouched, as the JAX package's pure functions do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from putslam_tpu_torch.config import SlamConfig
from putslam_tpu_torch.frontend.detector import Features
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.ops import guided_match as guided_ops
from putslam_tpu_torch.utils.indexing import nonzero_fixed, set_rows, take_row

DESC_BITS = 256


class MapState(NamedTuple):
    """The SLAM map: landmarks + keyframes + covisibility."""

    lm_pos: torch.Tensor        # (L, 3) world positions
    lm_desc: torch.Tensor       # (L, D, 256) int8 ±1 multi-view descriptors
    lm_view_dir: torch.Tensor   # (L, D, 3) unit camera→landmark dir per slot
    lm_slot_used: torch.Tensor  # (L, D) bool
    lm_octave: torch.Tensor     # (L,) int32 octave at first detection
    lm_life: torch.Tensor       # (L,) float32 lifeValue
    lm_n_obs: torch.Tensor      # (L,) int32 measurement count
    lm_last_kf: torch.Tensor    # (L,) int32 last keyframe that observed it
    lm_valid: torch.Tensor      # (L,) bool
    lm_gen: torch.Tensor        # (L,) int32 slot generation (bumped on reuse)
    kf_pose: torch.Tensor       # (K, 7) camera→world
    kf_valid: torch.Tensor      # (K,) bool
    kf_seq: torch.Tensor        # (K,) int32 sequential keyframe number per slot
    kf_gen: torch.Tensor        # (K,) int32 slot generation (bumped on reuse)
    n_kf: torch.Tensor          # () int32 — total keyframes ever created
    covis: torch.Tensor         # (K, K) float32 covisibility weights

    @property
    def capacity(self) -> int:
        return self.lm_pos.shape[0]


def init_map(cfg: SlamConfig, device) -> MapState:
    L = cfg.map.max_landmarks
    D = cfg.map.descriptor_views
    K = cfg.map.max_keyframes
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return MapState(
        lm_pos=torch.zeros((L, 3), **f32),
        lm_desc=torch.zeros((L, D, DESC_BITS), dtype=torch.int8, device=device),
        lm_view_dir=torch.zeros((L, D, 3), **f32),
        lm_slot_used=torch.zeros((L, D), dtype=torch.bool, device=device),
        lm_octave=torch.zeros((L,), **i32),
        lm_life=torch.zeros((L,), **f32),
        lm_n_obs=torch.zeros((L,), **i32),
        lm_last_kf=torch.full((L,), -1, **i32),
        lm_valid=torch.zeros((L,), dtype=torch.bool, device=device),
        lm_gen=torch.zeros((L,), **i32),
        kf_pose=se3.identity((K,), device=device),
        kf_valid=torch.zeros((K,), dtype=torch.bool, device=device),
        kf_seq=torch.full((K,), -1, **i32),
        kf_gen=torch.zeros((K,), **i32),
        n_kf=torch.zeros((), **i32),
        covis=torch.zeros((K, K), **f32),
    )


class GuidedMatchResult(NamedTuple):
    """matchXYZ output: per-landmark correspondence into the current frame."""

    feat_idx: torch.Tensor      # (L,) int32 — matched frame-feature index
    dist: torch.Tensor          # (L,) float32 — descriptor distance
    valid: torch.Tensor         # (L,) bool — gated + accepted
    n_candidates: torch.Tensor  # () int32 — landmarks with any candidate


ACCEPTANCES = guided_ops.ACCEPTANCES


def _gates(cfg: SlamConfig, radius_scale: float,
           hamming_slack: float) -> guided_ops.Gates:
    mc = cfg.matcher
    return guided_ops.Gates(mc.matching_xyz_sphere_radius * radius_scale,
                            mc.octave_window, mc.max_hamming + hamming_slack,
                            mc.acceptance, mc.matching_xyz_acceptance_ratio)


def _landmarks_in_camera(m: MapState, pose_guess) -> torch.Tensor:
    return se3.apply(se3.inverse(pose_guess), m.lm_pos)             # (L, 3)


def _guided_distances(cfg: SlamConfig, m: MapState, pose_guess,
                      feat: Features, radius_scale: float) -> torch.Tensor:
    """(L, N) gated descriptor distances: 3D sphere gate + octave window +
    min over the multi-view slots of the Hamming distance (one matmul).
    inf where gated out."""
    return guided_ops.plain_distances(
        _landmarks_in_camera(m, pose_guess), m, feat,
        cfg.matcher.matching_xyz_sphere_radius * radius_scale,
        cfg.matcher.octave_window)


class GuidedMatchPairs(NamedTuple):
    """Multi-mate matchXYZ output: a flat (landmark, feature) pair list."""

    lm_idx: torch.Tensor        # (P,) int32
    feat_idx: torch.Tensor      # (P,) int32
    dist: torch.Tensor          # (P,) float32
    valid: torch.Tensor         # (P,) bool
    n_candidates: torch.Tensor  # () int32 landmarks with any candidate


def guided_match_pairs(cfg: SlamConfig, m: MapState, pose_guess,
                       feat: Features, radius_scale: float = 1.0,
                       hamming_slack: float = 0.0) -> GuidedMatchPairs:
    """Band-acceptance multi-mate guided matching: per landmark the best
    ``cfg.matcher.max_mates`` candidates with ratio·dist ≤ best (and under
    the absolute Hamming gate) become pairs; the flat pair list is compacted
    by match quality to ``2 × feat.capacity`` entries for the absolute-pose
    RANSAC. Off entries point at landmark 0 and feature 0 with dist inf.

    Ties come lowest index first, as ``lax.top_k`` gives them: the k mates
    of a landmark by k rounds of first-maximum, the compaction by a stable
    descending sort."""
    mc = cfg.matcher
    L = m.capacity
    N = feat.capacity
    k = max(int(mc.max_mates), 1)
    dev = m.lm_pos.device
    dist = _guided_distances(cfg, m, pose_guess, feat, radius_scale)
    finite = torch.isfinite(dist)
    best = torch.amin(torch.where(finite, dist, torch.full_like(dist, 1e9)),
                      dim=1, keepdim=True)
    band = finite & (mc.matching_xyz_acceptance_ratio * dist <= best) \
        & (dist <= mc.max_hamming + hamming_slack)
    neg_inf = torch.full_like(dist, -math.inf)
    negd = torch.where(band, -dist, neg_inf)
    vals, idxs = [], []
    for _ in range(k):
        v, i = torch.max(negd, dim=1, keepdim=True)      # first maximum
        vals.append(v)
        idxs.append(i)
        negd = negd.scatter(1, i, -math.inf)
    vals = torch.cat(vals, dim=1)                                    # (L, k)
    pair_ok = torch.isfinite(vals).reshape(-1)                       # (L·k,)
    pair_lm = torch.arange(L, dtype=torch.int32,
                           device=dev).repeat_interleave(k)
    pair_feat = torch.cat(idxs, dim=1).reshape(-1).to(torch.int32)
    pair_dist = (-vals).reshape(-1)
    P = 2 * N
    sel_negd = torch.where(pair_ok, -pair_dist,
                           torch.full_like(pair_dist, -math.inf))
    top_vals, sel = torch.sort(sel_negd, descending=True, stable=True)
    top_vals, sel = top_vals[:P], sel[:P]
    if sel.shape[0] < P:
        pad = P - sel.shape[0]
        sel = torch.nn.functional.pad(sel, (0, pad))
        top_vals = torch.nn.functional.pad(top_vals, (0, pad),
                                           value=-math.inf)
    on = torch.isfinite(top_vals)
    zero = torch.zeros_like(pair_lm[sel])
    return GuidedMatchPairs(
        lm_idx=torch.where(on, pair_lm[sel], zero),
        feat_idx=torch.where(on, pair_feat[sel], zero),
        dist=torch.where(on, -top_vals, torch.full_like(top_vals, math.inf)),
        valid=on,
        n_candidates=torch.sum(torch.any(finite, dim=1)).to(torch.int32))


def guided_match(cfg: SlamConfig, m: MapState, pose_guess, feat: Features,
                 radius_scale: float = 1.0,
                 hamming_slack: float = 0.0) -> GuidedMatchResult:
    """Best frame feature per landmark under the sphere and octave gates,
    accepted by the absolute Hamming gate (``acceptance="hamming"``) or,
    with ``acceptance="ratio"``, only where it also beats the second-best
    candidate by the acceptance ratio (a single candidate is distinct).
    ``hamming_slack`` widens the absolute gate."""
    mc = cfg.matcher
    if mc.acceptance not in ACCEPTANCES:
        raise NotImplementedError(
            f"matcher.acceptance={mc.acceptance!r} is not known "
            f"(one of {ACCEPTANCES})")
    return GuidedMatchResult(*guided_ops.match(
        _landmarks_in_camera(m, pose_guess), m, feat,
        _gates(cfg, radius_scale, hamming_slack)))


def _allocate_slots(free_mask, want, max_add: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair the first ``max_add`` wanted candidates with free slots.
    Returns (cand_idx, slot_idx), (max_add,) int32; −1 marks unused."""
    slot_free_idx = nonzero_fixed(free_mask, max_add, -1)
    cand_idx = nonzero_fixed(want, max_add, -1)
    ok = (cand_idx >= 0) & (slot_free_idx >= 0)
    neg = torch.full_like(cand_idx, -1)
    return (torch.where(ok, cand_idx, neg).to(torch.int32),
            torch.where(ok, slot_free_idx, neg).to(torch.int32))


def add_landmarks(cfg: SlamConfig, m: MapState, pose, feat: Features,
                  already_matched, kf_idx) -> MapState:
    """Provision new landmarks from unmatched depth-valid features that are
    not too close to an existing landmark, at most max_once_feature_add."""
    mp = cfg.map
    L = m.capacity
    xyz_w = se3.apply(pose, feat.xyz)                               # (N, 3)
    d = torch.linalg.norm(xyz_w[:, None, :] - m.lm_pos[None, :, :], dim=-1)
    d = torch.where(m.lm_valid[None, :], d, torch.full_like(d, math.inf))
    too_close = torch.amin(d, dim=1) < mp.min_euclidean_distance_of_features

    want = feat.has_depth & ~already_matched & ~too_close
    cand_idx, slot_idx = _allocate_slots(~m.lm_valid, want,
                                         mp.max_once_feature_add)
    ok = slot_idx >= 0
    safe_cand = torch.clamp(cand_idx, min=0).long()
    slot = torch.where(ok, slot_idx, torch.full_like(slot_idx, L)).long()

    view_dir = xyz_w[safe_cand] - se3.translation(pose)[None, :]
    view_dir = view_dir / torch.clamp(
        torch.linalg.norm(view_dir, dim=-1, keepdim=True), min=1e-9)

    desc = set_rows(m.lm_desc[:, 0], slot, feat.desc[safe_cand])
    vdir = set_rows(m.lm_view_dir[:, 0], slot, view_dir)
    # a (re)used slot keeps descriptor view 0 only
    fresh = (torch.arange(m.lm_slot_used.shape[1], device=slot.device)
             == 0)[None]
    used = set_rows(m.lm_slot_used, slot, fresh)
    gen = set_rows(m.lm_gen, slot, m.lm_gen[torch.clamp(slot, max=L - 1)] + 1)
    return m._replace(
        lm_pos=set_rows(m.lm_pos, slot, xyz_w[safe_cand]),
        lm_desc=torch.cat([desc[:, None], m.lm_desc[:, 1:]], dim=1),
        lm_view_dir=torch.cat([vdir[:, None], m.lm_view_dir[:, 1:]], dim=1),
        lm_slot_used=used,
        lm_octave=set_rows(m.lm_octave, slot, feat.octave[safe_cand]),
        lm_life=set_rows(m.lm_life, slot, mp.life_value_init),
        lm_n_obs=set_rows(m.lm_n_obs, slot, 1),
        lm_last_kf=set_rows(m.lm_last_kf, slot, kf_idx),
        lm_valid=set_rows(m.lm_valid, slot, True),
        lm_gen=gen,
    )


def update_matched_landmarks(cfg: SlamConfig, m: MapState, pose,
                             feat: Features, gm: GuidedMatchResult,
                             kf_idx) -> MapState:
    """Matched landmarks: life bonus, observation count, last keyframe, and
    a new descriptor slot when the view direction differs from every
    stored slot by more than view_angle_new_descriptor."""
    mp = cfg.map
    L, D, _ = m.lm_desc.shape
    matched = gm.valid
    fidx = torch.clamp(gm.feat_idx, 0, feat.capacity - 1).long()

    lm_life = torch.where(matched, m.lm_life + mp.life_value_measurement_bonus,
                          m.lm_life - mp.life_value_decay * m.lm_valid)
    lm_n_obs = m.lm_n_obs + matched.to(torch.int32)
    lm_last_kf = torch.where(matched, torch.as_tensor(
        kf_idx, dtype=torch.int32, device=matched.device), m.lm_last_kf)

    vd = m.lm_pos - se3.translation(pose)[None, :]
    vd = vd / torch.clamp(torch.linalg.norm(vd, dim=-1, keepdim=True), min=1e-9)
    cosang = torch.einsum("ldk,lk->ld", m.lm_view_dir, vd)
    cosang = torch.where(m.lm_slot_used, cosang, torch.full_like(cosang, -1.0))
    novel = torch.amax(cosang, dim=-1) < math.cos(mp.view_angle_new_descriptor)
    free_slot = torch.argmin(m.lm_slot_used.to(torch.int32), dim=-1)
    can_store = ~torch.all(m.lm_slot_used, dim=-1)
    store = matched & novel & can_store
    # (L, D) one-hot of the slot written per landmark (none where ~store)
    write = store[:, None] & (
        torch.arange(D, device=store.device)[None, :] == free_slot[:, None])
    return m._replace(
        lm_desc=torch.where(write[..., None], feat.desc[fidx][:, None, :],
                            m.lm_desc),
        lm_view_dir=torch.where(write[..., None], vd[:, None, :],
                                m.lm_view_dir),
        lm_slot_used=m.lm_slot_used | write,
        lm_life=lm_life, lm_n_obs=lm_n_obs, lm_last_kf=lm_last_kf,
        lm_valid=m.lm_valid & (lm_life > 0.0))


def add_keyframe(cfg: SlamConfig, m: MapState, pose, covis_with_prev
                 ) -> Tuple[MapState, torch.Tensor]:
    """Append a keyframe to the ring (index n_kf mod K), bump the slot's
    generation when it recycles a keyframe, reset its covisibility row and
    column, and record the covisibility with the previous keyframe. Device
    ops only: the slot is a device index, never a host one."""
    K = m.kf_pose.shape[0]
    dev = m.kf_pose.device
    idx = torch.remainder(m.n_kf, K).long().reshape(1)
    prev = torch.remainder(m.n_kf - 1, K).long().reshape(1)
    recycled = take_row(m.kf_valid, idx[0])
    c = covis_with_prev if torch.is_tensor(covis_with_prev) else torch.full(
        (), covis_with_prev, dtype=m.covis.dtype, device=dev)
    ring = torch.arange(K, device=dev)
    is_idx = ring == idx
    covis = torch.where(is_idx[:, None] | is_idx[None, :],
                        torch.zeros_like(m.covis), m.covis)
    pair = (is_idx[:, None] & (ring == prev)[None, :]) \
        | ((ring == prev)[:, None] & is_idx[None, :])
    covis = torch.where(pair, c.to(m.covis.dtype), covis)
    return m._replace(
        kf_pose=set_rows(m.kf_pose, idx, pose[None]),
        kf_valid=set_rows(m.kf_valid, idx, True),
        kf_seq=set_rows(m.kf_seq, idx, m.n_kf.reshape(1)),
        kf_gen=set_rows(m.kf_gen, idx, (take_row(m.kf_gen, idx[0])
                                        + recycled.to(torch.int32))
                        .reshape(1)),
        n_kf=m.n_kf + 1, covis=covis), idx[0].to(torch.int32)


def covisibility_ratio(gm: GuidedMatchResult, m: MapState, last_kf_seq):
    """Fraction of matched landmarks already observed at the last keyframe."""
    seen_before = m.lm_last_kf == last_kf_seq
    both = torch.sum((gm.valid & seen_before).to(torch.float32))
    now = torch.clamp(torch.sum(gm.valid.to(torch.float32)), min=1.0)
    return both / now


def active_window_fixed(m: MapState, window: int) -> torch.Tensor:
    """(K,) bool: keyframes older than the active optimisation window."""
    age = m.n_kf - 1 - m.kf_seq
    return m.kf_valid & (age >= window)


def compress_map(cfg: SlamConfig, m: MapState, window: int) -> MapState:
    """Drop weak (< 2 observations) landmarks last seen outside the window."""
    out_of_window = m.lm_last_kf < (m.n_kf - window)
    drop = m.lm_valid & out_of_window & (m.lm_n_obs < 2)
    return m._replace(lm_valid=m.lm_valid & ~drop)
