"""The full SLAM engine: VO + global feature map + bundle adjustment.

Port of ``putslam_tpu/models/slam.py``. One ``slam_step`` runs: detection, frame-to-frame VO (with the EKF prior where
VO fails, when ``motion_model.enabled``), guided map matching (one mate per
landmark, or up to ``matcher.max_mates`` with RANSAC arbitrating) with the
absolute-pose RANSAC and its widening retry ladder, the drift-budget
correction gate, the keyframe decision and bookkeeping, loop closure (when
``loop_closure.enabled``: BoW signature and scoring on keyframes, one
queued candidate popped and verified per frame, its correction edge added
before the BA), the periodic bundle adjustment, map compression, the
re-anchor of the live pose on the last keyframe and the EKF correction.
``run_slam_final`` adds the end-of-run full-graph polish, the trajectory
repair and the re-anchored trajectory; ``finalize_dist`` is that polish with
the landmark-sharded BA of ``parallel/dist_ba.py``. With
``map.use_uncertainty`` every observation carries the 3×3 information
matrix of the depth-sensor model
(plain, or shrunk along the surface normal or the image gradient), which
the Mahalanobis RANSAC (``error_version=3``) and the BA
(``backend.use_obs_info``) read. In playback mode (``run_playback``) a known
trajectory takes the place of the VO prediction and drives the map and the
backend. ``run_slam(archive=)`` absorbs the state into a host
``slam_map.archive.MapArchive`` at every chunk boundary, and
``run_slam_global`` polishes the archived graph after the run.

A frame is ``slam_track`` (detection, VO, the map matching and its retry
ladder, the keyframe and BA decisions as device flags), then either
``slam_tail`` (a frame that is no keyframe: the loop-closure pop and
verification and the frame's end) or ``slam_keyframe``, ``bundle_adjust``
on its cadence and ``slam_finish``. The JAX package's ``lax.cond``s go
through ``utils/control.cond``: the VO retry, each widening of the ladder,
the loop-closure verification, the sorted observation slots and each
Gauss-Newton iteration everywhere, and in ``slam_frame`` the keyframe
bookkeeping and the BA too. ``slam_step`` runs a frame eagerly: one packed
host read of [is_keyframe, run_ba] (``read_flags``) picks its branch, and
the other branches run masked (no host read). ``slam_frame`` is the frame
as one program with every branch a ``cond``: ``models/compiled.py``
replays it from one CUDA graph a frame with conditional nodes, and the
sequence functions do so on a CUDA device (``graph=``). The end of the run
is compiled too: ``finalize_map`` (release, BA, chi² prune, BA,
``check_trajectory``) is one program of ``cond``s that ``finalize``
replays from one CUDA graph (``compiled.FinalizeGraphs``), and
``check_trajectory`` repairs the trajectory on the device with no host
read (the JAX package's ``lax.scan`` as a prefix product). The JAX package
computes the loop-closure signature and scores on every frame and keeps
them on keyframes; the port computes them on keyframes only.

RANSAC draws come from an explicit ``torch.Generator``, or — for a test
that replays the JAX package's key chain — from ``draws``, a mapping with
one (used_pairs, H) uniform tensor per RANSAC call of the frame
(``draw_names``): ``vo`` (and ``vo_retry`` with
``matcher.retry_hamming_slack > 0``), ``map``, ``retry0``, ``retry1`` and,
with loop closure, ``lc``. Every one is drawn on every frame
(``frame_draws``), so the stream does not depend on a branch.

``LCQueue`` (``loopclosure/bow.py``) and ``EKFState`` (``motion/ekf.py``)
are re-exported here.

Its scatters stay PyTorch's own, because each is exact in any order, so a
run repeats itself bit for bit without a fixed order: the matched-feature
count is an integer ``index_add_``, and the per-landmark inlier flag,
distance, feature index and validity and the best keyframe age are
``amin`` / ``amax`` ``scatter_reduce``s. The solvers' float sums are the
ones that need a fixed order (``ops/segment.py``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from putslam_tpu_torch.backend import graph as graph_mod
from putslam_tpu_torch.backend import optimize as opt_mod
from putslam_tpu_torch.config import SlamConfig
from putslam_tpu_torch.frontend import ransac as ransac_mod
from putslam_tpu_torch.frontend.detector import Features, detect_and_describe
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.geometry import uncertainty as uncertainty_mod
from putslam_tpu_torch.loopclosure import bow
from putslam_tpu_torch.loopclosure import verify as lc_verify
from putslam_tpu_torch.loopclosure.bow import LCQueue  # noqa: F401
from putslam_tpu_torch.models import vo as vo_mod
from putslam_tpu_torch.motion import ekf as ekf_mod
from putslam_tpu_torch.motion.ekf import EKFState  # noqa: F401
from putslam_tpu_torch.ops import rgbd
from putslam_tpu_torch.parallel import dist_ba
from putslam_tpu_torch.slam_map import features_map as fm
from putslam_tpu_torch.utils import control, timing
from putslam_tpu_torch.utils.device import (as_tensor, resolve_device,
                                            use_graphs)
from putslam_tpu_torch.utils.indexing import nonzero_fixed, set_rows, take_row


class SlamState(NamedTuple):
    map: fm.MapState
    graph: graph_mod.GraphState
    prev_feat: Features
    pose: torch.Tensor               # (7,) current camera→world
    pose_smooth: torch.Tensor        # (7,) smoothed output pose chain
    last_kf_idx: torch.Tensor        # () int32 ring index of the last keyframe
    last_kf_pose: torch.Tensor       # (7,) its pose at creation
    frames_since_kf: torch.Tensor    # () int32
    frame_idx: torch.Tensor          # () int32
    kf_sig: torch.Tensor             # (K, V) BoW signatures per keyframe slot
    sig_valid: torch.Tensor          # (K,) bool
    lc_queue: LCQueue
    n_lc_edges: torch.Tensor         # () int32
    health: torch.Tensor             # () float32 EMA of first-pass map ratio
    frames_since_map_ok: torch.Tensor  # () int32
    ekf: EKFState


class SlamOutputs(NamedTuple):
    pose: torch.Tensor
    vo_ok: torch.Tensor
    map_ok: torch.Tensor
    n_map_matches: torch.Tensor
    n_map_inliers: torch.Tensor
    is_keyframe: torch.Tensor
    ba_ran: torch.Tensor
    chi2: torch.Tensor
    n_landmarks: torch.Tensor
    anchor_ring: torch.Tensor   # () int32 keyframe ring slot anchoring the frame
    anchor_seq: torch.Tensor    # () int32 that keyframe's sequential number
    anchor_pose: torch.Tensor   # (7,) the anchor keyframe pose at emit time


UNCERTAINTY_MODELS = ("sensor", "normal", "gradient")


def check_config(cfg: SlamConfig) -> None:
    """Raise NotImplementedError for an option value the port does not
    know (a solver, grid policy, descriptor, acceptance or uncertainty
    model by another name)."""
    vo_mod.check_vo_config(cfg)
    opt_mod.check_backend_config(cfg.backend)
    if cfg.matcher.acceptance not in fm.ACCEPTANCES:
        raise NotImplementedError(
            f"matcher.acceptance={cfg.matcher.acceptance!r} is not known "
            f"(one of {fm.ACCEPTANCES})")
    if cfg.map.uncertainty_model not in UNCERTAINTY_MODELS:
        raise NotImplementedError(
            f"map.uncertainty_model={cfg.map.uncertainty_model!r} is not "
            f"known (one of {UNCERTAINTY_MODELS})")


def _obs_info(cfg: SlamConfig) -> float:
    """Scalar information weight 1/σ² of a 3D observation, σ = half the
    Euclidean RANSAC gate."""
    sigma = cfg.ransac.inlier_threshold_euclidean / 2.0
    return 1.0 / (sigma * sigma)


def _full_obs_info(cfg: SlamConfig, uv, xyz, dirs=None):
    """Per-observation 3×3 information matrices from the depth-sensor noise
    model, or None when the engine runs with scalar weights
    (``add_observations`` then stores zeros). ``dirs``: optional (N, 3)
    anisotropy directions (surface normals or image-gradient directions,
    per ``cfg.map.uncertainty_model``): the covariance is shrunk along them
    before the inversion; zero rows leave the sensor model as it is."""
    if not cfg.map.use_uncertainty:
        return None
    z = torch.clamp(xyz[..., 2], min=cfg.camera.min_depth)
    cov = uncertainty_mod.point_covariance(cfg.camera, uv, z)
    if dirs is not None:
        if cfg.map.uncertainty_model == "normal":
            shaped = uncertainty_mod.normal_scaled_covariance(
                cov, dirs, cfg.map.scale_uncertainty_normal)
        else:
            shaped = uncertainty_mod.gradient_scaled_covariance(
                cov, dirs, cfg.map.scale_uncertainty_gradient)
        have = torch.linalg.norm(dirs, dim=-1) > 1e-6
        cov = torch.where(have[:, None, None], shaped, cov)
    return uncertainty_mod.inv3x3(cov)


def _obs_dirs(cfg: SlamConfig, gray, depth, feat: Features):
    """(N, 3) anisotropy directions of the configured uncertainty model, or
    None for the plain sensor model: surface normals sampled at the feature
    pixels, or lifted image-gradient directions."""
    model = cfg.map.uncertainty_model
    if not cfg.map.use_uncertainty or model == "sensor":
        return None
    if model == "normal":
        nm = rgbd.surface_normals(cfg.camera, depth)            # (H, W, 3)
        iu = torch.clamp(torch.round(feat.uv[:, 0]).long(), 0,
                         cfg.camera.width - 1)
        iv = torch.clamp(torch.round(feat.uv[:, 1]).long(), 0,
                         cfg.camera.height - 1)
        return nm[iv, iu]
    if model == "gradient":
        z = torch.clamp(feat.xyz[..., 2], min=cfg.camera.min_depth)
        return rgbd.gradient_directions_3d(cfg.camera, gray, feat.uv, z)
    raise ValueError(model)


def _rows(x, idx):
    """``x[idx]``, or None for no ``x``."""
    return None if x is None else x[idx]


def _landmark_indices_for(m: fm.MapState, pose, feat: Features):
    """Per feature, the landmark slot nearest its lifted world position
    (used at init). Returns (indices (N,), distances (N,))."""
    xyz_w = se3.apply(pose, feat.xyz)
    d = torch.linalg.norm(xyz_w[:, None, :] - m.lm_pos[None, :, :], dim=-1)
    d = torch.where(m.lm_valid[None, :], d, torch.full_like(d, np.inf))
    return torch.argmin(d, dim=1).to(torch.int32), torch.amin(d, dim=1)


def slam_init(cfg: SlamConfig, gray, depth, init_pose=None,
              device=None) -> SlamState:
    """First frame: detect, create keyframe 0, provision the initial
    landmarks and anchor their observations. ``device`` defaults to the
    device of ``gray``."""
    check_config(cfg)
    dev = resolve_device(device) if device is not None else gray.device
    gray = as_tensor(gray, dev, torch.float32)
    depth = as_tensor(depth, dev, torch.float32)
    init_pose = se3.identity(device=dev) if init_pose is None else \
        as_tensor(init_pose, dev, torch.float32)
    i32 = dict(dtype=torch.int32, device=dev)
    feat = detect_and_describe(cfg, gray, depth)
    N = feat.capacity
    m = fm.init_map(cfg, dev)
    m, kf_idx = fm.add_keyframe(cfg, m, init_pose, 1.0)
    m = fm.add_landmarks(cfg, m, init_pose, feat,
                         torch.zeros((N,), dtype=torch.bool, device=dev),
                         torch.zeros((), **i32))
    g = graph_mod.init_graph(cfg.backend.max_observations,
                             cfg.backend.max_pose_pose_edges, dev)
    lm_idx, lm_dist = _landmark_indices_for(m, init_pose, feat)
    g = graph_mod.add_observations(
        g, kf_idx.expand(N), lm_idx, feat.xyz,
        torch.full((N,), _obs_info(cfg), dtype=torch.float32, device=dev),
        feat.has_depth & (lm_dist < 1e-4),
        gen=m.lm_gen[lm_idx], kf_gen=take_row(m.kf_gen, kf_idx).expand(N),
        info=_full_obs_info(cfg, feat.uv_undist, feat.xyz,
                            _obs_dirs(cfg, gray, depth, feat)))
    K = cfg.map.max_keyframes
    V = cfg.loop_closure.vocab_size
    Q = cfg.loop_closure.queue_capacity
    at = kf_idx.reshape(1)
    kf_sig = set_rows(torch.zeros((K, V), dtype=torch.float32, device=dev),
                      at, bow.signature(bow.make_vocab(V, dev), feat.desc,
                                        feat.valid)[None])
    sig_valid = set_rows(torch.zeros((K,), dtype=torch.bool, device=dev), at,
                         True)
    return SlamState(
        map=m, graph=g, prev_feat=feat, pose=init_pose,
        pose_smooth=init_pose, last_kf_idx=kf_idx, last_kf_pose=init_pose,
        frames_since_kf=torch.zeros((), **i32),
        frame_idx=torch.ones((), **i32),
        kf_sig=kf_sig, sig_valid=sig_valid,
        lc_queue=bow.init_queue(Q, dev),
        n_lc_edges=torch.zeros((), **i32),
        health=torch.ones((), dtype=torch.float32, device=dev),
        frames_since_map_ok=torch.zeros((), **i32),
        ekf=ekf_mod.init(cfg.motion_model, init_pose),
    )


def _tree_where(cond, a, b):
    return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def draw_names(cfg: SlamConfig, playback: bool = False):
    """The RANSAC calls of one frame, in the order their uniforms are drawn:
    ``vo`` (and ``vo_retry`` with ``matcher.retry_hamming_slack > 0``; none
    in playback), ``map``, ``retry0`` … and, with loop closure, ``lc``."""
    names = [] if playback else vo_mod.vo_draw_names(cfg)
    names.append("map")
    names += [f"retry{a}" for a in range(cfg.matcher.retries)]
    if cfg.loop_closure.enabled:
        names.append("lc")
    return names


def frame_draws(cfg: SlamConfig, generator: Optional[torch.Generator], device,
                playback: bool = False, out: Optional[dict] = None) -> dict:
    """Every uniform of one frame, drawn whether or not the frame runs the
    call: the random stream does not depend on a branch (the JAX package
    splits its keys the same way on every frame). ``out``: buffers of
    those names to draw into."""
    return ransac_mod.draw_named(cfg.ransac, draw_names(cfg, playback),
                                 generator, device, out)


class Track(NamedTuple):
    """What the track part of a frame hands the rest of the frame."""
    feat: Features
    obs_dirs: Optional[torch.Tensor]
    vo_res: vo_mod.VOStepResult
    ekf_pred: EKFState
    pose_new: torch.Tensor
    gm: fm.GuidedMatchResult       # valid: the matched (inlier) landmarks
    p_cam: torch.Tensor
    covis: torch.Tensor
    n_matched: torch.Tensor
    map_ok: torch.Tensor
    res_map_ok: torch.Tensor
    first_pass_ratio: torch.Tensor
    flags: torch.Tensor            # (2,) bool [is_keyframe, run_ba]


class KeyframeUpdate(NamedTuple):
    """The map, graph and loop-closure stores after a keyframe's
    bookkeeping (and its bundle adjustment, where one runs)."""
    map: fm.MapState
    graph: graph_mod.GraphState
    kf_sig: torch.Tensor
    sig_valid: torch.Tensor
    lc_queue: LCQueue
    n_lc_edges: torch.Tensor
    chi2: torch.Tensor


_PP_FIELDS = ("pp_i", "pp_j", "pp_rel", "pp_w", "pp_gen_i", "pp_gen_j",
              "pp_valid", "n_pp")


def _lc_pop_verify(cfg: SlamConfig, m, g, lc_queue, n_lc, u):
    """Pop the best queued candidate and, when there is one, verify it and
    add its correction edge: the ``lax.cond`` on ``isfinite(cand_p)`` of
    ``putslam_tpu/models/slam.py:529``. Returns (graph, queue,
    n_lc_edges)."""
    cand_a, cand_b, cand_p, lc_queue = bow.pop_best(lc_queue)
    ca = torch.clamp(cand_a, min=0)
    cb = torch.clamp(cand_b, min=0)

    def verify():
        vres = lc_verify.verify_candidate(cfg, m, g, ca, cb, u=u)
        g2 = graph_mod.add_pose_pose(
            g, ca, cb, vres.rel_pose,
            torch.full((), 200.0, device=ca.device), vres.ok,
            gen_i=take_row(m.kf_gen, ca), gen_j=take_row(m.kf_gen, cb))
        return [getattr(g2, f) for f in _PP_FIELDS], \
            n_lc + vres.ok.to(torch.int32)

    pp, n_lc = control.cond(
        torch.isfinite(cand_p), verify,
        control.clone(([getattr(g, f) for f in _PP_FIELDS], n_lc)))
    return g._replace(**dict(zip(_PP_FIELDS, pp))), lc_queue, n_lc


def _finish(cfg: SlamConfig, state: SlamState, tr, kb: KeyframeUpdate,
            is_kf: bool, playback: bool):
    """The end of a frame: on a keyframe the map compression, then the
    re-anchor of the live pose on the last keyframe, the smoothed output
    pose, the EKF correction and the new state. Returns (state, outputs)."""
    K = state.map.kf_pose.shape[0]
    dev = state.pose.device
    m = kb.map
    if is_kf:
        m = fm.compress_map(cfg, m, cfg.map.max_frames_window)
        kf_ring = torch.remainder(state.map.n_kf, K)
        kf_pose_before = tr.pose_new
    else:
        kf_ring = torch.remainder(state.last_kf_idx, K)
        kf_pose_before = state.last_kf_pose
    kf_pose_after = take_row(m.kf_pose, kf_ring)
    pose_out = se3.compose(kf_pose_after,
                           se3.compose(se3.inverse(kf_pose_before),
                                       tr.pose_new))

    # ---- smoothed output trajectory (cfg.pose_blend_alpha) --------------
    if playback or cfg.pose_blend_alpha >= 1.0:
        pose_smooth_out = pose_out
    else:
        smooth_pred = se3.compose(state.pose_smooth, tr.vo_res.rel_pose)
        delta_s = se3.boxminus(pose_out, smooth_pred)
        mag = torch.linalg.norm(delta_s[:3])
        alpha = torch.where(mag > cfg.pose_blend_snap,
                            torch.ones_like(mag),
                            torch.full_like(mag, cfg.pose_blend_alpha))
        pose_smooth_out = se3.retract(smooth_pred, alpha * delta_s)

    # ---- EKF measurement update with the accepted frame pose; a fully
    # failed frame keeps the prediction, so the velocity coasts -----------
    ekf_new = tr.ekf_pred
    if cfg.motion_model.enabled and not playback:
        ekf_corr = ekf_mod.correct(cfg.motion_model, tr.ekf_pred, pose_out)
        ekf_new = _tree_where(tr.vo_res.ok | tr.map_ok, ekf_corr, tr.ekf_pred)

    decay = cfg.matcher.degraded_ema_decay
    state_new = state._replace(
        map=m, graph=kb.graph, prev_feat=tr.feat, pose=pose_out,
        pose_smooth=pose_smooth_out,
        last_kf_idx=kf_ring.to(torch.int32) if is_kf else state.last_kf_idx,
        last_kf_pose=kf_pose_after if is_kf else state.last_kf_pose,
        frames_since_kf=(torch.zeros_like(state.frames_since_kf) if is_kf
                         else state.frames_since_kf + 1),
        frame_idx=state.frame_idx + 1,
        kf_sig=kb.kf_sig, sig_valid=kb.sig_valid, lc_queue=kb.lc_queue,
        n_lc_edges=kb.n_lc_edges, ekf=ekf_new,
        health=decay * state.health + (1.0 - decay) * tr.first_pass_ratio,
        frames_since_map_ok=torch.where(
            tr.map_ok, torch.zeros_like(state.frames_since_map_ok),
            torch.where(tr.res_map_ok, state.frames_since_map_ok + 1,
                        state.frames_since_map_ok)),
    )
    outs = SlamOutputs(
        pose=pose_smooth_out, vo_ok=tr.vo_res.ok, map_ok=tr.map_ok,
        n_map_matches=tr.gm.n_candidates,
        n_map_inliers=tr.n_matched.to(torch.int32),
        is_keyframe=torch.full((), is_kf, dtype=torch.bool, device=dev),
        ba_ran=tr.flags[1] if is_kf else torch.zeros(
            (), dtype=torch.bool, device=dev),
        chi2=kb.chi2, n_landmarks=torch.sum(m.lm_valid).to(torch.int32),
        anchor_ring=kf_ring.to(torch.int32),
        anchor_seq=take_row(m.kf_seq, kf_ring), anchor_pose=kf_pose_after)
    return state_new, outs


def slam_track(cfg: SlamConfig, state: SlamState, gray, depth, draws: dict,
               gt_pose=None, playback: bool = False) -> Track:
    """The track part of a frame, device work alone (no host read outside
    a ``control.cond`` predicate): detection, the VO prediction, guided map
    matching with its retry ladder, the correction gate, and the keyframe
    and BA decisions as device flags."""
    dev = state.pose.device
    m0 = state.map
    L = m0.capacity

    with timing.stage("detect"):
        feat = detect_and_describe(cfg, gray, depth)
    N = feat.capacity
    obs_dirs = _obs_dirs(cfg, gray, depth, feat)

    # ---- 1. frame-to-frame VO prediction --------------------------------
    ekf_pred = state.ekf
    if playback:
        degraded = torch.zeros((), dtype=torch.bool, device=dev)
        vo_res = vo_mod.VOStepResult(
            se3.identity(device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.ones((), dtype=torch.float32, device=dev),
            torch.ones((), dtype=torch.bool, device=dev))
        pose_pred = gt_pose
    else:
        degraded = state.health < cfg.matcher.degraded_health_ratio
        vo_res = vo_mod.vo_step(cfg, state.prev_feat, feat, u=draws["vo"],
                                force_retry=degraded,
                                u_retry=draws.get("vo_retry"))
        pose_pred = se3.compose(state.pose, vo_res.rel_pose)
    if cfg.motion_model.enabled and not playback:
        # where VO failed, the EKF's constant-velocity prediction replaces
        # the dead-stop prior of the identity increment
        ekf_pred = ekf_mod.predict(cfg.motion_model, state.ekf, 1.0)
        pose_pred = torch.where(vo_res.ok, pose_pred,
                                ekf_mod.predicted_pose(ekf_pred))

    # ---- 2. guided map matching + absolute-pose RANSAC, retry ladder ----
    def run_guided(scale, u, hamming_slack=0.0, thr_scale=1.0):
        rcfg = vo_mod.widened_ransac(cfg.ransac, thr_scale)
        if cfg.matcher.max_mates > 1:
            # multi-mate band acceptance: every landmark contributes up to
            # max_mates candidate pairs and RANSAC arbitrates
            with timing.stage("guided"):
                pr = fm.guided_match_pairs(cfg, m0, pose_pred, feat,
                                           radius_scale=scale,
                                           hamming_slack=hamming_slack)
            fi = pr.feat_idx.long()
            lm = pr.lm_idx.long()
            p_s = feat.xyz[fi]                                    # (P, 3)
            info_s = _full_obs_info(cfg, feat.uv_undist[fi], p_s,
                                    _rows(obs_dirs, fi))
            res_c = ransac_mod.estimate(rcfg, cfg.camera, p_s, m0.lm_pos[lm],
                                        pr.valid, u=u, info=info_s)
            inl = res_c.inliers & pr.valid
            i32 = dict(dtype=torch.int32, device=dev)
            # off entries point at landmark 0 with a neutral value; amax /
            # amin over duplicates is deterministic
            inliers_L = torch.zeros((L,), **i32).scatter_reduce(
                0, lm, inl.to(torch.int32), "amax") > 0
            inf = torch.full_like(pr.dist, np.inf)
            # representative mate per landmark: its best-distance inlier pair
            bestd = torch.full((L,), np.inf, dtype=pr.dist.dtype,
                               device=dev).scatter_reduce(
                0, lm, torch.where(inl, pr.dist, inf), "amin")
            rep = inl & (pr.dist == bestd[lm])
            fidx_L = torch.full((L,), -1, **i32).scatter_reduce(
                0, lm, torch.where(rep, pr.feat_idx,
                                   torch.full_like(pr.feat_idx, -1)), "amax")
            valid_L = torch.zeros((L,), **i32).scatter_reduce(
                0, lm, pr.valid.to(torch.int32), "amax") > 0
            gm_s = fm.GuidedMatchResult(fidx_L, bestd, valid_L,
                                        pr.n_candidates)
            return gm_s, res_c._replace(inliers=inliers_L)
        with timing.stage("guided"):
            gm_s = fm.guided_match(cfg, m0, pose_pred, feat,
                                   radius_scale=scale,
                                   hamming_slack=hamming_slack)
        # compact the matched landmarks to the feature capacity
        sel = nonzero_fixed(gm_s.valid, N, -1)
        on = sel >= 0
        safe_lm = torch.clamp(sel, min=0)
        idx_s = torch.clamp(gm_s.feat_idx[safe_lm], 0, N - 1).long()
        p_s = feat.xyz[idx_s]
        # per-match sensor information feeds the Mahalanobis error model
        info_s = _full_obs_info(cfg, feat.uv_undist[idx_s], p_s,
                                _rows(obs_dirs, idx_s))
        res_c = ransac_mod.estimate(rcfg, cfg.camera, p_s, m0.lm_pos[safe_lm],
                                    on, u=u, info=info_s)
        inliers_L = set_rows(torch.zeros((L,), dtype=torch.bool, device=dev),
                             torch.where(on, sel, torch.full_like(sel, L)),
                             res_c.inliers & on)
        return gm_s, res_c._replace(inliers=inliers_L)

    gm, res_map = run_guided(1.0, draws["map"])
    first_pass_ratio = res_map.inlier_ratio
    if cfg.matcher.retries:
        # the ladder's buffers: the widenings write into them
        gm, res_map = control.clone((gm, res_map))
    scale = 1.0
    for attempt in range(cfg.matcher.retries):
        scale *= cfg.matcher.retry_radius_growth
        # the lax.cond of putslam_tpu/models/slam.py:351: widen when the
        # pass failed, the frame is degraded or the inlier ratio is low, and
        # adopt the widened pass only when the strict one failed outright,
        # each widening relaxing the Hamming gate and the RANSAC inlier
        # thresholds too
        need_retry = ~res_map.ok | degraded | \
            (res_map.inlier_ratio < cfg.matcher.retry_inlier_ratio)

        def wider(attempt=attempt, scale=scale):
            gm2, res2 = run_guided(
                scale, draws[f"retry{attempt}"],
                hamming_slack=(attempt + 1) * cfg.matcher.retry_hamming_slack,
                thr_scale=cfg.matcher.retry_threshold_growth ** (attempt + 1))
            better = res2.ok & ~res_map.ok
            return (_tree_where(better, gm2, gm),
                    _tree_where(better, res2, res_map))

        control.cond(need_retry, wider, (gm, res_map), name="map_retry")
    p_cam = feat.xyz[torch.clamp(gm.feat_idx, 0, N - 1)]
    # correction sanity gate with the drift budget
    correction = torch.linalg.norm(se3.translation(res_map.pose)
                                   - se3.translation(pose_pred))
    corr_gate = torch.clamp(
        cfg.max_map_correction + cfg.map_correction_growth
        * state.frames_since_map_ok.to(torch.float32),
        max=cfg.max_map_correction_cap)
    strong = (res_map.inlier_ratio >= 0.3) & \
        (res_map.n_inliers >= 2 * cfg.ransac.minimal_num_matches)
    map_ok = res_map.ok & ((correction < cfg.max_map_correction)
                           | ((correction < corr_gate) & strong))
    pose_new = torch.where(map_ok, res_map.pose, pose_pred)
    matched_lm = gm.valid & res_map.inliers & map_ok

    # ---- 3. keyframe decision, and the BA cadence it leads to -----------
    gm_matched = gm._replace(valid=matched_lm)
    covis = fm.covisibility_ratio(gm_matched, m0, m0.n_kf - 1)
    n_matched = torch.sum(matched_lm)
    is_kf = (((covis < cfg.map.covisibility_keyframe)
              | (n_matched < cfg.map.min_keyframe_matches))
             & (state.frames_since_kf >= cfg.map.min_frames_between_keyframes)
             & (vo_res.ok | map_ok))
    n_kf_new = m0.n_kf + 1
    do_ba = is_kf & (torch.remainder(
        n_kf_new, cfg.backend.optimize_every_n_frames) == 0) & (n_kf_new > 2)
    return Track(feat, obs_dirs, vo_res, ekf_pred, pose_new, gm_matched,
                 p_cam, covis, n_matched, map_ok, res_map.ok,
                 first_pass_ratio, torch.stack([is_kf, do_ba]))


def slam_tail(cfg: SlamConfig, state: SlamState, tr: Track, draws: dict,
              playback: bool = False):
    """The end of a frame that is no keyframe: the loop-closure pop and
    verification, the re-anchor, smoothing, EKF and the new state. Returns
    (state, outputs)."""
    g, lc_queue, n_lc = state.graph, state.lc_queue, state.n_lc_edges
    if cfg.loop_closure.enabled:
        g, lc_queue, n_lc = _lc_pop_verify(cfg, state.map, g, lc_queue, n_lc,
                                           draws["lc"])
    chi2 = torch.zeros((cfg.backend.gn_iterations,), dtype=torch.float32,
                       device=state.pose.device)
    return _finish(cfg, state, tr,
                   KeyframeUpdate(state.map, g, state.kf_sig, state.sig_valid,
                                  lc_queue, n_lc, chi2),
                   is_kf=False, playback=playback)


def slam_keyframe(cfg: SlamConfig, state: SlamState, tr: Track,
                  draws: dict) -> KeyframeUpdate:
    """A keyframe's bookkeeping: the keyframe and its landmarks into the
    map, its observations and odometry edge into the graph, its
    loop-closure signature, scores and candidates, then the pop and
    verification (the edge enters the graph before the BA)."""
    dev = state.pose.device
    m0, feat, gm = state.map, tr.feat, tr.gm
    L = m0.capacity
    N = feat.capacity
    K = m0.kf_pose.shape[0]
    kf_seq_new = m0.n_kf
    kf_idx_new = torch.remainder(m0.n_kf, K)
    matched_lm = gm.valid

    m, _ = fm.add_keyframe(cfg, m0, tr.pose_new, tr.covis)
    m = fm.update_matched_landmarks(cfg, m, tr.pose_new, feat, gm, kf_seq_new)
    fidx = torch.clamp(gm.feat_idx, 0, N - 1).long()
    feat_matched = torch.zeros((N,), dtype=torch.int32, device=dev)
    feat_matched.index_add_(0, fidx, matched_lm.to(torch.int32))
    want_provision = (
        (gm.n_candidates < cfg.map.add_features_when_map_size_less_than)
        | (tr.n_matched < cfg.map.add_features_when_measurements_less_than)
    ) & (torch.sum(m.lm_valid)
         < cfg.map.add_no_features_when_map_size_greater_than)
    m = fm.add_landmarks(cfg, m, tr.pose_new, feat,
                         (feat_matched > 0) | ~want_provision, kf_seq_new)
    g = graph_mod.reclaim_observation_slots(state.graph, m.lm_gen, m.kf_gen)
    g = graph_mod.add_observations(
        g, kf_idx_new.expand(L),
        torch.arange(L, dtype=torch.int32, device=dev), tr.p_cam,
        torch.full((L,), _obs_info(cfg), dtype=torch.float32, device=dev),
        matched_lm, gen=m.lm_gen,
        kf_gen=take_row(m.kf_gen, kf_idx_new).expand(L),
        info=_full_obs_info(cfg, feat.uv_undist[fidx], tr.p_cam,
                            _rows(tr.obs_dirs, fidx)))
    rel_kf = se3.relative(state.last_kf_pose, tr.pose_new)
    add_pp = (tr.n_matched < cfg.map.max_measurements_pose_to_pose) \
        if cfg.map.add_pose_to_pose_edges else \
        torch.zeros((), dtype=torch.bool, device=dev)
    prev_ring = torch.remainder(state.last_kf_idx, K)
    g = graph_mod.add_pose_pose(
        g, prev_ring, kf_idx_new, rel_kf,
        torch.full((), 100.0, device=dev), add_pp,
        gen_i=take_row(m.kf_gen, prev_ring),
        gen_j=take_row(m.kf_gen, kf_idx_new))

    kf_sig, sig_valid = state.kf_sig, state.sig_valid
    lc_queue, n_lc = state.lc_queue, state.n_lc_edges
    if cfg.loop_closure.enabled:
        lc = cfg.loop_closure
        sig = bow.signature(bow.make_vocab(lc.vocab_size, dev), feat.desc,
                            feat.valid)
        # the slot this keyframe recycles still holds the evicted
        # keyframe's signature: it takes no part in the scoring
        at = kf_idx_new.reshape(1)
        scores = bow.score_against(kf_sig, sig,
                                   set_rows(sig_valid, at, False))
        lc_queue = bow.push_candidates(lc_queue, kf_idx_new, scores,
                                       m.kf_seq, m.n_kf, lc.tail_skip,
                                       lc.min_probability)
        kf_sig = set_rows(kf_sig, at, sig[None])
        sig_valid = set_rows(sig_valid, at, True)
        g, lc_queue, n_lc = _lc_pop_verify(cfg, m, g, lc_queue, n_lc,
                                           draws["lc"])
    chi2 = torch.zeros((cfg.backend.gn_iterations,), dtype=torch.float32,
                       device=dev)
    return KeyframeUpdate(m, g, kf_sig, sig_valid, lc_queue, n_lc, chi2)


def bundle_adjust(cfg: SlamConfig, m: fm.MapState, g: graph_mod.GraphState):
    """The periodic windowed BA of a keyframe frame (its chi² stop test is
    a ``control.cond`` per Gauss-Newton iteration). Returns (kf_pose,
    lm_pos, obs_valid, chi2)."""
    window = cfg.map.max_frames_window
    if 0 < cfg.backend.ba_window < cfg.map.max_keyframes:
        if cfg.backend.ba_window < window:
            warnings.warn(
                f"backend.ba_window={cfg.backend.ba_window} clamps the "
                f"configured map.max_frames_window={window}: keyframes "
                f"beyond the solver's compaction capacity are frozen "
                f"in-loop. Raise backend.ba_window for full parity.",
                stacklevel=2)
        window = min(window, cfg.backend.ba_window)
    slot0 = torch.arange(m.kf_valid.shape[0], device=m.kf_valid.device) == 0
    fixed = fm.active_window_fixed(m, window) | slot0
    res = opt_mod.optimize_graph(
        cfg.backend, m.kf_pose, m.kf_valid, m.lm_pos, m.lm_valid, g, fixed,
        lm_gen=m.lm_gen, kf_gen=m.kf_gen, cam=cfg.camera)
    g = graph_mod.prune_observations(
        g, res.obs_sq_err > cfg.backend.chi2_prune_threshold)
    return res.kf_pose, res.lm_pos, g.obs_valid, res.chi2


def slam_finish(cfg: SlamConfig, state: SlamState, tr: Track,
                kb: KeyframeUpdate, playback: bool = False):
    """The end of a keyframe frame: compression, re-anchor, smoothing, EKF
    and the new state. Returns (state, outputs)."""
    return _finish(cfg, state, tr, kb, is_kf=True, playback=playback)


def _ba_targets(kb: KeyframeUpdate):
    """The tensors of a keyframe update that its bundle adjustment sets."""
    return kb.map.kf_pose, kb.map.lm_pos, kb.graph.obs_valid, kb.chi2


def read_flags(tr: Track):
    """The eager frame's one host read: (is_keyframe, run_ba) as Python
    bools."""
    is_kf, do_ba = tr.flags.tolist()
    return is_kf, do_ba


def slam_frame(cfg: SlamConfig, state: SlamState, gray, depth, draws: dict,
               out, gt_pose=None, playback: bool = False) -> Track:
    """One frame as the JAX step runs it, every branch a ``control.cond``:
    the track part, then IF(not a keyframe){``slam_tail``} and
    IF(keyframe){``slam_keyframe`` → IF(run_ba){``bundle_adjust``} →
    ``slam_finish``} (``putslam_tpu/models/slam.py:447`` and ``:539``),
    each writing the frame's end into ``out`` = (state, SlamOutputs)
    buffers. ``out`` may be ``state`` itself: the keyframe branch reads
    ``state`` only where the tail did not run. The parts are the flight
    recorder's stages ``track`` (``detect`` inside it), ``tail``,
    ``keyframe`` and ``ba`` (``utils/timing.py``). Returns the Track."""
    with timing.stage("track"):
        tr = slam_track(cfg, state, gray, depth, draws, gt_pose, playback)
    is_kf, do_ba = tr.flags[0], tr.flags[1]
    control.cond(~is_kf, lambda: slam_tail(cfg, state, tr, draws, playback),
                 out, name="tail")

    def keyframe():
        kb = slam_keyframe(cfg, state, tr, draws)
        control.cond(do_ba, lambda: bundle_adjust(cfg, kb.map, kb.graph),
                     _ba_targets(kb), name="ba")
        return slam_finish(cfg, state, tr, kb, playback)

    control.cond(is_kf, keyframe, out, name="keyframe")
    return tr


def slam_step(cfg: SlamConfig, state: SlamState, gray, depth,
              draws: Optional[dict] = None,
              generator: Optional[torch.Generator] = None,
              gt_pose=None, playback: bool = False):
    """One frame, eagerly. Returns (state', SlamOutputs).

    The track part runs on the device alone (its ``control.cond``s masked);
    one packed host read of [is_keyframe, run_ba] decides the rest: a frame
    that is no keyframe runs ``slam_tail``, a keyframe the bookkeeping, the
    BA on its cadence and the finish. ``compiled.SlamGraphs`` replays
    ``slam_frame``, the same parts with the read made by the card.

    ``playback`` (``putslam_tpu/models/slam.py:214-248``): ``gt_pose`` is
    the pose prediction, no VO runs (its result is the constant identity /
    ok), the emitted pose is not smoothed and the EKF is left alone."""
    dev = state.pose.device
    if draws is None:
        draws = frame_draws(cfg, generator, dev, playback)
    if playback:
        gt_pose = as_tensor(gt_pose, dev, torch.float32)
    tr = slam_track(cfg, state, gray, depth, draws, gt_pose, playback)
    is_kf, do_ba = read_flags(tr)
    if not is_kf:
        return slam_tail(cfg, state, tr, draws, playback)
    kb = slam_keyframe(cfg, state, tr, draws)
    if do_ba:
        kf_pose, lm_pos, obs_valid, chi2 = bundle_adjust(cfg, kb.map,
                                                         kb.graph)
        kb = kb._replace(map=kb.map._replace(kf_pose=kf_pose, lm_pos=lm_pos),
                         graph=kb.graph._replace(obs_valid=obs_valid),
                         chi2=chi2)
    return slam_finish(cfg, state, tr, kb, playback)


def _stack_outputs(outs):
    return SlamOutputs(*(torch.stack(x) for x in zip(*outs)))


def slam_sequence(cfg: SlamConfig, state: SlamState, grays, depths,
                  draws=None, generator: Optional[torch.Generator] = None,
                  graph: Optional[bool] = None):
    """Run ``slam_step`` over stacked frames (T, H, W). ``draws``: optional
    per-frame list of draw mappings. ``graph``: replay the step from CUDA
    graphs (``models/compiled.py``); None is on for a CUDA state, off
    elsewhere. Returns (state, stacked outputs)."""
    if use_graphs(graph, state.pose.device):
        from putslam_tpu_torch.models import compiled

        return compiled.run_sequence(cfg, state, grays, depths, draws=draws,
                                     generator=generator)
    outs = []
    for i in range(grays.shape[0]):
        state, o = slam_step(cfg, state, grays[i], depths[i],
                             draws=None if draws is None else draws[i],
                             generator=generator)
        outs.append(o)
    return state, _stack_outputs(outs)


def slam_sequence_playback(cfg: SlamConfig, state: SlamState, grays, depths,
                           gt_poses, draws=None,
                           generator: Optional[torch.Generator] = None,
                           graph: Optional[bool] = None):
    """Playback over stacked frames: the given poses drive the map and the
    backend (``putslam_tpu/models/slam.py:626``). ``graph`` as in
    ``slam_sequence``. Returns (state, stacked outputs)."""
    if use_graphs(graph, state.pose.device):
        from putslam_tpu_torch.models import compiled

        return compiled.run_sequence(cfg, state, grays, depths, draws=draws,
                                     generator=generator, gt_poses=gt_poses)
    outs = []
    for i in range(grays.shape[0]):
        state, o = slam_step(cfg, state, grays[i], depths[i],
                             draws=None if draws is None else draws[i],
                             generator=generator, gt_pose=gt_poses[i],
                             playback=True)
        outs.append(o)
    return state, _stack_outputs(outs)


def run_playback(cfg: SlamConfig, grays, depths, gt_poses, seed: int = 0,
                 device="cuda", graph: Optional[bool] = None):
    """Host wrapper of the playback mode
    (``putslam_tpu/models/slam.py:636``). Returns (poses (T, 7) numpy,
    outputs (numpy), final state). ``graph`` as in ``slam_sequence``."""
    check_config(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    g, d = _to_device_float(cfg, grays, depths, dev)
    gt = as_tensor(gt_poses, dev, torch.float32)
    state = slam_init(cfg, g[0], d[0], gt[0], device=dev)
    state, outs = slam_sequence_playback(cfg, state, g[1:], d[1:], gt[1:],
                                         generator=gen, graph=graph)
    outs = _outputs_to_numpy(outs)
    poses = np.concatenate([gt[0].cpu().numpy()[None], outs.pose], axis=0)
    return poses, outs, state


def _to_device_float(cfg: SlamConfig, g, d, dev):
    """Frames to the device as float32; uint8 gray / uint16 depth (the PNG
    wire formats) cross the bus as they are and are scaled on the device
    (``putslam_tpu/models/slam.py:650``). ``torch.uint16`` has few operators:
    the counts travel as their int16 bit pattern and are widened with a
    mask, so 32768 and above, 65535 included, keep their value."""
    g = as_tensor(g, dev)
    if g.dtype == torch.uint8:
        g = g.to(torch.float32) / 255.0
    if not torch.is_tensor(d):
        d = torch.from_numpy(np.array(d))
    counts16 = d.dtype == torch.uint16
    if counts16:
        d = d.view(torch.int16)
    d = d.to(dev)
    if counts16:
        d = (d.to(torch.int32) & 0xFFFF).to(torch.float32) \
            / cfg.camera.depth_image_scale
    elif not d.is_floating_point():
        d = d.to(torch.float32) / cfg.camera.depth_image_scale
    return g.to(torch.float32), d.to(torch.float32)


def _outputs_to_numpy(outs: SlamOutputs) -> SlamOutputs:
    return SlamOutputs(*(x.cpu().numpy() for x in outs))


def _run_slam(cfg: SlamConfig, grays, depths, init_pose, seed: int,
              chunk_size: int, device, archive, graph: Optional[bool]):
    """``run_slam`` with its outputs left on the device: (initial pose (7,),
    outputs (T - 1, ...), final state)."""
    check_config(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    T = len(grays)
    ip = se3.identity(device=dev) if init_pose is None else as_tensor(
        init_pose, dev, torch.float32)
    g0, d0 = _to_device_float(cfg, grays[0], depths[0], dev)
    state = slam_init(cfg, g0, d0, ip, device=dev)
    chunk = chunk_size if chunk_size and T - 1 > chunk_size else max(T - 1, 1)
    outs_chunks = []
    for s in range(1, T, chunk):
        e = min(s + chunk, T)
        gc, dc = _to_device_float(cfg, grays[s:e], depths[s:e], dev)
        if chunk_size and e - s < chunk:
            pad = chunk - (e - s)
            gc = torch.cat([gc, gc[-1:].expand(pad, -1, -1)])
            dc = torch.cat([dc, dc[-1:].expand(pad, -1, -1)])
        state, outs = slam_sequence(cfg, state, gc, dc, generator=gen,
                                    graph=graph)
        outs_chunks.append(outs)
        if archive is not None:
            archive.absorb(state)
    outs_all = SlamOutputs(*(torch.cat(xs)[:T - 1]
                             for xs in zip(*outs_chunks)))
    return ip, outs_all, state


def run_slam(cfg: SlamConfig, grays, depths, init_pose=None, seed: int = 0,
             chunk_size: int = 0, device="cuda", archive=None,
             graph: Optional[bool] = None):
    """Returns (poses (T, 7) numpy, outputs (numpy), final state). ``graph``
    as in ``slam_sequence``: on a CUDA device each frame is replayed from
    CUDA graphs unless it is False.

    ``chunk_size`` > 0 moves the sequence to the device in blocks of that
    many frames; the tail block is padded with copies of its last frame and
    the padded steps are trimmed from the outputs, as the JAX package does
    (static frames give identity VO and no keyframes).

    ``archive``: a ``slam_map.archive.MapArchive`` that absorbs the state
    after every block, the last included
    (``putslam_tpu/models/slam.py:663-716``), so that history the rings
    evict survives for the offline global bundle adjustment. A block must
    append fewer keyframes and edges than the rings hold."""
    ip, outs, state = _run_slam(cfg, grays, depths, init_pose, seed,
                                chunk_size, device, archive, graph)
    outs = _outputs_to_numpy(outs)
    poses = np.concatenate([ip.cpu().numpy()[None], outs.pose], axis=0)
    return poses, outs, state


def _polish(cfg: SlamConfig, m: fm.MapState, g: graph_mod.GraphState,
            solve):
    """The end-of-run polish of both finalizes: free every keyframe but the
    oldest (gauge), drop landmarks with fewer than ``final_min_obs``
    observations, solve, chi²-prune, solve again, then repair the
    trajectory. ``solve(bcfg, kf_pose, lm_pos, lm_valid, g, fixed)``
    returns (kf_pose, lm_pos, obs_sq_err, chi2 (iterations,)), or None
    where it refuses the graph. Returns (the polished map or None, the
    graph reached, the chi² of both solves (2, iterations) or None)."""
    bcfg = dataclasses.replace(cfg.backend,
                               gn_iterations=cfg.backend.final_gn_iterations,
                               ba_window=0)
    lm_valid = m.lm_valid & (m.lm_n_obs >= cfg.backend.final_min_obs)
    seqs = torch.where(m.kf_valid, m.kf_seq,
                       torch.full_like(m.kf_seq, np.iinfo(np.int32).max))
    fixed = set_rows(torch.zeros_like(m.kf_valid),
                     torch.argmin(seqs).reshape(1), True)
    kf_pose, lm_pos = m.kf_pose, m.lm_pos
    chi2 = []
    for prune in (True, False):
        res = solve(bcfg, kf_pose, lm_pos, lm_valid, g, fixed)
        if res is None:
            return None, g, None
        kf_pose, lm_pos, sq, c = res
        chi2.append(c)
        if prune:
            g = graph_mod.prune_observations(
                g, sq > cfg.backend.chi2_prune_threshold)
    m = m._replace(kf_pose=kf_pose, lm_pos=lm_pos, lm_valid=lm_valid)
    kf_repaired, _ = check_trajectory(cfg, m, g)
    return m._replace(kf_pose=kf_repaired), g, torch.stack(chi2)


def finalize_map(cfg: SlamConfig, m: fm.MapState, g: graph_mod.GraphState):
    """``finalize`` on a map and graph, as one program
    (``putslam_tpu/models/slam.py:789-831``): release → BA → chi²-prune →
    BA → ``check_trajectory``, no host read but the Gauss-Newton
    iterations' ``control.cond``s, which the caller's branching mode runs
    (an IF node each in ``compiled.FinalizeGraphs``'s capture, a host read
    in ``finalize(graph=False)``). Returns (map, graph, chi² (2,
    final_gn_iterations): each solve's, a stopped iteration repeating the
    last value as ``gauss_newton_mm`` reports it)."""
    def solve(bcfg, kf_pose, lm_pos, lm_valid, g, fixed):
        res = opt_mod.optimize_graph(bcfg, kf_pose, m.kf_valid, lm_pos,
                                     lm_valid, g, fixed, lm_gen=m.lm_gen,
                                     kf_gen=m.kf_gen, cam=cfg.camera)
        return res.kf_pose, res.lm_pos, res.obs_sq_err, res.chi2

    return _polish(cfg, m, g, solve)


def finalize(cfg: SlamConfig, state: SlamState,
             graph: Optional[bool] = None) -> SlamState:
    """Full-graph polish: free every keyframe but the oldest (gauge), drop
    landmarks with fewer than ``final_min_obs`` observations, run a long
    robust BA, chi²-prune, run it again, then repair the trajectory.

    ``graph``: replay it from a CUDA graph (``compiled.FinalizeGraphs``,
    one capture per config and state layout; a capture or replay that
    fails raises); None is on for a CUDA state, off elsewhere. Off, it runs
    eagerly with each Gauss-Newton iteration's stop read on the host. The
    call is the flight recorder's ``finalize`` span."""
    with timing.span("finalize"):
        if use_graphs(graph, state.pose.device):
            from putslam_tpu_torch.models import compiled

            return compiled.finalize_runner(cfg, state).run(state)
        with control.branching("host"):
            m, g, _ = finalize_map(cfg, state.map, state.graph)
        return state._replace(map=m, graph=g)


def finalize_dist(cfg: SlamConfig, state: SlamState, mesh) -> SlamState:
    """``finalize`` with both Gauss-Newton solves run by the
    landmark-sharded BA over ``mesh`` (``parallel/dist_ba.py``;
    ``putslam_tpu/models/slam.py:726-786``): the same release → BA →
    chi²-prune → BA → ``check_trajectory`` contract, the prune signal from
    ``backend/optimize.py::_final_sq_errors``. Every rank calls it with the
    same state. It runs eagerly: each iteration all-reduces over the
    process group, which a CUDA graph does not hold. Where the owner
    partition drops observations (skewed landmark ownership) it warns and
    runs the single-device ``finalize`` on the graph reached, as the
    reference does. ``cfg.map.max_landmarks`` must divide the mesh size."""
    m = state.map
    dropped = []

    def solve(bcfg, kf_pose, lm_pos, lm_valid, g, fixed):
        kf, lm, chi2, overflow = dist_ba.dist_gauss_newton(
            bcfg, mesh, kf_pose, m.kf_valid, lm_pos, lm_valid, g, fixed,
            m.lm_gen, m.kf_gen, cam=cfg.camera)
        if int(overflow) > 0:
            dropped.append(int(overflow))
            return None
        return kf, lm, opt_mod._final_sq_errors(
            bcfg, kf, lm, lm_valid, g, m.lm_gen, m.kf_gen, cfg.camera), chi2

    with control.branching("host"):
        m_out, g, _ = _polish(cfg, m, state.graph, solve)
    if m_out is None:
        warnings.warn(
            f"dist finalize: owner partition dropped {dropped[0]} edges "
            f"(skewed landmark ownership); the single-device finalize runs "
            f"instead", stacklevel=2)
        return finalize(cfg, state._replace(graph=g), graph=False)
    return state._replace(map=m_out, graph=g)


def _prefix_compose(steps):
    """P[i] = steps[0] ∘ steps[1] ∘ … ∘ steps[i] for (n, 7) poses: the
    Hillis–Steele scan, ⌈log₂ n⌉ rounds of batched compositions."""
    d = 1
    while d < steps.shape[0]:
        steps = torch.cat([steps[:d], se3.compose(steps[:-d], steps[d:])])
        d *= 2
    return steps


def check_trajectory(cfg: SlamConfig, m: fm.MapState,
                     g: graph_mod.GraphState):
    """Trajectory repair: walk the keyframes in sequence order; where the
    optimised motion from the previous keyframe contradicts the newest
    odometry edge by more than ``trajectory_repair_threshold`` metres,
    re-compose that keyframe from odometry. Returns (kf_pose', n_repaired),
    both on the device, with no host read.

    The JAX package walks the keyframes with a ``lax.scan``
    (``putslam_tpu/models/slam.py:833-896``), but nothing in its carry
    depends on a repair: the sort puts the valid keyframes first, so each
    one's predecessor in the walk is the slot before it in ``order``, and
    its repair test reads only the optimised poses and the odometry edge.
    So every increment (odometry where repaired, else the optimised one)
    is known at once, and the corrected poses are their prefix product,
    taken in ⌈log₂ K⌉ rounds. The composition is the scan's in another
    association: equal up to float32 rounding."""
    K = m.kf_pose.shape[0]
    thr = cfg.backend.trajectory_repair_threshold
    dev = m.kf_pose.device
    if thr <= 0:
        return m.kf_pose, torch.zeros((), dtype=torch.int32, device=dev)
    E = g.pp_capacity
    is_odo = (g.pp_valid & (m.kf_seq[g.pp_j] == m.kf_seq[g.pp_i] + 1)
              & (g.pp_gen_i == m.kf_gen[g.pp_i])
              & (g.pp_gen_j == m.kf_gen[g.pp_j]))
    # newest odometry edge per successor: min age relative to the cursor
    age = torch.remainder(g.n_pp - 1 - torch.arange(E, device=dev), E)
    key_j = torch.where(is_odo, g.pp_j.long(), torch.full_like(age, K))
    best_age = torch.full((K + 1,), E, dtype=age.dtype, device=dev)
    best_age = best_age.scatter_reduce(
        0, key_j, torch.where(is_odo, age, torch.full_like(age, E)), "amin")
    winner = is_odo & (age == best_age[key_j])
    safe_j = torch.where(winner, g.pp_j.long(), torch.full_like(key_j, K))
    odo_rel = set_rows(se3.identity((K,), device=dev), safe_j, g.pp_rel)
    has_odo = set_rows(torch.zeros((K,), dtype=torch.bool, device=dev),
                       safe_j, winner)

    seqs = torch.where(m.kf_valid, m.kf_seq,
                       torch.full_like(m.kf_seq, np.iinfo(np.int32).max))
    order = torch.sort(seqs, stable=True).indices      # the valid ones first
    T_opt = m.kf_pose[order]
    valid = m.kf_valid[order]
    odo = odo_rel[order]
    rel_opt = se3.relative(torch.cat([T_opt[:1], T_opt[:-1]]), T_opt)
    started = torch.arange(K, device=dev) > 0
    bad = valid & started & has_odo[order] & (torch.linalg.norm(
        se3.translation(rel_opt) - se3.translation(odo), dim=-1) > thr)
    rel_use = torch.where(bad[:, None], odo, rel_opt)
    corr = _prefix_compose(torch.cat([T_opt[:1], rel_use[1:]]))
    kf_pose = set_rows(m.kf_pose, order,
                       torch.where(valid[:, None], corr, T_opt))
    return kf_pose, bad.sum().to(torch.int32)


def reanchor_trajectory(state: SlamState, outs: SlamOutputs):
    """Rebuild the per-frame trajectory on the final optimised keyframes:
    pose = kf_now ∘ (anchor_pose⁻¹ ∘ pose), where the anchor slot still
    holds the same keyframe. Returns (T, 7)."""
    dev = state.map.kf_pose.device
    ring = torch.as_tensor(outs.anchor_ring, device=dev).long()
    pose = torch.as_tensor(outs.pose, device=dev)
    anchor_pose = torch.as_tensor(outs.anchor_pose, device=dev)
    kf_now = state.map.kf_pose[ring]
    still_same = state.map.kf_seq[ring] == torch.as_tensor(outs.anchor_seq,
                                                           device=dev)
    corrected = se3.compose(kf_now, se3.compose(se3.inverse(anchor_pose), pose))
    return torch.where(still_same[:, None], corrected, pose)


def run_slam_global(cfg: SlamConfig, grays, depths, init_pose=None,
                    seed: int = 0, chunk_size: int = 64, device="cuda",
                    graph: Optional[bool] = None, **gba_kw):
    """run_slam with a host map archive, then the offline global bundle
    adjustment over the full archived graph, history the device rings
    evicted included (``putslam_tpu/models/slam.py:913-942``). The per-frame
    trajectory is rebuilt on the polished keyframes:
    pose = polished(anchor_seq) ∘ (anchor_pose⁻¹ ∘ pose). ``graph`` as in
    ``run_slam``, for the frames and for the global BA's window solves.

    Returns (poses_before (T, 7), poses_after (T, 7), outputs, final state,
    archive)."""
    from putslam_tpu_torch.slam_map.archive import (MapArchive,
                                                    global_bundle_adjust)

    archive = MapArchive()
    poses_before, outs, state = run_slam(cfg, grays, depths, init_pose, seed,
                                         chunk_size=chunk_size, device=device,
                                         archive=archive, graph=graph)
    kf_polished = global_bundle_adjust(cfg, archive, device=device,
                                       graph=graph, **gba_kw)
    seqs = outs.anchor_seq
    good = (seqs >= 0) & (seqs < len(kf_polished))
    kf_new = torch.as_tensor(
        kf_polished[np.clip(seqs, 0, max(len(kf_polished) - 1, 0))])
    suffix = se3.compose(se3.inverse(torch.as_tensor(outs.anchor_pose)),
                         torch.as_tensor(outs.pose))
    corrected = se3.compose(kf_new, suffix).numpy()
    poses_after = np.where(good[:, None], corrected, outs.pose)
    poses_after = np.concatenate([poses_before[:1], poses_after], axis=0)
    return poses_before, poses_after, outs, state, archive


def run_slam_final(cfg: SlamConfig, grays, depths, init_pose=None,
                   seed: int = 0, chunk_size: int = 0, device="cuda",
                   graph: Optional[bool] = None):
    """run_slam + finalize + the re-anchored trajectory. Returns
    (poses_before (T, 7), poses_after (T, 7), outputs, final state).
    ``graph`` as in ``run_slam``, for the frames and for ``finalize``. The
    outputs stay on the device until both trajectories are made, and
    cross to the host together at the end."""
    ip, outs, state = _run_slam(cfg, grays, depths, init_pose, seed,
                                chunk_size, device, None, graph)
    state = finalize(cfg, state, graph=graph)
    traj = torch.stack([torch.cat([ip[None], outs.pose]),
                        torch.cat([ip[None], reanchor_trajectory(state, outs)])
                        ]).cpu().numpy()
    return traj[0], traj[1], _outputs_to_numpy(outs), state
