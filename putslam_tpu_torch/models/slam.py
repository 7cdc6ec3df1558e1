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

Where the JAX package branches on device values with ``lax.cond`` (retry,
keyframe bookkeeping, loop-closure verification, BA), this port branches on
the host: a few device → host syncs per frame. ``lax.scan`` is a Python
loop. The JAX package computes the loop-closure signature and scores on
every frame and keeps them on keyframes; the port computes them on
keyframes only.

RANSAC draws come from an explicit ``torch.Generator``, or — for a test
that replays the JAX package's key chain — from ``draws``, a mapping with
one (used_pairs, H) uniform tensor per RANSAC call of the frame: ``vo``
(and ``vo_retry`` with ``matcher.retry_hamming_slack > 0``), ``map``,
``retry0``, ``retry1`` and, with loop closure, ``lc``.

``LCQueue`` (``loopclosure/bow.py``) and ``EKFState`` (``motion/ekf.py``)
are re-exported here.
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
from putslam_tpu_torch.utils.device import as_tensor, resolve_device
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
        gen=m.lm_gen[lm_idx], kf_gen=m.kf_gen[kf_idx].expand(N),
        info=_full_obs_info(cfg, feat.uv_undist, feat.xyz,
                            _obs_dirs(cfg, gray, depth, feat)))
    K = cfg.map.max_keyframes
    V = cfg.loop_closure.vocab_size
    Q = cfg.loop_closure.queue_capacity
    kf_sig = torch.zeros((K, V), dtype=torch.float32, device=dev)
    kf_sig[kf_idx] = bow.signature(bow.make_vocab(V, dev), feat.desc,
                                   feat.valid)
    sig_valid = torch.zeros((K,), dtype=torch.bool, device=dev)
    sig_valid[kf_idx] = True
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


def slam_step(cfg: SlamConfig, state: SlamState, gray, depth,
              draws: Optional[dict] = None,
              generator: Optional[torch.Generator] = None,
              gt_pose=None, playback: bool = False):
    """One frame. Returns (state', SlamOutputs).

    ``playback`` (``putslam_tpu/models/slam.py:214-248``): ``gt_pose`` is
    the pose prediction, no VO runs (its result is the constant identity /
    ok), the emitted pose is not smoothed and the EKF is left alone."""
    dev = state.pose.device
    m0 = state.map
    L = m0.capacity
    K = m0.kf_pose.shape[0]

    def uniforms(name):
        if draws is not None:
            return draws[name]
        return ransac_mod.draw_uniforms(cfg.ransac, generator, dev)

    feat = detect_and_describe(cfg, gray, depth)
    N = feat.capacity
    obs_dirs = _obs_dirs(cfg, gray, depth, feat)

    # ---- 1. frame-to-frame VO prediction --------------------------------
    ekf_pred = state.ekf
    if playback:
        # device scalars, as vo_step returns them: the host branches below
        # read vo_res.ok the same way on every path
        degraded = torch.zeros((), dtype=torch.bool, device=dev)
        vo_res = vo_mod.VOStepResult(
            se3.identity(device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.ones((), dtype=torch.float32, device=dev),
            torch.ones((), dtype=torch.bool, device=dev))
        pose_pred = as_tensor(gt_pose, dev, torch.float32)
    else:
        degraded = state.health < cfg.matcher.degraded_health_ratio
        vo_res = vo_mod.vo_step(
            cfg, state.prev_feat, feat, u=uniforms("vo"), generator=generator,
            force_retry=degraded,
            u_retry=None if draws is None else draws.get("vo_retry"))
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
        gm_s = fm.guided_match(cfg, m0, pose_pred, feat, radius_scale=scale,
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

    gm, res_map = run_guided(1.0, uniforms("map"))
    first_pass_ratio = res_map.inlier_ratio
    scale = 1.0
    for attempt in range(cfg.matcher.retries):
        scale *= cfg.matcher.retry_radius_growth
        need_retry = (~res_map.ok) | degraded | \
            (res_map.inlier_ratio < cfg.matcher.retry_inlier_ratio)
        if bool(need_retry):
            # each widening also relaxes the Hamming gate and the RANSAC
            # inlier thresholds
            gm2, res2 = run_guided(
                scale, uniforms(f"retry{attempt}"),
                hamming_slack=(attempt + 1) * cfg.matcher.retry_hamming_slack,
                thr_scale=cfg.matcher.retry_threshold_growth ** (attempt + 1))
            # rescue only: adopt the widened pass when the strict one failed
            better = res2.ok & ~res_map.ok
            gm = _tree_where(better, gm2, gm)
            res_map = _tree_where(better, res2, res_map)
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

    # ---- 3. keyframe decision -------------------------------------------
    gm_matched = gm._replace(valid=matched_lm)
    covis = fm.covisibility_ratio(gm_matched, m0, m0.n_kf - 1)
    n_matched = torch.sum(matched_lm)
    is_kf_t = (((covis < cfg.map.covisibility_keyframe)
                | (n_matched < cfg.map.min_keyframe_matches))
               & (state.frames_since_kf >= cfg.map.min_frames_between_keyframes)
               & (vo_res.ok | map_ok))
    is_kf = bool(is_kf_t)

    kf_seq_new = m0.n_kf
    kf_idx_new = torch.remainder(m0.n_kf, K)

    # ---- 4. keyframe bookkeeping ----------------------------------------
    m, g = m0, state.graph
    if is_kf:
        m, _ = fm.add_keyframe(cfg, m, pose_new, covis)
        m = fm.update_matched_landmarks(cfg, m, pose_new, feat, gm_matched,
                                        kf_seq_new)
        fidx = torch.clamp(gm.feat_idx, 0, N - 1).long()
        feat_matched = torch.zeros((N,), dtype=torch.int32, device=dev)
        feat_matched.index_add_(0, fidx, matched_lm.to(torch.int32))
        want_provision = (
            (gm.n_candidates < cfg.map.add_features_when_map_size_less_than)
            | (n_matched < cfg.map.add_features_when_measurements_less_than)
        ) & (torch.sum(m.lm_valid)
             < cfg.map.add_no_features_when_map_size_greater_than)
        m = fm.add_landmarks(cfg, m, pose_new, feat,
                             (feat_matched > 0) | ~want_provision, kf_seq_new)
        g = graph_mod.reclaim_observation_slots(g, m.lm_gen, m.kf_gen)
        g = graph_mod.add_observations(
            g, kf_idx_new.expand(L),
            torch.arange(L, dtype=torch.int32, device=dev), p_cam,
            torch.full((L,), _obs_info(cfg), dtype=torch.float32, device=dev),
            matched_lm, gen=m.lm_gen, kf_gen=m.kf_gen[kf_idx_new].expand(L),
            info=_full_obs_info(cfg, feat.uv_undist[fidx], p_cam,
                                _rows(obs_dirs, fidx)))
        rel_kf = se3.relative(state.last_kf_pose, pose_new)
        add_pp = (n_matched < cfg.map.max_measurements_pose_to_pose) \
            if cfg.map.add_pose_to_pose_edges else False
        prev_ring = torch.remainder(state.last_kf_idx, K)
        g = graph_mod.add_pose_pose(
            g, prev_ring, kf_idx_new, rel_kf,
            torch.full((), 100.0, device=dev), add_pp,
            gen_i=m.kf_gen[prev_ring], gen_j=m.kf_gen[kf_idx_new])

    # ---- 4b. loop closure: its edge enters the graph before the BA -------
    kf_sig, sig_valid = state.kf_sig, state.sig_valid
    lc_queue, n_lc = state.lc_queue, state.n_lc_edges
    if cfg.loop_closure.enabled:
        lc = cfg.loop_closure
        if is_kf:
            sig = bow.signature(bow.make_vocab(lc.vocab_size, dev), feat.desc,
                                feat.valid)
            # the slot this keyframe recycles still holds the evicted
            # keyframe's signature: it takes no part in the scoring
            scores = bow.score_against(
                kf_sig, sig, set_rows(sig_valid, kf_idx_new.reshape(1),
                                      False))
            lc_queue = bow.push_candidates(lc_queue, kf_idx_new, scores,
                                           m.kf_seq, m.n_kf, lc.tail_skip,
                                           lc.min_probability)
            kf_sig = set_rows(kf_sig, kf_idx_new.reshape(1), sig[None])
            sig_valid = set_rows(sig_valid, kf_idx_new.reshape(1), True)
        # pop and verify one candidate per frame
        cand_a, cand_b, cand_p, lc_queue = bow.pop_best(lc_queue)
        if bool(torch.isfinite(cand_p)):
            ca = torch.clamp(cand_a, min=0)
            cb = torch.clamp(cand_b, min=0)
            vres = lc_verify.verify_candidate(cfg, m, g, ca, cb,
                                              u=uniforms("lc"))
            g = graph_mod.add_pose_pose(
                g, ca, cb, vres.rel_pose, torch.full((), 200.0, device=dev),
                vres.ok, gen_i=take_row(m.kf_gen, ca),
                gen_j=take_row(m.kf_gen, cb))
            n_lc = n_lc + vres.ok.to(torch.int32)

    # ---- 5. periodic bundle adjustment -----------------------------------
    do_ba = is_kf and bool(
        (torch.remainder(m.n_kf, cfg.backend.optimize_every_n_frames) == 0)
        & (m.n_kf > 2))
    if do_ba:
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
        fixed = fm.active_window_fixed(m, window)
        fixed[0] = True
        res = opt_mod.optimize_graph(
            cfg.backend, m.kf_pose, m.kf_valid, m.lm_pos, m.lm_valid, g, fixed,
            lm_gen=m.lm_gen, kf_gen=m.kf_gen, cam=cfg.camera)
        m = m._replace(kf_pose=res.kf_pose, lm_pos=res.lm_pos)
        g = graph_mod.prune_observations(
            g, res.obs_sq_err > cfg.backend.chi2_prune_threshold)
        chi2 = res.chi2
    else:
        chi2 = torch.zeros((cfg.backend.gn_iterations,), dtype=torch.float32,
                           device=dev)
    if is_kf:
        m = fm.compress_map(cfg, m, cfg.map.max_frames_window)

    # ---- re-anchor the live pose on the (possibly moved) last keyframe ---
    if is_kf:
        kf_ring, kf_pose_before = kf_idx_new, pose_new
    else:
        kf_ring = torch.remainder(state.last_kf_idx, K)
        kf_pose_before = state.last_kf_pose
    kf_pose_after = m.kf_pose[kf_ring]
    pose_out = se3.compose(kf_pose_after,
                           se3.compose(se3.inverse(kf_pose_before), pose_new))

    # ---- smoothed output trajectory (cfg.pose_blend_alpha) --------------
    if playback or cfg.pose_blend_alpha >= 1.0:
        pose_smooth_out = pose_out
    else:
        smooth_pred = se3.compose(state.pose_smooth, vo_res.rel_pose)
        delta_s = se3.boxminus(pose_out, smooth_pred)
        mag = torch.linalg.norm(delta_s[:3])
        alpha = torch.where(mag > cfg.pose_blend_snap,
                            torch.ones_like(mag),
                            torch.full_like(mag, cfg.pose_blend_alpha))
        pose_smooth_out = se3.retract(smooth_pred, alpha * delta_s)

    # ---- EKF measurement update with the accepted frame pose; a fully
    # failed frame keeps the prediction, so the velocity coasts -----------
    ekf_new = ekf_pred
    if cfg.motion_model.enabled and not playback:
        ekf_corr = ekf_mod.correct(cfg.motion_model, ekf_pred, pose_out)
        ekf_new = _tree_where(vo_res.ok | map_ok, ekf_corr, ekf_pred)

    decay = cfg.matcher.degraded_ema_decay
    state_new = state._replace(
        map=m, graph=g, prev_feat=feat, pose=pose_out,
        pose_smooth=pose_smooth_out,
        last_kf_idx=kf_idx_new.to(torch.int32) if is_kf else state.last_kf_idx,
        last_kf_pose=kf_pose_after if is_kf else state.last_kf_pose,
        frames_since_kf=(torch.zeros_like(state.frames_since_kf) if is_kf
                         else state.frames_since_kf + 1),
        frame_idx=state.frame_idx + 1,
        kf_sig=kf_sig, sig_valid=sig_valid, lc_queue=lc_queue,
        n_lc_edges=n_lc, ekf=ekf_new,
        health=decay * state.health + (1.0 - decay) * first_pass_ratio,
        frames_since_map_ok=torch.where(
            map_ok, torch.zeros_like(state.frames_since_map_ok),
            torch.where(res_map.ok, state.frames_since_map_ok + 1,
                        state.frames_since_map_ok)),
    )
    outs = SlamOutputs(
        pose=pose_smooth_out, vo_ok=vo_res.ok, map_ok=map_ok,
        n_map_matches=gm.n_candidates,
        n_map_inliers=n_matched.to(torch.int32),
        is_keyframe=is_kf_t, ba_ran=torch.tensor(do_ba, device=dev),
        chi2=chi2, n_landmarks=torch.sum(m.lm_valid).to(torch.int32),
        anchor_ring=kf_ring.to(torch.int32), anchor_seq=m.kf_seq[kf_ring],
        anchor_pose=kf_pose_after)
    return state_new, outs


def _stack_outputs(outs):
    return SlamOutputs(*(torch.stack(x) for x in zip(*outs)))


def slam_sequence(cfg: SlamConfig, state: SlamState, grays, depths,
                  draws=None, generator: Optional[torch.Generator] = None):
    """Run ``slam_step`` over stacked frames (T, H, W). ``draws``: optional
    per-frame list of draw mappings. Returns (state, stacked outputs)."""
    outs = []
    for i in range(grays.shape[0]):
        state, o = slam_step(cfg, state, grays[i], depths[i],
                             draws=None if draws is None else draws[i],
                             generator=generator)
        outs.append(o)
    return state, _stack_outputs(outs)


def slam_sequence_playback(cfg: SlamConfig, state: SlamState, grays, depths,
                           gt_poses, draws=None,
                           generator: Optional[torch.Generator] = None):
    """Playback over stacked frames: the given poses drive the map and the
    backend (``putslam_tpu/models/slam.py:626``). Returns (state, stacked
    outputs)."""
    outs = []
    for i in range(grays.shape[0]):
        state, o = slam_step(cfg, state, grays[i], depths[i],
                             draws=None if draws is None else draws[i],
                             generator=generator, gt_pose=gt_poses[i],
                             playback=True)
        outs.append(o)
    return state, _stack_outputs(outs)


def run_playback(cfg: SlamConfig, grays, depths, gt_poses, seed: int = 0,
                 device="cuda"):
    """Host wrapper of the playback mode
    (``putslam_tpu/models/slam.py:636``). Returns (poses (T, 7) numpy,
    outputs (numpy), final state)."""
    check_config(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    g, d = _to_device_float(cfg, grays, depths, dev)
    gt = as_tensor(gt_poses, dev, torch.float32)
    state = slam_init(cfg, g[0], d[0], gt[0], device=dev)
    state, outs = slam_sequence_playback(cfg, state, g[1:], d[1:], gt[1:],
                                         generator=gen)
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


def run_slam(cfg: SlamConfig, grays, depths, init_pose=None, seed: int = 0,
             chunk_size: int = 0, device="cuda", archive=None):
    """Returns (poses (T, 7) numpy, outputs (numpy), final state).

    ``chunk_size`` > 0 moves the sequence to the device in blocks of that
    many frames; the tail block is padded with copies of its last frame and
    the padded steps are trimmed from the outputs, as the JAX package does
    (static frames give identity VO and no keyframes).

    ``archive``: a ``slam_map.archive.MapArchive`` that absorbs the state
    after every block, the last included
    (``putslam_tpu/models/slam.py:663-716``), so that history the rings
    evict survives for the offline global bundle adjustment. A block must
    append fewer keyframes and edges than the rings hold."""
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
        state, outs = slam_sequence(cfg, state, gc, dc, generator=gen)
        outs_chunks.append(_outputs_to_numpy(outs))
        if archive is not None:
            archive.absorb(state)
    outs_all = SlamOutputs(*(np.concatenate(xs)[:T - 1]
                             for xs in zip(*outs_chunks)))
    poses = np.concatenate([ip.cpu().numpy()[None], outs_all.pose], axis=0)
    return poses, outs_all, state


def _polish(cfg: SlamConfig, state: SlamState, solve):
    """The end-of-run polish of both finalizes: free every keyframe but the
    oldest (gauge), drop landmarks with fewer than ``final_min_obs``
    observations, solve, chi²-prune, solve again, then repair the
    trajectory. ``solve(bcfg, kf_pose, lm_pos, lm_valid, g, fixed)``
    returns (kf_pose, lm_pos, obs_sq_err), or None where it refuses the
    graph. Returns (the polished state or None, the graph reached)."""
    m, g = state.map, state.graph
    bcfg = dataclasses.replace(cfg.backend,
                               gn_iterations=cfg.backend.final_gn_iterations,
                               ba_window=0)
    lm_valid = m.lm_valid & (m.lm_n_obs >= cfg.backend.final_min_obs)
    seqs = torch.where(m.kf_valid, m.kf_seq,
                       torch.full_like(m.kf_seq, np.iinfo(np.int32).max))
    fixed = set_rows(torch.zeros_like(m.kf_valid),
                     torch.argmin(seqs).reshape(1), True)
    kf_pose, lm_pos = m.kf_pose, m.lm_pos
    for prune in (True, False):
        res = solve(bcfg, kf_pose, lm_pos, lm_valid, g, fixed)
        if res is None:
            return None, g
        kf_pose, lm_pos, sq = res
        if prune:
            g = graph_mod.prune_observations(
                g, sq > cfg.backend.chi2_prune_threshold)
    m = m._replace(kf_pose=kf_pose, lm_pos=lm_pos, lm_valid=lm_valid)
    kf_repaired, _ = check_trajectory(cfg, m, g)
    return state._replace(map=m._replace(kf_pose=kf_repaired), graph=g), g


def finalize(cfg: SlamConfig, state: SlamState) -> SlamState:
    """Full-graph polish: free every keyframe but the oldest (gauge), drop
    landmarks with fewer than ``final_min_obs`` observations, run a long
    robust BA, chi²-prune, run it again, then repair the trajectory."""
    m = state.map

    def solve(bcfg, kf_pose, lm_pos, lm_valid, g, fixed):
        res = opt_mod.optimize_graph(bcfg, kf_pose, m.kf_valid, lm_pos,
                                     lm_valid, g, fixed, lm_gen=m.lm_gen,
                                     kf_gen=m.kf_gen, cam=cfg.camera)
        return res.kf_pose, res.lm_pos, res.obs_sq_err

    return _polish(cfg, state, solve)[0]


def finalize_dist(cfg: SlamConfig, state: SlamState, mesh) -> SlamState:
    """``finalize`` with both Gauss-Newton solves run by the
    landmark-sharded BA over ``mesh`` (``parallel/dist_ba.py``;
    ``putslam_tpu/models/slam.py:726-786``): the same release → BA →
    chi²-prune → BA → ``check_trajectory`` contract, the prune signal from
    ``backend/optimize.py::_final_sq_errors``. Every rank calls it with the
    same state. Where the owner partition drops observations (skewed
    landmark ownership) it warns and runs the single-device ``finalize`` on
    the graph reached, as the reference does. ``cfg.map.max_landmarks``
    must divide the mesh size."""
    m = state.map
    dropped = []

    def solve(bcfg, kf_pose, lm_pos, lm_valid, g, fixed):
        kf, lm, _, overflow = dist_ba.dist_gauss_newton(
            bcfg, mesh, kf_pose, m.kf_valid, lm_pos, lm_valid, g, fixed,
            m.lm_gen, m.kf_gen, cam=cfg.camera)
        if int(overflow) > 0:
            dropped.append(int(overflow))
            return None
        return kf, lm, opt_mod._final_sq_errors(
            bcfg, kf, lm, lm_valid, g, m.lm_gen, m.kf_gen, cfg.camera)

    out, g = _polish(cfg, state, solve)
    if out is None:
        warnings.warn(
            f"dist finalize: owner partition dropped {dropped[0]} edges "
            f"(skewed landmark ownership); the single-device finalize runs "
            f"instead", stacklevel=2)
        return finalize(cfg, state._replace(graph=g))
    return out


def check_trajectory(cfg: SlamConfig, m: fm.MapState,
                     g: graph_mod.GraphState):
    """Trajectory repair: walk the keyframes in sequence order; where the
    optimised motion from the previous keyframe contradicts the newest
    odometry edge by more than ``trajectory_repair_threshold`` metres,
    re-compose that keyframe from odometry. Returns (kf_pose', n_repaired).

    The walk is a sequential recurrence over K keyframes of tiny pose ops;
    it runs on the host CPU once per run."""
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
    order = torch.sort(seqs, stable=True).indices
    kf_pose = m.kf_pose.cpu()
    kf_valid = m.kf_valid.cpu().tolist()
    odo_rel_h = odo_rel.cpu()
    has_odo_h = has_odo.cpu().tolist()
    prev_corr = prev_opt = se3.identity()
    started = False
    corr, n_bad = [], 0
    for idx in order.cpu().tolist():
        T_opt = kf_pose[idx]
        valid = kf_valid[idx]
        rel_opt = se3.relative(prev_opt, T_opt)
        bad = valid and started and has_odo_h[idx] and bool(torch.linalg.norm(
            se3.translation(rel_opt) - se3.translation(odo_rel_h[idx])) > thr)
        T_corr = se3.compose(prev_corr, odo_rel_h[idx] if bad else rel_opt)
        if valid and not started:
            T_corr = T_opt
        if valid:
            prev_corr, prev_opt, started = T_corr, T_opt, True
        corr.append(T_corr if valid else T_opt)
        n_bad += int(bad)
    out = kf_pose.clone()
    out[order.cpu()] = torch.stack(corr)
    return out.to(dev), torch.tensor(n_bad, dtype=torch.int32, device=dev)


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
                    **gba_kw):
    """run_slam with a host map archive, then the offline global bundle
    adjustment over the full archived graph, history the device rings
    evicted included (``putslam_tpu/models/slam.py:913-942``). The per-frame
    trajectory is rebuilt on the polished keyframes:
    pose = polished(anchor_seq) ∘ (anchor_pose⁻¹ ∘ pose).

    Returns (poses_before (T, 7), poses_after (T, 7), outputs, final state,
    archive)."""
    from putslam_tpu_torch.slam_map.archive import (MapArchive,
                                                    global_bundle_adjust)

    archive = MapArchive()
    poses_before, outs, state = run_slam(cfg, grays, depths, init_pose, seed,
                                         chunk_size=chunk_size, device=device,
                                         archive=archive)
    kf_polished = global_bundle_adjust(cfg, archive, device=device, **gba_kw)
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
                   seed: int = 0, chunk_size: int = 0, device="cuda"):
    """run_slam + finalize + the re-anchored trajectory. Returns
    (poses_before (T, 7), poses_after (T, 7), outputs, final state)."""
    poses_before, outs, state = run_slam(cfg, grays, depths, init_pose, seed,
                                         chunk_size=chunk_size, device=device)
    state = finalize(cfg, state)
    poses_after = np.concatenate(
        [poses_before[:1], reanchor_trajectory(state, outs).cpu().numpy()],
        axis=0)
    return poses_before, poses_after, outs, state
