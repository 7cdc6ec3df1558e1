"""Frame-to-frame visual odometry.

Port of ``putslam_tpu/models/vo.py``. Version 0: detect → describe →
Hamming matmul cross-check matching → lift to 3D → RANSAC, with the
widened-gate rescue of a failed match when ``retry_hamming_slack > 0``.
Version 1
(tracking): pyramidal KLT of the previous frame's features → lift →
RANSAC, refilling lost tracks from a fresh level-0 FAST detection. Both
have the translation sanity gate that turns implausible jumps into the
identity increment.

The tracking refill writes the k-th fresh detection into the k-th free
slot, and sends the unused lanes to a sentinel row. The JAX package sends
them to slot 0 with its old value, so on its CPU backend (last duplicate
write wins) a free slot 0 is never refilled; the port refills it (ROADMAP
Queue 3l).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from putslam_tpu_torch.config import SlamConfig
from putslam_tpu_torch.frontend import ransac as ransac_mod
from putslam_tpu_torch.frontend.detector import Features, detect_and_describe
from putslam_tpu_torch.geometry import camera as camera_mod
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.ops import fast as fast_mod
from putslam_tpu_torch.ops import brief, klt, matching
from putslam_tpu_torch.utils import control
from putslam_tpu_torch.utils.device import (as_tensor, resolve_device,
                                            use_graphs)
from putslam_tpu_torch.utils.indexing import nonzero_fixed, set_rows


class VOStepResult(NamedTuple):
    rel_pose: torch.Tensor      # (7,) T with x_prev ≈ T · x_curr
    n_matches: torch.Tensor     # () int32 — valid cross-checked matches
    n_inliers: torch.Tensor     # () int32 — RANSAC inliers
    inlier_ratio: torch.Tensor  # () float32
    ok: torch.Tensor            # () bool — RANSAC accepted and inside the gate


def check_vo_config(cfg: SlamConfig) -> None:
    """Raise NotImplementedError for a grid policy or descriptor the port
    does not know, ValueError for an unknown RANSAC error model. Every
    ``vo_version`` runs: 1 is tracking, any other value matching, as
    ``putslam_tpu/models/vo.py:278-281`` dispatches."""
    if cfg.ransac.error_version not in (0, 1, 2, 3, 4):
        raise ValueError(
            f"unsupported error_version {cfg.ransac.error_version}")
    if cfg.detector.grid_policy not in fast_mod.GRID_POLICIES:
        raise NotImplementedError(
            f"detector.grid_policy={cfg.detector.grid_policy!r} is not known "
            f"(one of {fast_mod.GRID_POLICIES})")
    if cfg.detector.descriptor not in brief.KINDS:
        raise NotImplementedError(
            f"detector.descriptor={cfg.detector.descriptor!r} is not known "
            f"(one of {brief.KINDS})")


def widened_ransac(rcfg, growth: float):
    """``rcfg`` with its three inlier thresholds scaled by ``growth`` (the
    gate of a retry on a degraded frame)."""
    if growth == 1.0:
        return rcfg
    return dataclasses.replace(
        rcfg,
        inlier_threshold_euclidean=rcfg.inlier_threshold_euclidean * growth,
        inlier_threshold_reprojection=(rcfg.inlier_threshold_reprojection
                                       * growth),
        inlier_threshold_mahalanobis=(rcfg.inlier_threshold_mahalanobis
                                      * growth))


def vo_draw_names(cfg: SlamConfig):
    """The RANSAC calls of one VO step, in the order their uniforms are
    drawn whatever the step decides: ``vo``, then ``vo_retry`` with
    ``matcher.retry_hamming_slack > 0``."""
    return ["vo"] + (["vo_retry"] if cfg.matcher.retry_hamming_slack > 0
                     else [])


def vo_draws(cfg: SlamConfig, generator: Optional[torch.Generator], device,
             out: Optional[dict] = None) -> dict:
    """Every uniform of one VO step (``out``: the buffers of the captured
    step to draw into)."""
    return ransac_mod.draw_named(cfg.ransac, vo_draw_names(cfg), generator,
                                 device, out)


def vo_step(cfg: SlamConfig, prev: Features, curr: Features,
            u: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            force_retry=False,
            u_retry: Optional[torch.Tensor] = None) -> VOStepResult:
    """Relative pose of the current frame w.r.t. the previous one:
    T minimising ‖T·xyz_curr − xyz_prev‖ (new_pose = prev_pose ∘ T).
    ``u``: optional RANSAC uniforms, else drawn from ``generator``.

    With ``matcher.retry_hamming_slack > 0`` a starved match (failed,
    ``force_retry``, or an inlier ratio under ``retry_inlier_ratio``) runs
    once more with the Hamming gate widened by the slack and the RANSAC
    thresholds by ``retry_threshold_growth`` (uniforms ``u_retry``), and the
    second result is adopted only when the strict pass failed outright: the
    ``lax.cond`` of ``putslam_tpu/models/vo.py:94`` as a ``control.cond``.
    A pass it skips is never adopted (a failed strict pass is itself
    starved), so every mode gives the same result."""
    mc = cfg.matcher
    retry = mc.retry_hamming_slack > 0
    dev = prev.xyz.device
    if u is None:
        u = ransac_mod.draw_uniforms(cfg.ransac, generator, dev)
    if retry and u_retry is None:
        u_retry = ransac_mod.draw_uniforms(cfg.ransac, generator, dev)
    dist = matching.hamming_matrix(prev.desc, curr.desc, prev.valid, curr.valid)

    def match_and_estimate(max_hamming, rcfg, uniforms):
        m = matching.mutual_nn(dist, max_hamming)
        p = curr.xyz[m.idx_b]
        valid = m.valid & prev.has_depth & curr.has_depth[m.idx_b]
        res = ransac_mod.estimate(rcfg, cfg.camera, p, prev.xyz, valid,
                                  u=uniforms)
        return torch.sum(valid).to(torch.int32), res

    n_matches, res = match_and_estimate(mc.max_hamming, cfg.ransac, u)
    if retry:
        force = force_retry if torch.is_tensor(force_retry) else torch.full(
            (), bool(force_retry), dtype=torch.bool, device=dev)
        starved = ~res.ok | force | (res.inlier_ratio < mc.retry_inlier_ratio)

        def wider():
            n2, r2 = match_and_estimate(
                mc.max_hamming + mc.retry_hamming_slack,
                widened_ransac(cfg.ransac, mc.retry_threshold_growth),
                u_retry)
            better = r2.ok & ~res.ok
            return (torch.where(better, n2, n_matches),
                    type(res)(*(torch.where(better, a, b)
                                for a, b in zip(r2, res))))

        n_matches, res = control.cond(starved, wider,
                                      control.clone((n_matches, res)),
                                      name="vo_retry")
    too_far = torch.linalg.norm(se3.translation(res.pose)) > cfg.max_vo_translation
    rel = torch.where(too_far, se3.identity(dtype=res.pose.dtype,
                                            device=res.pose.device), res.pose)
    return VOStepResult(rel, n_matches, res.n_inliers, res.inlier_ratio,
                        res.ok & ~too_far)


def detect_sequence(cfg: SlamConfig, grays, depths):
    """Detect + describe every frame of a (T, H, W) stack → list of
    Features."""
    return [detect_and_describe(cfg, grays[i], depths[i])
            for i in range(grays.shape[0])]


def normalise_poses(poses):
    """Unit quaternions on a stacked (T, 7) trajectory."""
    return se3.make_pose(se3.translation(poses),
                         se3.quat_normalize(se3.rotation_quat(poses)))


def vo_sequence(cfg: SlamConfig, grays, depths,
                generator: Optional[torch.Generator] = None, init_pose=None,
                draws=None, graph: Optional[bool] = None):
    """VO over a stacked (T, H, W) sequence. Returns (poses (T, 7),
    per-step results stacked over T−1 steps). ``draws``: optional per-step
    list of RANSAC uniforms. ``graph``: each step detection + ``vo_step``
    replayed from a CUDA graph (``models/compiled.py``); None is on for CUDA
    frames, off elsewhere."""
    dev = grays.device
    if init_pose is None:
        init_pose = se3.identity(dtype=grays.dtype, device=dev)
    if use_graphs(graph, dev):
        from putslam_tpu_torch.models import compiled

        poses, stats = compiled.vo_run_sequence(cfg, grays, depths, init_pose,
                                                draws=draws,
                                                generator=generator)
        return normalise_poses(poses), stats
    feats = detect_sequence(cfg, grays, depths)
    steps = [vo_step(cfg, feats[i], feats[i + 1],
                     u=None if draws is None else draws[i],
                     generator=generator)
             for i in range(len(feats) - 1)]
    poses = [init_pose]
    for st in steps:
        poses.append(se3.compose(poses[-1], st.rel_pose))
    stats = VOStepResult(*(torch.stack(x) for x in zip(*steps))) if steps \
        else None
    return normalise_poses(torch.stack(poses)), stats


# ---------------------------------------------------------------------------
# Tracking-mode VO (vo_version=1): pyramidal KLT instead of detect + match.
# ---------------------------------------------------------------------------


class TrackState(NamedTuple):
    uv: torch.Tensor      # (N, 2) tracked feature positions in ``gray``
    xyz: torch.Tensor     # (N, 3) camera-frame 3D (detection frame's depth)
    valid: torch.Tensor   # (N,) bool
    gray: torch.Tensor    # (H, W) previous frame image


def _detect_for_tracking(cfg: SlamConfig, gray, depth):
    """FAST on level 0 only (one launch of the kernel on a CUDA tensor) and
    the depth lift: (uv (N, 2), xyz (N, 3), valid (N,))."""
    det = cfg.detector
    uv, _, valid = fast_mod.detect(gray, det.fast_threshold, det.nms_radius,
                                   det.grid_rows, det.grid_cols,
                                   det.max_features,
                                   grid_policy=det.grid_policy)
    z = camera_mod.sample_depth(depth, uv)
    xyz = camera_mod.unproject(cfg.camera,
                               camera_mod.undistort_pixels(cfg.camera, uv), z)
    return uv, xyz, valid & camera_mod.depth_valid_mask(cfg.camera, z)


def init_tracking(cfg: SlamConfig, gray, depth) -> TrackState:
    uv, xyz, valid = _detect_for_tracking(cfg, gray, depth)
    return TrackState(uv, xyz, valid, gray)


def vo_step_tracking(cfg: SlamConfig, ts: TrackState, gray, depth,
                     u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """Track the features into ``gray``, estimate the increment by RANSAC
    (x_prev ≈ T · x_curr), and refill lost tracks with fresh detections
    when fewer than ``min_tracked_features`` survive. Detection runs on
    every step; the refill is masked, not skipped. Returns
    (TrackState', VOStepResult)."""
    tc = cfg.tracker
    tr = klt.track(tc, ts.gray, gray, ts.uv, ts.valid)
    if tc.patch_refine:
        wide = dataclasses.replace(tc, win_size=tc.patch_refine_win)
        tr2 = klt.refine_patch_alignment(wide, ts.gray, gray, ts.uv, tr.pts,
                                         tr.valid)
        tr = tr._replace(pts=torch.where(tr2.valid[:, None], tr2.pts, tr.pts))
    z = camera_mod.sample_depth(depth, tr.pts)
    xyz_new = camera_mod.unproject(
        cfg.camera, camera_mod.undistort_pixels(cfg.camera, tr.pts), z)
    valid = tr.valid & camera_mod.depth_valid_mask(cfg.camera, z)

    res = ransac_mod.estimate(cfg.ransac, cfg.camera, xyz_new, ts.xyz, valid,
                              u=u, generator=generator)
    too_far = torch.linalg.norm(se3.translation(res.pose)) > cfg.max_vo_translation
    rel = torch.where(too_far, se3.identity(dtype=res.pose.dtype,
                                            device=res.pose.device), res.pose)

    # refill: the k-th fresh detection (not within 2·nms_radius of a live
    # track) goes to the k-th free slot
    n_tracked = torch.sum(valid)
    need = n_tracked < tc.min_tracked_features
    uv_d, xyz_d, v_d = _detect_for_tracking(cfg, gray, depth)
    N = uv_d.shape[0]
    d2 = torch.sum((uv_d[:, None, :] - tr.pts[None, :, :]) ** 2, dim=-1)
    near = torch.any((d2 < float(cfg.detector.nms_radius * 2) ** 2)
                     & valid[None, :], dim=1)
    free_idx = nonzero_fixed(~valid, N, -1)
    cand_idx = nonzero_fixed(v_d & ~near & need, N, -1)
    okm = (free_idx >= 0) & (cand_idx >= 0)
    slot = torch.where(okm, free_idx, torch.full_like(free_idx, N))
    cidx = torch.clamp(cand_idx, min=0)
    ts_new = TrackState(set_rows(tr.pts, slot, uv_d[cidx]),
                        set_rows(xyz_new, slot, xyz_d[cidx]),
                        set_rows(valid, slot, True), gray)
    return ts_new, VOStepResult(rel, n_tracked.to(torch.int32),
                                res.n_inliers, res.inlier_ratio,
                                res.ok & ~too_far)


def vo_sequence_tracking(cfg: SlamConfig, grays, depths,
                         generator: Optional[torch.Generator] = None,
                         init_pose=None, draws=None,
                         graph: Optional[bool] = None):
    """Tracking VO over a stacked (T, H, W) sequence: (poses (T, 7),
    per-step results stacked over T−1 steps). ``draws``: optional per-step
    list of RANSAC uniforms. ``graph``: each step replayed from a CUDA
    graph (``models/compiled.py``) as ``vo_sequence`` does; None is on for
    CUDA frames, off elsewhere."""
    dev = grays.device
    pose = se3.identity(dtype=grays.dtype, device=dev) if init_pose is None \
        else init_pose
    if use_graphs(graph, dev):
        from putslam_tpu_torch.models import compiled

        return compiled.track_run_sequence(cfg, grays, depths, pose,
                                           draws=draws, generator=generator)
    ts = init_tracking(cfg, grays[0], depths[0])
    poses, steps = [pose], []
    for i in range(1, grays.shape[0]):
        ts, res = vo_step_tracking(
            cfg, ts, grays[i], depths[i],
            u=None if draws is None else draws[i - 1], generator=generator)
        pose = se3.compose(pose, res.rel_pose)
        poses.append(pose)
        steps.append(res)
    stats = VOStepResult(*(torch.stack(x) for x in zip(*steps))) if steps \
        else None
    return torch.stack(poses), stats


def run_vo(cfg: SlamConfig, grays, depths, seed: int = 0, init_pose=None,
           device="cuda", graph: Optional[bool] = None):
    """Arrays or tensors in, numpy out: (poses (T, 7), stats). Frames are
    moved to ``device``; RANSAC draws from a generator seeded with
    ``seed``. Dispatches on ``cfg.vo_version``: 1 is KLT tracking, any
    other value matching (``putslam_tpu/models/vo.py:278-281``); ``graph``
    replays the steps of either from CUDA graphs (None: on for a CUDA
    device)."""
    check_vo_config(cfg)
    dev = resolve_device(device)
    g = as_tensor(grays, dev, torch.float32)
    d = as_tensor(depths, dev, torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ip = None if init_pose is None else as_tensor(init_pose, dev,
                                                  torch.float32)
    if cfg.vo_version == 1:
        poses, stats = vo_sequence_tracking(cfg, g, d, generator=gen,
                                            init_pose=ip, graph=graph)
    else:
        poses, stats = vo_sequence(cfg, g, d, generator=gen, init_pose=ip,
                                   graph=graph)
    return (poses.cpu().numpy(),
            None if stats is None else VOStepResult(
                *(x.cpu().numpy() for x in stats)))
