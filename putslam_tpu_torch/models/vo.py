"""Frame-to-frame visual odometry (VO version 0: detect + match).

Port of ``putslam_tpu/models/vo.py``: detect → describe → Hamming matmul
cross-check matching → lift to 3D → RANSAC, with the translation sanity gate
that turns implausible jumps into the identity increment.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from putslam_tpu_torch.config import SlamConfig
from putslam_tpu_torch.frontend import ransac as ransac_mod
from putslam_tpu_torch.frontend.detector import Features, detect_and_describe
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.ops import matching
from putslam_tpu_torch.utils.device import as_tensor, resolve_device


class VOStepResult(NamedTuple):
    rel_pose: torch.Tensor      # (7,) T with x_prev ≈ T · x_curr
    n_matches: torch.Tensor     # () int32 — valid cross-checked matches
    n_inliers: torch.Tensor     # () int32 — RANSAC inliers
    inlier_ratio: torch.Tensor  # () float32
    ok: torch.Tensor            # () bool — RANSAC accepted and inside the gate


def check_vo_config(cfg: SlamConfig) -> None:
    """Raise for the VO options this port does not implement yet."""
    if cfg.vo_version != 0:
        raise NotImplementedError(
            f"vo_version={cfg.vo_version} (KLT tracking) is not ported yet")
    if cfg.matcher.retry_hamming_slack > 0:
        raise NotImplementedError(
            "matcher.retry_hamming_slack > 0 is not ported yet")
    if cfg.ransac.error_version != 0:
        raise NotImplementedError(
            f"ransac.error_version={cfg.ransac.error_version} is not ported yet")
    if cfg.ransac.quality_tau > 0.0:
        raise NotImplementedError("ransac.quality_tau > 0 is not ported yet")
    if cfg.detector.grid_policy != "subtile":
        raise NotImplementedError(
            f"detector.grid_policy={cfg.detector.grid_policy!r} is not "
            "ported yet")
    if cfg.detector.descriptor != "brief":
        raise NotImplementedError(
            f"detector.descriptor={cfg.detector.descriptor!r} is not ported "
            "yet")


def vo_step(cfg: SlamConfig, prev: Features, curr: Features,
            u: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> VOStepResult:
    """Relative pose of the current frame w.r.t. the previous one:
    T minimising ‖T·xyz_curr − xyz_prev‖ (new_pose = prev_pose ∘ T).
    ``u``: optional RANSAC uniforms, else drawn from ``generator``."""
    dist = matching.hamming_matrix(prev.desc, curr.desc, prev.valid, curr.valid)
    m = matching.mutual_nn(dist, cfg.matcher.max_hamming)
    p = curr.xyz[m.idx_b]
    q = prev.xyz
    valid = m.valid & prev.has_depth & curr.has_depth[m.idx_b]
    res = ransac_mod.estimate(cfg.ransac, cfg.camera, p, q, valid, u=u,
                              generator=generator)
    too_far = torch.linalg.norm(se3.translation(res.pose)) > cfg.max_vo_translation
    rel = torch.where(too_far, se3.identity(dtype=res.pose.dtype,
                                            device=res.pose.device), res.pose)
    return VOStepResult(rel, torch.sum(valid).to(torch.int32), res.n_inliers,
                        res.inlier_ratio, res.ok & ~too_far)


def detect_sequence(cfg: SlamConfig, grays, depths):
    """Detect + describe every frame of a (T, H, W) stack → list of
    Features."""
    return [detect_and_describe(cfg, grays[i], depths[i])
            for i in range(grays.shape[0])]


def vo_sequence(cfg: SlamConfig, grays, depths,
                generator: Optional[torch.Generator] = None, init_pose=None):
    """VO over a stacked (T, H, W) sequence. Returns (poses (T, 7),
    per-step results stacked over T−1 steps)."""
    dev = grays.device
    if init_pose is None:
        init_pose = se3.identity(dtype=grays.dtype, device=dev)
    feats = detect_sequence(cfg, grays, depths)
    steps = [vo_step(cfg, feats[i], feats[i + 1], generator=generator)
             for i in range(len(feats) - 1)]
    poses = [init_pose]
    for st in steps:
        poses.append(se3.compose(poses[-1], st.rel_pose))
    poses = torch.stack(poses)
    poses = se3.make_pose(se3.translation(poses),
                          se3.quat_normalize(se3.rotation_quat(poses)))
    stats = VOStepResult(*(torch.stack(x) for x in zip(*steps))) if steps \
        else None
    return poses, stats


def run_vo(cfg: SlamConfig, grays, depths, seed: int = 0, init_pose=None,
           device="cuda"):
    """Arrays or tensors in, numpy out: (poses (T, 7), stats). Frames are
    moved to ``device``; RANSAC draws from a generator seeded with
    ``seed``."""
    check_vo_config(cfg)
    dev = resolve_device(device)
    g = as_tensor(grays, dev, torch.float32)
    d = as_tensor(depths, dev, torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ip = None if init_pose is None else as_tensor(init_pose, dev,
                                                  torch.float32)
    poses, stats = vo_sequence(cfg, g, d, generator=gen, init_pose=ip)
    return (poses.cpu().numpy(),
            None if stats is None else VOStepResult(
                *(x.cpu().numpy() for x in stats)))
