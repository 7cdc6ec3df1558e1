"""Multi-scale keypoint detection + description + depth lifting (torch).

Port of ``putslam_tpu/frontend/detector.py``: a scale pyramid, FAST + NMS
of all its levels (one launch of the CUDA kernel on the card), then the
keypoint chain (``ops/keypoints.py``): the grid cap per level (subtile or
exact), the sub-pixel refine, the lift of each keypoint to a camera-frame
3D point through undistortion with the depth gate, and every level's
patches as one bfloat16 matrix (one call of its CUDA kernel on the card
for the subtile cap); then one fused descriptor matmul (steered BRIEF or
LDB) over that matrix. Output is a fixed-capacity ``Features`` batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from putslam_tpu_torch.config import SlamConfig
from putslam_tpu_torch.ops import brief, fast_cuda, keypoints


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set."""

    uv: torch.Tensor          # (N, 2) float32 — level-0 pixel coords (distorted)
    uv_undist: torch.Tensor   # (N, 2) float32 — undistorted pixel coords
    xyz: torch.Tensor         # (N, 3) float32 — camera-frame 3D point
    response: torch.Tensor    # (N,)  float32 — detector response
    octave: torch.Tensor      # (N,)  int32  — pyramid level
    angle: torch.Tensor       # (N,)  float32 — orientation (radians)
    desc: torch.Tensor        # (N, 256) int8 ±1 — steered BRIEF
    valid: torch.Tensor       # (N,)  bool — slot holds a detected keypoint
    has_depth: torch.Tensor   # (N,)  bool — valid ∧ depth inside the gate

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def _pyramid_shapes(cfg: SlamConfig):
    H, W = cfg.camera.height, cfg.camera.width
    shapes = []
    for lvl in range(cfg.detector.n_pyramid_levels):
        s = cfg.detector.scale_factor ** lvl
        shapes.append((max(int(round(H / s)), 32), max(int(round(W / s)), 32)))
    return shapes


def _level_budgets(cfg: SlamConfig):
    """Static per-level keypoint budgets summing to max_features."""
    N = cfg.detector.max_features
    L = cfg.detector.n_pyramid_levels
    if L == 1:
        return [N]
    coarse = [max(N // (2 ** (lvl + 1)), 32) for lvl in range(1, L)]
    total_coarse = sum(coarse)
    if total_coarse > N // 2:
        scale = (N // 2) / total_coarse
        coarse = [max(int(b * scale), 16) for b in coarse]
    return [N - sum(coarse)] + coarse


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) antialiased linear resampling weights, computed as
    ``jax.image.resize(..., "linear")`` computes them (triangle kernel
    widened by the downscale factor, columns normalised)."""
    inv_scale = 1.0 / (n_out / n_in)
    f32 = torch.float32
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = torch.abs(sample_f[None, :]
                  - torch.arange(n_in, dtype=f32, device=device)[:, None]) \
        / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(torch.finfo(f32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(gray: torch.Tensor, shape) -> torch.Tensor:
    """Antialiased bilinear downscale of a (H, W) image to ``shape``: the
    separable weight matrices of ``jax.image.resize(..., "linear")``
    applied as two float32 matmuls."""
    H, W = gray.shape
    wy = _resize_weights(H, shape[0], gray.device)
    wx = _resize_weights(W, shape[1], gray.device)
    return (wy.T @ gray) @ wx


def detect_and_describe(cfg: SlamConfig, gray: torch.Tensor,
                        depth: torch.Tensor) -> Features:
    """gray (H, W) float32 [0, 1]; depth (H, W) float32 metres (0 invalid).
    Runs on the tensors' device. Returns ``Features`` with capacity
    cfg.detector.max_features."""
    det = cfg.detector
    cam = cfg.camera
    if det.descriptor not in brief.KINDS:
        raise NotImplementedError(
            f"detector.descriptor={det.descriptor!r} is not known "
            f"(one of {brief.KINDS})")
    budgets = _level_budgets(cfg)

    # every level depends on ``gray`` alone, so the pyramid is built first
    # and FAST + NMS of all its levels is one call (one launch on the card)
    shapes = _pyramid_shapes(cfg)
    levels = [gray.contiguous()] + [resize(gray, s).contiguous()
                                    for s in shapes[1:]]
    maps = fast_cuda.fast_score_nms_levels(levels, det.fast_threshold,
                                           det.nms_radius)
    # the keypoint chain: the kernel on the card for the subtile cap, the
    # ATen chain on the CPU and for the exact per-cell cap
    kp = keypoints.chain(det, cam, shapes, budgets, levels, maps,
                         depth.contiguous())
    desc, ang = brief.describe_patches(kp.patches, kind=det.descriptor)
    return Features(
        uv=kp.uv,
        uv_undist=kp.uv_undist,
        xyz=kp.xyz,
        response=kp.response,
        octave=kp.octave,
        angle=ang,
        desc=torch.where(kp.valid[:, None], desc, torch.zeros_like(desc)),
        valid=kp.valid,
        has_depth=kp.has_depth,
    )
