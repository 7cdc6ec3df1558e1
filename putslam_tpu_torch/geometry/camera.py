"""Batched pinhole camera with radial-tangential distortion (torch).

Port of ``putslam_tpu/geometry/camera.py``: ``(..., 2)`` pixel tensors and
``(..., 3)`` point tensors, no per-feature loops; distortion is the
radial-tangential model, undistortion the same fixed 8-iteration
fixed-point inversion.
"""

from __future__ import annotations

import torch

from putslam_tpu_torch.config import CameraConfig


def intrinsics_matrix(cam: CameraConfig, dtype=torch.float32, device=None):
    """The 3×3 pinhole matrix K."""
    return torch.tensor([[cam.fu, 0.0, cam.cu], [0.0, cam.fv, cam.cv],
                         [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def distort_normalized(cam: CameraConfig, xy):
    """Radial-tangential distortion of normalised coordinates (...,2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy2 = 2.0 * x * y
    return torch.stack([x * radial + cam.p1 * xy2 + cam.p2 * (r2 + 2.0 * x * x),
                        y * radial + cam.p2 * xy2 + cam.p1 * (r2 + 2.0 * y * y)],
                       dim=-1)


def undistort_normalized(cam: CameraConfig, xy_d, iters: int = 8):
    """Invert the distortion by fixed-point iteration."""
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xy2 = 2.0 * x * y
        dx = cam.p1 * xy2 + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p2 * xy2 + cam.p1 * (r2 + 2.0 * y * y)
        xy = (xy_d - torch.stack([dx, dy], dim=-1)) / radial[..., None]
    return xy


def pixel_to_normalized(cam: CameraConfig, uv):
    return torch.stack([(uv[..., 0] - cam.cu) / cam.fu,
                        (uv[..., 1] - cam.cv) / cam.fv], dim=-1)


def normalized_to_pixel(cam: CameraConfig, xy):
    return torch.stack([xy[..., 0] * cam.fu + cam.cu,
                        xy[..., 1] * cam.fv + cam.cv], dim=-1)


def undistort_pixels(cam: CameraConfig, uv):
    """Distorted pixels → ideal (undistorted) pixels (...,2)."""
    return normalized_to_pixel(
        cam, undistort_normalized(cam, pixel_to_normalized(cam, uv)))


def unproject(cam: CameraConfig, uv, depth, undistort: bool = False):
    """(u, v, d) → camera-frame xyz (...,3); ``undistort`` first removes the
    lens distortion from the pixels."""
    xy = pixel_to_normalized(cam, uv)
    if undistort:
        xy = undistort_normalized(cam, xy)
    return torch.cat([xy * depth[..., None], depth[..., None]], dim=-1)


def project(cam: CameraConfig, xyz, distort: bool = False):
    """Camera-frame xyz → pixels (...,2), with a tiny-z guard; ``distort``
    applies the lens distortion (else ideal pixels)."""
    z = xyz[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xy = xyz[..., 0:2] / z
    if distort:
        xy = distort_normalized(cam, xy)
    return normalized_to_pixel(cam, xy)


def depth_valid_mask(cam: CameraConfig, depth):
    """The min/max depth validity gate (0.1–6 m at fr1)."""
    return (depth > cam.min_depth) & (depth < cam.max_depth)


def in_image_mask(cam: CameraConfig, uv, border: float = 0.0):
    """Pixels (...,2) inside the image by at least ``border``."""
    return ((uv[..., 0] >= border) & (uv[..., 0] <= cam.width - 1 - border)
            & (uv[..., 1] >= border) & (uv[..., 1] <= cam.height - 1 - border))


def bilinear_sample(image, uv):
    """Sample image (H, W) at float pixel coords uv (...,2), clamped."""
    H, W = image.shape[-2], image.shape[-1]
    u = torch.clamp(uv[..., 0], 0.0, W - 1.0)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.0)
    u0 = torch.clamp(torch.floor(u).long(), 0, W - 2)
    v0 = torch.clamp(torch.floor(v).long(), 0, H - 2)
    du = u - u0
    dv = v - v0
    i00 = image[..., v0, u0]
    i01 = image[..., v0, u0 + 1]
    i10 = image[..., v0 + 1, u0]
    i11 = image[..., v0 + 1, u0 + 1]
    return (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
            + i10 * (1 - du) * dv + i11 * du * dv)


def sample_depth(depth_image, uv):
    """Nearest-neighbour depth lookup at pixel coords (...,2)."""
    H, W = depth_image.shape[-2], depth_image.shape[-1]
    u = torch.clamp(torch.round(uv[..., 0]).long(), 0, W - 1)
    v = torch.clamp(torch.round(uv[..., 1]).long(), 0, H - 1)
    return depth_image[..., v, u]
