"""Dense RGB-D geometry utilities (torch).

Port of ``putslam_tpu/ops/rgbd.py``: whole-image surface normals from
central differences of the unprojected point map, Scharr image gradients
(two 3×3 cross-correlations, ``F.conv2d``: like XLA's
``conv_general_dilated`` it does not flip the filter), the per-feature 3D
gradient direction that feeds the gradient-based uncertainty model, and the
coloured point cloud with its PLY writer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from putslam_tpu_torch.config import CameraConfig
from putslam_tpu_torch.geometry import camera as camera_mod


def point_map(cam: CameraConfig, depth):
    """Unproject the full depth image → (H, W, 3) camera-frame points."""
    H, W = depth.shape
    vv, uu = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=depth.device),
        torch.arange(W, dtype=torch.float32, device=depth.device),
        indexing="ij")
    return camera_mod.unproject(cam, torch.stack([uu, vv], dim=-1), depth)


def surface_normals(cam: CameraConfig, depth):
    """Per-pixel unit normals (H, W, 3), oriented toward the camera. Pixels
    with invalid depth in the stencil get a zero normal; the validity
    stencil wraps round the border, as the reference's ``roll`` does."""
    P = point_map(cam, depth)
    dx = torch.zeros_like(P)
    dx[:, 1:-1] = 0.5 * (P[:, 2:] - P[:, :-2])
    dy = torch.zeros_like(P)
    dy[1:-1, :] = 0.5 * (P[2:, :] - P[:-2, :])
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * P, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    ok = camera_mod.depth_valid_mask(cam, depth)
    ok = (ok & torch.roll(ok, 1, 0) & torch.roll(ok, -1, 0)
          & torch.roll(ok, 1, 1) & torch.roll(ok, -1, 1))
    return torch.where(ok[..., None], n, torch.zeros_like(n))


_SCHARR_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]],
                     np.float32) / 32.0
_SCHARR_Y = np.array([[-3, -10, -3], [0, 0, 0], [3, 10, 3]],
                     np.float32) / 32.0


def image_gradients(gray):
    """Scharr gradients: (gx (H,W), gy (H,W))."""
    w = torch.from_numpy(np.stack([_SCHARR_X, _SCHARR_Y])[:, None]).to(
        gray.device)
    g = F.conv2d(gray[None, None], w, padding=1)[0]
    return g[0], g[1]


def gradient_directions_3d(cam: CameraConfig, gray, uv, depth):
    """Per-feature 3D direction of the image intensity gradient, lifted into
    the camera frame at the feature depth. uv (N,2), depth (N,)."""
    gx, gy = image_gradients(gray)
    gxs = camera_mod.bilinear_sample(gx, uv)
    gys = camera_mod.bilinear_sample(gy, uv)
    d = torch.stack([gxs * depth / cam.fu, gys * depth / cam.fv,
                     torch.zeros_like(gxs)], dim=-1)
    n = torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.where(n > 1e-12, d / torch.clamp(n, min=1e-12),
                       torch.zeros_like(d))


def colored_point_cloud(cam: CameraConfig, gray, depth, stride: int = 1):
    """(points (M,3), intensities (M,), valid (M,)), strided."""
    P = point_map(cam, depth)[::stride, ::stride].reshape(-1, 3)
    I = gray[::stride, ::stride].reshape(-1)
    ok = camera_mod.depth_valid_mask(cam, depth)[::stride, ::stride].reshape(-1)
    return P, I, ok


def _to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_ply(path: str, points, intensities=None, valid=None) -> None:
    """Write an ASCII PLY point cloud."""
    pts = _to_numpy(points)
    if intensities is not None:
        intensities = _to_numpy(intensities)
    if valid is not None:
        v = _to_numpy(valid)
        pts = pts[v]
        if intensities is not None:
            intensities = intensities[v]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if intensities is not None:
            f.write("property uchar gray\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if intensities is not None:
                line += f" {int(np.clip(intensities[i] * 255, 0, 255))}"
            f.write(line + "\n")
