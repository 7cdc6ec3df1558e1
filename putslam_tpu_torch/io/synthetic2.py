"""INDEPENDENT image-formation path: a plane-scene renderer.

Port of ``putslam_tpu/io/synthetic2.py:32-159`` (``Plane``,
``default_room``, ``render_frame``, ``render_sequence``), in torch on the
caller's device. The scene is finite textured rectangles (room walls and
furniture planes), the texture oriented sinusoid gratings plus a speckle
hash, the shading Lambertian from a fixed world light plus ambient, and the
camera a pinhole whose pixel grid carries a DIVISION-MODEL radial
distortion (Fitzgibbon; x_u = x_d / (1 + λ·r_d²)) that the written
camera.json does not advertise: a different family from the radial-
tangential polynomial the engine corrects for, so the engine consumes
images whose formation violates its camera model as real optics do.

Everything computes in float64, as the numpy original does, and is cast to
float32 at the end: the speckle hash ``fract(sin(·)·43758.5453)`` in
float32 would give another texture. Each ``Plane`` draws its texture
parameters on the host with ``np.random.default_rng(tex_seed)``, exactly as
the original, so the parameters are identical. Depth is the camera-frame z
of the nearest surface along each (distorted) pixel ray.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


class Plane:
    """Finite textured rectangle: origin p0, unit axes e1/e2 with
    half-extents h1/h2, outward normal n = e1×e2. The geometry and the
    texture parameters are float64 numpy values on the host."""

    def __init__(self, p0, e1, e2, h1, h2, tex_seed):
        self.p0 = np.asarray(p0, np.float64)
        e1 = np.asarray(e1, np.float64)
        e2 = np.asarray(e2, np.float64)
        self.e1 = e1 / np.linalg.norm(e1)
        self.e2 = e2 / np.linalg.norm(e2)
        self.n = np.cross(self.e1, self.e2)
        self.h1 = float(h1)
        self.h2 = float(h2)
        rng = np.random.default_rng(tex_seed)
        self.freqs = rng.uniform(8.0, 40.0, (3, 2))
        self.phases = rng.uniform(0, 2 * np.pi, (3,))
        self.amps = rng.uniform(0.08, 0.18, (3,))
        self.base = rng.uniform(0.35, 0.7)
        self.speckle_seed = float(rng.uniform(100, 1000))
        self.speckle_amp = rng.uniform(0.15, 0.3)
        self.speckle_scale = rng.uniform(60.0, 140.0)

    def texture(self, a, b):
        """Albedo at local plane coords (a, b) (float64 tensors) — gratings
        + sharp speckle (the speckle provides the corner content FAST
        needs)."""
        t = torch.full_like(a, float(self.base))
        for k in range(3):
            t = t + float(self.amps[k]) * torch.sin(
                float(self.freqs[k, 0]) * a + float(self.phases[k])) \
                * torch.sin(float(self.freqs[k, 1]) * b)
        ia = torch.floor(a * float(self.speckle_scale))
        ib = torch.floor(b * float(self.speckle_scale))
        h = torch.sin(ia * 12.9898 + ib * 78.233 + self.speckle_seed) \
            * 43758.5453
        t = t + float(self.speckle_amp) * ((h - torch.floor(h)) - 0.5)
        return torch.clamp(t, 0.02, 1.0)


def default_room() -> List[Plane]:
    """A small room: back/side walls, floor, a table top and two tilted
    panels — everything 0.8–5 m from the trajectory volume."""
    return [
        Plane([0.0, 0.0, 3.2], [1, 0, 0], [0, -1, 0], 2.6, 1.9, 11),  # back
        Plane([-2.2, 0.0, 1.8], [0, 0, 1], [0, -1, 0], 1.9, 1.9, 12), # left
        Plane([2.2, 0.0, 1.8], [0, 0, -1], [0, -1, 0], 1.9, 1.9, 13), # right
        Plane([0.0, 1.5, 1.8], [1, 0, 0], [0, 0, 1], 2.6, 1.9, 14),   # floor
        Plane([-0.5, 0.55, 2.1], [1, 0, 0], [0, 0, 1], 0.8, 0.5, 15), # table
        Plane([0.9, -0.3, 2.6], [0.8, 0, -0.6], [0, -1, 0], 0.55, 0.7, 16),
        Plane([-1.1, -0.5, 2.7], [0.7, 0.2, 0.68], [0.1, -0.97, 0.1],
              0.5, 0.6, 17),
    ]


LIGHT_DIR = np.array([0.35, -0.8, -0.49])
LIGHT_DIR = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)
AMBIENT = 0.45
DIFFUSE = 0.55


def _pose_matrices(pose):
    """[tx ty tz qw qx qy qz] (float64 tensor) → (R (3, 3), t (3,))
    world←camera, on the pose's device."""
    t = pose[:3]
    w, x, y, z = pose[3], pose[4], pose[5], pose[6]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])
    return R, t


def _as_poses(poses) -> torch.Tensor:
    """Poses as a float64 tensor on their own device (numpy → the CPU)."""
    if not torch.is_tensor(poses):
        poses = torch.as_tensor(np.array(poses))
    return poses.to(torch.float64)


def render_frame(cam, pose, planes: List[Plane] = None,
                 division_lambda: float = -0.04
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (gray (H, W) float32 in [0, 1], depth (H, W) float32 metres)
    on the pose's device.

    ``division_lambda``: the radial division-model coefficient applied to
    the PIXEL GRID (x_u = x_d/(1+λ·r²)); the written camera.json advertises
    an ideal pinhole, so consumers inherit a real, mild model error. No
    plane is skipped on the host: a plane that covers no pixel changes
    nothing, and the test would be a synchronisation."""
    if planes is None:
        planes = default_room()
    pose = _as_poses(pose)
    dev = pose.device
    f64 = dict(dtype=torch.float64, device=dev)
    H, W = cam.height, cam.width
    vv, uu = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                            indexing="ij")
    xd = (uu - cam.cu) / cam.fu
    yd = (vv - cam.cv) / cam.fv
    r2 = xd * xd + yd * yd
    den = 1.0 + division_lambda * r2
    xu = xd / den
    yu = yd / den
    # camera-frame ray directions (unnormalized, z = 1) → world
    R, C = _pose_matrices(pose)
    dirs = torch.stack([xu, yu, torch.ones_like(xu)], dim=-1) @ R.T

    best_t = torch.full((H, W), float("inf"), **f64)
    gray = torch.zeros((H, W), **f64)
    for pl in planes:
        n = torch.as_tensor(pl.n, **f64)
        p0 = torch.as_tensor(pl.p0, **f64)
        dn = dirs @ n                                             # (H, W)
        # front-facing only; avoid division blowups near grazing
        denom = torch.where(torch.abs(dn) < 1e-9,
                            torch.full_like(dn, 1e-9), dn)
        tt = ((p0 - C) @ n) / denom
        pt = C + tt[..., None] * dirs
        rel = pt - p0
        a = rel @ torch.as_tensor(pl.e1, **f64)
        b = rel @ torch.as_tensor(pl.e2, **f64)
        hit = (tt > 0.05) & (torch.abs(a) <= pl.h1) \
            & (torch.abs(b) <= pl.h2) & (tt < best_t)
        albedo = pl.texture(a, b)
        lam = max(abs(float(pl.n @ LIGHT_DIR)), 0.0)
        shade = AMBIENT + DIFFUSE * lam
        gray = torch.where(hit, albedo * shade, gray)
        best_t = torch.where(hit, tt, best_t)

    # depth = camera-frame z: t is the multiplier of a z=1 camera ray
    depth = torch.where(torch.isfinite(best_t), best_t,
                        torch.zeros_like(best_t))
    return gray.to(torch.float32), depth.to(torch.float32)


def render_sequence(cam, poses, division_lambda: float = -0.04):
    """Render a (T, 7) pose sequence → (grays (T, H, W), depths (T, H, W))
    float32 tensors on the poses' device (numpy poses: the CPU)."""
    planes = default_room()
    grays, depths = [], []
    for p in _as_poses(poses):
        g, d = render_frame(cam, p, planes, division_lambda)
        grays.append(g)
        depths.append(d)
    return torch.stack(grays), torch.stack(depths)
