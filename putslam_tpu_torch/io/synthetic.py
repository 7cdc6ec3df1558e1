"""Synthetic RGB-D sequences rendered on the device (raycast box world).

Port of ``putslam_tpu/io/synthetic.py``: a procedurally textured
axis-aligned room seen from a camera trajectory, with exact ground truth
poses and depth; the orbit, leave-and-return (revisit) and handheld
trajectories; and
sensor degradation (image noise, blur, depth noise, depth holes) drawn from
a ``torch.Generator``. Conventions: camera looks down +z, x right, y down;
a pose is camera→world in the (..., 7) layout.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from putslam_tpu_torch.config import CameraConfig
from putslam_tpu_torch.geometry import se3

_MASK32 = 0xFFFFFFFF


def _hash3(ix, iy, iz, seed: int):
    """The reference's uint32 cell hash, in int64 with explicit 32-bit
    wrap-around. Cells go float → int32 (two's complement for negative
    cells) → uint32, as the reference casts them."""
    def u32(c):
        return c.to(torch.int32).to(torch.int64) & _MASK32

    h = (((u32(ix) * 73856093) & _MASK32) ^ ((u32(iy) * 19349663) & _MASK32)
         ^ ((u32(iz) * 83492791) & _MASK32) ^ ((seed * 2654435761) & _MASK32))
    h = h ^ (h >> 13)
    h = (h * 1274126177) & _MASK32
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) / 65535.0


def texture3d(p, footprint=None, seed: int = 7):
    """Intensity in [0, 1] at world points p (..., 3): hashed cells at three
    scales, faded to mid-gray where a cell is smaller than the pixel
    footprint, plus smooth shading."""
    out = 0.0
    for octave, (scale, weight) in enumerate(((4.0, 0.45), (10.0, 0.3),
                                              (24.0, 0.15))):
        g = torch.floor(p * scale)
        val = _hash3(g[..., 0], g[..., 1], g[..., 2], seed + octave)
        if footprint is not None:
            fade = torch.clamp((1.0 - footprint * scale) / 0.6, 0.0, 1.0)
            val = fade * val + (1.0 - fade) * 0.5
        out = out + weight * val
    out = out + 0.1 * (0.5 + 0.5 * torch.sin(p[..., 0] * 1.7 + p[..., 2] * 0.9))
    return torch.clamp(out, 0.0, 1.0)


def render_frame(cam: CameraConfig, pose, supersample: int = 2,
                 seed: int = 7):
    """(gray (H, W) in [0, 1], depth (H, W) z-depth metres) for a camera
    pose inside the [-3, 3]×[-2, 2]×[-3, 3] room, on the pose's device.
    The intensity is rendered at ``supersample``× and average-pooled."""
    dev = pose.device
    box_min = torch.tensor([-3.0, -2.0, -3.0], device=dev)
    box_max = torch.tensor([3.0, 2.0, 3.0], device=dev)
    ss = supersample
    H, W = cam.height, cam.width
    u = (torch.arange(W * ss, dtype=torch.float32, device=dev) + 0.5) / ss - 0.5
    v = (torch.arange(H * ss, dtype=torch.float32, device=dev) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dir_cam = torch.stack([(uu - cam.cu) / cam.fu, (vv - cam.cv) / cam.fv,
                           torch.ones_like(uu)], dim=-1)
    R = se3.quat_to_matrix(se3.rotation_quat(pose))
    o = se3.translation(pose)
    d = torch.einsum("ij,hwj->hwi", R, dir_cam)

    safe_d = torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    t_far = torch.maximum((box_max - o) / safe_d, (box_min - o) / safe_d)
    t = torch.clamp(torch.amin(t_far, dim=-1), min=1e-3)

    hit = o + t[..., None] * d
    axis = torch.argmin(t_far, dim=-1)
    # Put the hit exactly on the wall it exits through. Every wall lies on
    # a texture-cell boundary (±3·scale, ±2·scale are integers), so the
    # reference's o + t·d decides the cell layer by a one-ulp rounding of
    # the wall-normal coordinate — per pixel, differently in every float
    # implementation (ROADMAP Queue 3). Snapped, the texture is a function
    # of the wall point alone.
    face = torch.where(safe_d > 0, box_max, box_min)
    on_axis = torch.nn.functional.one_hot(axis, 3).bool()
    hit = torch.where(on_axis, face, hit)
    n_dot_d = torch.gather(torch.abs(d), -1, axis[..., None])[..., 0]
    d_norm = torch.linalg.norm(d, dim=-1)
    cos_inc = torch.clamp(n_dot_d / torch.clamp(d_norm, min=1e-9), min=0.05)
    footprint = (t * d_norm) / (cam.fu * ss) / cos_inc
    gray = texture3d(hit, footprint, seed)
    if ss > 1:
        gray = gray.reshape(H, ss, W, ss).mean(dim=(1, 3))
        t = t.reshape(H, ss, W, ss)[:, 0, :, 0]
    return gray, t


def orbit_trajectory(n_frames: int, radius: float = 0.8,
                     height_amp: float = 0.15, yaw_amp: float = 0.35,
                     device="cpu"):
    """Smooth looping trajectory: lateral arc + small yaw and pitch.
    Returns (n_frames, 7) camera→world poses."""
    s = torch.linspace(0.0, 2.0 * math.pi, n_frames, dtype=torch.float32,
                       device=device)
    t = torch.stack([radius * torch.sin(s), height_amp * torch.sin(2.0 * s),
                     0.5 * radius * torch.cos(s) - 0.5], dim=-1)
    yaw = yaw_amp * torch.sin(s)
    pitch = 0.1 * torch.cos(2.0 * s)
    z = torch.zeros_like(yaw)
    qy = torch.stack([torch.cos(yaw / 2), z, torch.sin(yaw / 2), z], dim=-1)
    qx = torch.stack([torch.cos(pitch / 2), torch.sin(pitch / 2), z, z], dim=-1)
    return se3.make_pose(t, se3.quat_mul(qy, qx))


def revisit_trajectory(n_frames: int, sweep: float = 1.2,
                       height_amp: float = 0.08, yaw_amp: float = 0.12,
                       device="cpu"):
    """Leave-and-return trajectory for loop-closure tests: a single
    out-and-back lobe to ``sweep`` metres, symmetric in s ↔ 1 − s, always
    facing the same wall. Returns (n_frames, 7) camera→world poses."""
    s = torch.linspace(0.0, 1.0, n_frames, dtype=torch.float32, device=device)
    lobe = torch.sin(math.pi * s)
    t = torch.stack([sweep * lobe, height_amp * lobe, 0.15 * lobe - 0.5],
                    dim=-1)
    yaw = yaw_amp * lobe
    z = torch.zeros_like(yaw)
    return se3.make_pose(t, torch.stack([torch.cos(yaw / 2), z,
                                         torch.sin(yaw / 2), z], dim=-1))


def handheld_trajectory(n_frames: int, seed: int = 0,
                        step_t: float = 0.013, step_r: float = 0.011,
                        pos_amp=(0.9, 0.45, 0.6), rot_amp: float = 0.35,
                        device="cpu"):
    """Pseudo-random handheld-style trajectory at fr1_desk-like dynamics
    (``putslam_tpu/io/synthetic.py:176-216``): Gaussian-smoothed random walks
    in translation and rotation, rescaled so the median per-frame step is
    ``step_t`` metres / ``step_r`` radians (fr1_desk: about 0.013 m and
    0.011 rad a frame at 30 Hz), clamped to stay inside the render box with
    the camera near (0, 0, -0.5) facing the +z wall. The walk is drawn on the
    host from ``np.random.default_rng(seed)`` in the reference's order, so
    both packages give the same trajectory.

    Returns (n_frames, 7) camera→world poses."""
    rng = np.random.default_rng(seed)
    sigma = 25.0
    pad = int(4 * sigma)
    k = np.exp(-0.5 * ((np.arange(-pad, pad + 1)) / sigma) ** 2)
    k /= k.sum()

    def smooth_channel(amp, target_step):
        raw = rng.normal(size=(n_frames + 2 * pad,))
        s = np.convolve(raw, k, mode="valid")[:n_frames]
        s = s - s.mean()
        d = np.abs(np.diff(s))
        scale = target_step / max(np.median(d), 1e-12)
        return np.clip(s * scale, -amp, amp)

    t = np.stack([smooth_channel(pos_amp[0], step_t),
                  smooth_channel(pos_amp[1], 0.6 * step_t),
                  smooth_channel(pos_amp[2], 0.8 * step_t)], axis=-1)
    t = t + np.array([0.0, 0.0, -0.5])
    rv = np.stack([smooth_channel(rot_amp * 0.6, 0.6 * step_r),
                   smooth_channel(rot_amp, step_r),
                   smooth_channel(rot_amp * 0.4, 0.4 * step_r)], axis=-1)
    rv = torch.as_tensor(rv, dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    return se3.make_pose(t, se3.so3_exp_quat(rv))


def degrade_sequence(grays, depths, seed: int = 0,
                     intensity_sigma: float = 0.0,
                     depth_dropout: float = 0.0,
                     depth_sigma: float = 0.0, blur: int = 0,
                     generator: Optional[torch.Generator] = None):
    """Sensor-noise injection on (T, H, W) frames, in the JAX package's
    order: additive Gaussian image noise (clipped to [0, 1]), horizontal
    box blur of width 2·blur + 1 (zero-padded ``same`` convolution per
    row), additive Gaussian depth noise (clamped at 0), and depth holes (a
    ``depth_dropout`` fraction of pixels set to 0). The noise comes from
    ``generator``, else from one seeded with ``seed`` on the frames' device;
    it is not the JAX package's ``jax.random`` stream. Returns new tensors
    (grays', depths')."""
    g, d = grays, depths
    if generator is None:
        generator = torch.Generator(device=g.device)
        generator.manual_seed(seed)
    if intensity_sigma > 0:
        noise = torch.randn(g.shape, generator=generator, device=g.device)
        g = torch.clamp(g + intensity_sigma * noise, 0.0, 1.0)
    if blur > 0:
        w = 2 * blur + 1
        kernel = torch.full((1, 1, w), 1.0 / w, dtype=g.dtype, device=g.device)
        rows = g.reshape(-1, 1, g.shape[-1])
        g = torch.nn.functional.conv1d(rows, kernel, padding=blur
                                       ).reshape(g.shape)
    if depth_sigma > 0:
        noise = torch.randn(d.shape, generator=generator, device=d.device)
        d = torch.clamp(d + depth_sigma * noise, min=0.0)
    if depth_dropout > 0:
        holes = torch.rand(d.shape, generator=generator,
                           device=d.device) < depth_dropout
        d = torch.where(holes, torch.zeros_like(d), d)
    return g, d


def render_sequence(cam: CameraConfig, poses, seed: int = 7):
    """Render a trajectory frame by frame: (grays (N, H, W),
    depths (N, H, W)) on the poses' device."""
    frames = [render_frame(cam, p, seed=seed) for p in poses]
    return (torch.stack([f[0] for f in frames]),
            torch.stack([f[1] for f in frames]))
