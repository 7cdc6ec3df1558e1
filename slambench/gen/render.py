"""The raycast room: a procedurally textured [-3, 3]×[-2, 2]×[-3, 3] box
seen from a camera pose, with exact z-depth.

Frozen copy of ``putslam_tpu_torch/io/synthetic.py`` at commit 6b05da9
(``_hash3``, ``texture3d``, and ``render_frame`` given a batch axis of
poses), rendering on the poses' device. ``render_wire`` adds what a file player would hand over after
decoding: gray quantised to ``uint8`` and depth to ``uint16`` counts at the
sensor's scale, in pinned host memory.
"""

from __future__ import annotations

import torch

from slambench.gen import se3

_MASK32 = 0xFFFFFFFF


def _hash3(ix, iy, iz, seed: int):
    """uint32 cell hash, in int64 with explicit 32-bit wrap-around."""
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


def render_frames(cam, poses, supersample: int = 2, seed: int = 7):
    """(gray (B, H, W) in [0, 1], depth (B, H, W) z-depth metres) for B
    camera poses (B, 7) inside the room, on the poses' device: the frozen
    ``render_frame`` with a batch axis. ``cam`` has fu, fv, cu, cv, width,
    height."""
    dev = poses.device
    box_min = torch.tensor([-3.0, -2.0, -3.0], device=dev)
    box_max = torch.tensor([3.0, 2.0, 3.0], device=dev)
    ss = supersample
    H, W = cam.height, cam.width
    B = poses.shape[0]
    u = (torch.arange(W * ss, dtype=torch.float32, device=dev) + 0.5) / ss - 0.5
    v = (torch.arange(H * ss, dtype=torch.float32, device=dev) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dir_cam = torch.stack([(uu - cam.cu) / cam.fu, (vv - cam.cv) / cam.fv,
                           torch.ones_like(uu)], dim=-1)
    R = se3.quat_to_matrix(poses[:, 3:7])
    o = poses[:, None, None, 0:3]
    d = torch.einsum("bij,hwj->bhwi", R, dir_cam)

    safe_d = torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    t_far = torch.maximum((box_max - o) / safe_d, (box_min - o) / safe_d)
    t = torch.clamp(torch.amin(t_far, dim=-1), min=1e-3)

    hit = o + t[..., None] * d
    axis = torch.argmin(t_far, dim=-1)
    # the hit snapped onto the wall it exits through, so that the texture
    # cell does not hang on a one-ulp rounding of o + t·d
    face = torch.where(safe_d > 0, box_max, box_min)
    on_axis = torch.nn.functional.one_hot(axis, 3).bool()
    hit = torch.where(on_axis, face, hit)
    n_dot_d = torch.gather(torch.abs(d), -1, axis[..., None])[..., 0]
    d_norm = torch.linalg.norm(d, dim=-1)
    cos_inc = torch.clamp(n_dot_d / torch.clamp(d_norm, min=1e-9), min=0.05)
    footprint = (t * d_norm) / (cam.fu * ss) / cos_inc
    gray = texture3d(hit, footprint, seed)
    if ss > 1:
        gray = gray.reshape(B, H, ss, W, ss).mean(dim=(2, 4))
        t = t.reshape(B, H, ss, W, ss)[:, :, 0, :, 0]
    return gray, t


def render_wire(cam, poses, depth_scale: float, seed: int, pin: bool,
                batch: int = 8):
    """Render (T, 7) poses into (gray uint8 (T, H, W), depth uint16 (T, H,
    W)) host tensors, pinned where ``pin``: gray rounded to 0..255, depth
    rounded to counts of 1/``depth_scale`` m and clamped to 65535."""
    T = poses.shape[0]
    shape = (T, cam.height, cam.width)
    grays = torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
    depths = torch.empty(shape, dtype=torch.uint16, pin_memory=pin)
    for i in range(0, T, batch):
        g, d = render_frames(cam, poses[i:i + batch], seed=seed)
        grays[i:i + batch].copy_(torch.round(g * 255.0).to(torch.uint8))
        counts = torch.clamp(torch.round(d * depth_scale), 0.0, 65535.0)
        # torch.uint16 has few operators: the counts cross as int32
        depths[i:i + batch].view(torch.int16).copy_(
            counts.to(torch.int32).to(torch.int16))
    return grays, depths
