"""The few SE(3) helpers the renderer and the walks need, on torch tensors.

Frozen copy of ``putslam_tpu_torch/geometry/se3.py`` at commit 6b05da9
(``quat_normalize``, ``quat_mul``, ``quat_to_matrix``, ``make_pose``,
``so3_exp_quat``). A pose is ``[tx, ty, tz, qw, qx, qy, qz]``,
camera→world.
"""

from __future__ import annotations

import torch


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def quat_mul(a, b):
    """Hamilton product a⊗b, broadcasting over batch axes."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_to_matrix(q):
    """(...,4) → (...,3,3) rotation matrices."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def make_pose(t, q):
    return torch.cat([t, quat_normalize(q)], dim=-1)


def so3_exp_quat(phi):
    """Axis-angle (...,3) → quaternion (...,4)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    s = torch.where(theta2 > 1e-8, torch.sin(half) / theta,
                    0.5 - theta2 / 48.0)
    return torch.cat([torch.cos(half), s * phi], dim=-1)
