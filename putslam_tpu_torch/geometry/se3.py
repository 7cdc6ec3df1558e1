"""Batched SE(3) / quaternion math on torch tensors.

Port of ``putslam_tpu/geometry/se3.py``. A pose is a flat ``(..., 7)``
float tensor ``[tx, ty, tz, qw, qx, qy, qz]`` (camera→world, Hamilton
quaternions). Every function broadcasts over leading batch axes. The
tangent is ``[rho(3), phi(3)]``; updates compose on the right,
``pose' = pose ∘ exp(xi)``.
"""

from __future__ import annotations

import torch


def _eye3(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def _unit_rows(width: int, one: int, batch_shape, dtype, device):
    """(..., width) rows of zeros with a 1 in column ``one``, made on the
    device by kernels alone: a Python scalar written into a device tensor
    crosses from the host (a synchronising copy, and no copy at all inside
    a CUDA graph)."""
    row = (torch.arange(width, device=device) == one).to(dtype)
    return row.expand(tuple(batch_shape) + (width,)).clone()


def quat_identity(batch_shape=(), dtype=torch.float32, device=None):
    """Identity quaternions (..., 4) = [1, 0, 0, 0]."""
    return _unit_rows(4, 0, batch_shape, dtype, device)


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


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


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (...,3) by quaternions q (...,4)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


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


def matrix_to_quat(m):
    """(...,3,3) → (...,4). Branch-free Shepperd-style selection: of the
    four unnormalised candidates the one with the largest dominant
    component is taken (first on ties, as ``argmax``), sign w ≥ 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw_w = 1.0 + m00 + m11 + m22
    qx_x = 1.0 + m00 - m11 - m22
    qy_y = 1.0 - m00 + m11 - m22
    qz_z = 1.0 - m00 - m11 + m22
    cands = torch.stack([
        torch.stack([qw_w, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, qx_x, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, qy_y, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz_z], dim=-1),
    ], dim=-2)                                               # (..., 4, 4)
    idx = torch.argmax(torch.stack([qw_w, qx_x, qy_y, qz_z], dim=-1), dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


def quat_angle(q):
    """Rotation angle of quaternion(s), in radians (0..pi)."""
    return 2.0 * torch.arccos(torch.clamp(torch.abs(q[..., 0]), 0.0, 1.0))


def identity(batch_shape=(), dtype=torch.float32, device=None):
    return _unit_rows(7, 3, batch_shape, dtype, device)


def make_pose(t, q):
    return torch.cat([t, quat_normalize(q)], dim=-1)


def translation(p):
    return p[..., 0:3]


def rotation_quat(p):
    return p[..., 3:7]


def compose(a, b):
    """a ∘ b: apply b first, then a (i.e. T_a @ T_b)."""
    q = quat_mul(rotation_quat(a), rotation_quat(b))
    t = translation(a) + quat_rotate(rotation_quat(a), translation(b))
    return make_pose(t, q)


def inverse(p):
    qi = quat_conj(rotation_quat(p))
    ti = -quat_rotate(qi, translation(p))
    return make_pose(ti, qi)


def apply(p, pts):
    """Transform points (...,3) by poses (...,7), broadcasting."""
    return quat_rotate(rotation_quat(p), pts) + translation(p)


def apply_soa(p, px, py, pz):
    """Structure-of-arrays point transform: pose (..., 7) applied to point
    component tensors px/py/pz (each broadcastable against p[..., 0]).
    Returns (x, y, z)."""
    qw, qx, qy, qz = p[..., 3], p[..., 4], p[..., 5], p[..., 6]
    tx = 2.0 * (qy * pz - qz * py)
    ty = 2.0 * (qz * px - qx * pz)
    tz = 2.0 * (qx * py - qy * px)
    x = px + qw * tx + (qy * tz - qz * ty) + p[..., 0]
    y = py + qw * ty + (qz * tx - qx * tz) + p[..., 1]
    z = pz + qw * tz + (qx * ty - qy * tx) + p[..., 2]
    return x, y, z


def to_matrix(p):
    """(...,7) → (...,4,4) homogeneous matrices."""
    top = torch.cat([quat_to_matrix(rotation_quat(p)),
                     translation(p)[..., None]], dim=-1)
    bottom = torch.zeros(p.shape[:-1] + (1, 4), dtype=p.dtype,
                         device=p.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m):
    """(...,4,4) homogeneous matrices → (...,7) poses."""
    return make_pose(m[..., 0:3, 3], matrix_to_quat(m[..., 0:3, 0:3]))


def relative(a, b):
    """a⁻¹ ∘ b — the increment taking frame a to frame b."""
    return compose(inverse(a), b)


# ---------------------------------------------------------------------------
# so(3)/se(3) exp & log maps and the Jacobian blocks the backend uses.
# ---------------------------------------------------------------------------


def _taylor_safe(theta2, exact, taylor, eps=1e-8):
    return torch.where(theta2 > eps, exact, taylor)


def so3_exp_quat(phi):
    """Axis-angle (...,3) → quaternion (...,4)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    s = _taylor_safe(theta2, torch.sin(half) / theta, 0.5 - theta2 / 48.0)
    return torch.cat([torch.cos(half), s * phi], dim=-1)


def so3_log(q):
    """Quaternion (...,4) → axis-angle (...,3)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(vn2, min=1e-24))
    theta = 2.0 * torch.atan2(vn, w)
    scale = _taylor_safe(vn2, theta / vn, 2.0 / torch.clamp(w, min=1e-12))
    return scale * v


def skew(v):
    """(...,3) → (...,3,3) cross-product matrices."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _so3_left_jacobian(phi):
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = skew(phi)
    K2 = K @ K
    A = _taylor_safe(theta2, (1 - torch.cos(theta)) / theta2,
                     0.5 - theta2 / 24.0)
    B = _taylor_safe(theta2, (theta - torch.sin(theta)) / (theta2 * theta),
                     1.0 / 6.0 - theta2 / 120.0)
    return _eye3(phi).expand(K.shape) + A * K + B * K2


def _so3_left_jacobian_inv(phi):
    """J_l⁻¹ = I − ½K + c·K² (Taylor window θ² < 0.25, as the reference)."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = skew(phi)
    K2 = K @ K
    sin_t = torch.sin(theta)
    den = 2.0 * theta * sin_t
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    c = _taylor_safe(
        theta2,
        1.0 / torch.clamp(theta2, min=1e-24) - (1.0 + torch.cos(theta)) / den,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        eps=0.25)
    return _eye3(phi).expand(K.shape) - 0.5 * K + c * K2


def _se3_Q(xi):
    """Q block of the SE(3) left Jacobian (Barfoot eq. 7.86)."""
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    Cr = skew(rho)
    Cp = skew(phi)
    Cp2 = Cp @ Cp
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    t4 = theta2 * theta2
    m2 = _taylor_safe(theta2, (theta - sin_t) / (theta2 * theta),
                      1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0, eps=0.25)
    m3 = _taylor_safe(theta2, (1.0 - 0.5 * theta2 - cos_t) / t4,
                      -1.0 / 24.0 + theta2 / 720.0 - t4 / 40320.0, eps=0.25)
    m5 = _taylor_safe(
        theta2, (theta - sin_t - theta2 * theta / 6.0) / (t4 * theta),
        -1.0 / 120.0 + theta2 / 5040.0 - t4 / 362880.0, eps=0.25)
    m4 = 0.5 * (m3 - 3.0 * m5)
    CpCr = Cp @ Cr
    CrCp = Cr @ Cp
    return (0.5 * Cr
            + m2 * (CpCr + CrCp + Cp @ CrCp)
            - m3 * (Cp2 @ Cr + Cr @ Cp2 - 3.0 * (Cp @ CrCp))
            - m4 * (CpCr @ Cp2 + Cp2 @ CrCp))


def se3_left_jacobian_inv_blocks(xi):
    """(X, Y) blocks of Jl⁻¹(ξ) = [[X, Y], [0, X]]: X = Jl⁻¹(φ),
    Y = −X·Q(ξ)·X."""
    X = _so3_left_jacobian_inv(xi[..., 3:6])
    Y = -(X @ _se3_Q(xi) @ X)
    return X, Y


def blocks_to_6x6(X, Y, Z, W):
    return torch.cat([torch.cat([X, Y], dim=-1), torch.cat([Z, W], dim=-1)],
                     dim=-2)


def se3_left_jacobian_inv(xi):
    """Inverse left Jacobian of SE(3) at twist xi (...,6) → (...,6,6):
    [[Jl⁻¹, −Jl⁻¹·Q·Jl⁻¹], [0, Jl⁻¹]], closed form."""
    X, Y = se3_left_jacobian_inv_blocks(xi)
    return blocks_to_6x6(X, Y, torch.zeros_like(X), X)


def se3_right_jacobian_inv(xi):
    """Inverse right Jacobian of SE(3): Jr⁻¹(ξ) = Jl⁻¹(−ξ)."""
    return se3_left_jacobian_inv(-xi)


def adjoint(p):
    """Adjoint of poses (...,7) → (...,6,6) for [ρ, φ] twists,
    T·exp(ξ)·T⁻¹ = exp(Ad(T)·ξ): Ad = [[R, skew(t)·R], [0, R]]."""
    R = quat_to_matrix(rotation_quat(p))
    return blocks_to_6x6(R, skew(translation(p)) @ R, torch.zeros_like(R), R)


def exp(xi):
    """se(3) twist (...,6) [rho, phi] → pose (...,7)."""
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    q = so3_exp_quat(phi)
    t = torch.einsum("...ij,...j->...i", _so3_left_jacobian(phi), rho)
    return make_pose(t, q)


def log(p):
    """Pose (...,7) → twist (...,6); ρ = J_l⁻¹(φ)·t in closed form."""
    phi = so3_log(rotation_quat(p))
    rho = torch.einsum("...ij,...j->...i", _so3_left_jacobian_inv(phi),
                       translation(p))
    return torch.cat([rho, phi], dim=-1)


def retract(p, xi):
    """Right-composition retraction p ∘ exp(xi)."""
    return compose(p, exp(xi))


def boxminus(a, b):
    """log(b⁻¹ ∘ a): the twist from b to a (right convention)."""
    return log(compose(inverse(b), a))
