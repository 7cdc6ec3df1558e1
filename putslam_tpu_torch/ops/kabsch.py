"""Batched closed-form rigid alignment (Horn's quaternion method) — port
of ``putslam_tpu/ops/kabsch.py``. The dominant eigenvector of Horn's 4×4
matrix comes from the same fixed number of symmetric squarings, carried as
component tensors (structure of arrays), so every hypothesis solves at once.
``alignment_residuals`` and ``transform_covariance`` evaluate an estimate.
"""

from __future__ import annotations

import torch

from putslam_tpu_torch.geometry import se3


def weighted_kabsch(p, q, w, iters: int = 30):
    """Poses T = (R, t) minimising Σ wᵢ ‖R·pᵢ + t − qᵢ‖² per batch row.
    p, q: (..., n, 3); w: (..., n). Returns (..., 7)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    wn = w / wsum
    p_bar = torch.sum(wn[..., None] * p, dim=-2)
    q_bar = torch.sum(wn[..., None] * q, dim=-2)
    pc = p - p_bar[..., None, :]
    qc = q - q_bar[..., None, :]
    wpc = wn[..., None] * pc
    S = tuple(torch.sum(wpc[..., i] * qc[..., j], dim=-1)
              for i in range(3) for j in range(3))
    quat = _horn_quat_soa(S, iters)
    t = q_bar - se3.quat_rotate(quat, p_bar)
    return se3.make_pose(t, quat)


def kabsch_soa(px, py, pz, qx, qy, qz, iters: int = 30):
    """Uniform-weight Kabsch from component tensors with the point axis
    leading: (n, ...) each. Returns (..., 7)."""
    pb = [c.mean(0) for c in (px, py, pz)]
    qb = [c.mean(0) for c in (qx, qy, qz)]
    pcs = [c - m for c, m in zip((px, py, pz), pb)]
    qcs = [c - m for c, m in zip((qx, qy, qz), qb)]
    S = tuple(torch.sum(pcs[i] * qcs[j], dim=0)
              for i in range(3) for j in range(3))
    quat = _horn_quat_soa(S, iters)
    p_bar = torch.stack(pb, dim=-1)
    q_bar = torch.stack(qb, dim=-1)
    t = q_bar - se3.quat_rotate(quat, p_bar)
    return se3.make_pose(t, quat)


def _horn_quat_soa(S, iters: int = 30):
    """Optimal rotation quaternion from the nine cross-covariance component
    tensors S = (Sxx, Sxy, …, Szz). Returns (..., 4)."""
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz = S
    k00 = Sxx + Syy + Szz
    k01 = Syz - Szy
    k02 = Szx - Sxz
    k03 = Sxy - Syx
    k11 = Sxx - Syy - Szz
    k12 = Sxy + Syx
    k13 = Szx + Sxz
    k22 = -Sxx + Syy - Szz
    k23 = Syz + Szy
    k33 = -Sxx - Syy + Szz
    a = torch.abs
    c = (a(k00) + a(k11) + a(k22) + a(k33)
         + 2.0 * (a(k01) + a(k02) + a(k03) + a(k12) + a(k13) + a(k23))) \
        / 4.0 + 1e-6
    b00, b11, b22, b33 = k00 + c, k11 + c, k22 + c, k33 + c
    b01, b02, b03, b12, b13, b23 = k01, k02, k03, k12, k13, k23

    n_sq = max(3, (iters + 5) // 6)
    for _ in range(n_sq):
        n00 = b00 * b00 + b01 * b01 + b02 * b02 + b03 * b03
        n01 = b00 * b01 + b01 * b11 + b02 * b12 + b03 * b13
        n02 = b00 * b02 + b01 * b12 + b02 * b22 + b03 * b23
        n03 = b00 * b03 + b01 * b13 + b02 * b23 + b03 * b33
        n11 = b01 * b01 + b11 * b11 + b12 * b12 + b13 * b13
        n12 = b01 * b02 + b11 * b12 + b12 * b22 + b13 * b23
        n13 = b01 * b03 + b11 * b13 + b12 * b23 + b13 * b33
        n22 = b02 * b02 + b12 * b12 + b22 * b22 + b23 * b23
        n23 = b02 * b03 + b12 * b13 + b22 * b23 + b23 * b33
        n33 = b03 * b03 + b13 * b13 + b23 * b23 + b33 * b33
        scale = torch.clamp(torch.maximum(torch.maximum(n00, n11),
                                          torch.maximum(n22, n33)), min=1e-30)
        inv = 1.0 / scale
        b00, b11, b22, b33 = n00 * inv, n11 * inv, n22 * inv, n33 * inv
        b01, b02, b03 = n01 * inv, n02 * inv, n03 * inv
        b12, b13, b23 = n12 * inv, n13 * inv, n23 * inv

    c0, c1, c2, c3 = 1.0, 0.31, 0.17, 0.083
    v0 = b00 * c0 + b01 * c1 + b02 * c2 + b03 * c3
    v1 = b01 * c0 + b11 * c1 + b12 * c2 + b13 * c3
    v2 = b02 * c0 + b12 * c1 + b22 * c2 + b23 * c3
    v3 = b03 * c0 + b13 * c1 + b23 * c2 + b33 * c3
    nrm = torch.clamp(torch.sqrt(v0 * v0 + v1 * v1 + v2 * v2 + v3 * v3),
                      min=1e-20)
    v0, v1, v2, v3 = v0 / nrm, v1 / nrm, v2 / nrm, v3 / nrm
    u0 = b00 * v0 + b01 * v1 + b02 * v2 + b03 * v3
    u1 = b01 * v0 + b11 * v1 + b12 * v2 + b13 * v3
    u2 = b02 * v0 + b12 * v1 + b22 * v2 + b23 * v3
    u3 = b03 * v0 + b13 * v1 + b23 * v2 + b33 * v3
    v = torch.stack([u0, u1, u2, u3], dim=-1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-20)
    quat = torch.where(v[..., 0:1] < 0, -v, v)
    return se3.quat_normalize(quat)


def alignment_residuals(T, p, q):
    """‖T·p − q‖ per pair, broadcasting T (..., 7) over points (..., n, 3)."""
    return torch.linalg.norm(se3.apply(T[..., None, :], p) - q, dim=-1)


def transform_covariance(T, p, w, point_var: float = 1.0):
    """6×6 covariance of the estimated transform in the twist tangent at T
    (``putslam_tpu/ops/kabsch.py:159``): Cov(ξ) = σ² (Σ wᵢ JᵢᵀJᵢ)⁻¹ with
    Jᵢ = [I | −skew(T·pᵢ)] (left perturbation), damped by 1e-9·I for
    degenerate sets. p: (..., n, 3); w: (..., n). Returns (..., 6, 6)."""
    tp = se3.apply(T[..., None, :], p)                        # (..., n, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        tp.shape[:-1] + (3, 3))
    J = torch.cat([eye, -se3.skew(tp)], dim=-1)               # (..., n, 3, 6)
    H = torch.einsum("...n,...nri,...nrj->...ij", w, J, J)
    H = H + 1e-9 * torch.eye(6, dtype=p.dtype, device=p.device)
    return point_var * torch.linalg.inv(H)
