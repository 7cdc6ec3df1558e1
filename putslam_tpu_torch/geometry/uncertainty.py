"""Closed-form batched 3×3 inverse and Cholesky factor (torch).

Port of ``inv3x3`` and ``chol3x3`` from
``putslam_tpu/geometry/uncertainty.py`` — the two the bundle adjustment
uses. The sensor-noise models of that module are not ported yet.
"""

from __future__ import annotations

import torch


def inv3x3(M, eps: float = 1e-30):
    """Batched 3×3 inverse via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < eps,
                                torch.full_like(det, eps), det)
    adj = torch.stack([
        A, -(b * i - c * h), b * f - c * e,
        B, a * i - c * g, -(a * f - c * d),
        C, -(a * h - b * g), a * e - b * d,
    ], dim=-1).reshape(M.shape)
    return adj * inv_det[..., None, None]


def chol3x3(M, eps: float = 1e-12):
    """Batched lower Cholesky factor L with M = L·Lᵀ for symmetric PSD 3×3."""
    a = torch.sqrt(torch.clamp(M[..., 0, 0], min=eps))
    b = M[..., 1, 0] / a
    c = M[..., 2, 0] / a
    d = torch.sqrt(torch.clamp(M[..., 1, 1] - b * b, min=eps))
    e = (M[..., 2, 1] - c * b) / d
    f = torch.sqrt(torch.clamp(M[..., 2, 2] - c * c - e * e, min=eps))
    zero = torch.zeros_like(a)
    return torch.stack([
        torch.stack([a, zero, zero], dim=-1),
        torch.stack([b, d, zero], dim=-1),
        torch.stack([c, e, f], dim=-1),
    ], dim=-2)
