"""Depth-sensor uncertainty models, batched (torch).

Port of ``putslam_tpu/geometry/uncertainty.py``: the cubic depth-variance
polynomial, the per-feature covariance J·diag(σu², σv², σd²)·Jᵀ of the
unprojection, its closed-form 3×3 inverse (the information matrix), the
normal- and gradient-based anisotropic rescalings, the Strasdat depth-scaled
information, and the closed-form 3×3 Cholesky factor the bundle adjustment
whitens with. Covariances are ``(..., 3, 3)`` tensors for all features at
once.
"""

from __future__ import annotations

import torch

from putslam_tpu_torch.config import CameraConfig


def depth_sigma(cam: CameraConfig, z):
    """Depth std-dev from the cubic variance polynomial (fit in mm → m)."""
    var_mm = ((cam.var_c3 * z + cam.var_c2) * z + cam.var_c1) * z + cam.var_c0
    return torch.sqrt(torch.clamp(var_mm, min=0.0)) * 1e-3


def point_covariance(cam: CameraConfig, uv, depth):
    """Per-feature 3×3 covariance J · diag(σu², σv², σd²) · Jᵀ with
    J = ∂(x,y,z)/∂(u,v,d) of the unprojection.

    uv: (...,2) pixels, depth: (...) metres → (...,3,3).
    """
    d = depth
    x_n = (uv[..., 0] - cam.cu) / cam.fu
    y_n = (uv[..., 1] - cam.cv) / cam.fv
    zeros = torch.zeros_like(d)
    J = torch.stack([
        torch.stack([d / cam.fu, zeros, x_n], dim=-1),
        torch.stack([zeros, d / cam.fv, y_n], dim=-1),
        torch.stack([zeros, zeros, torch.ones_like(d)], dim=-1),
    ], dim=-2)
    sd = depth_sigma(cam, d)
    Ruvd = torch.stack([torch.full_like(d, cam.sigma_u) ** 2,
                        torch.full_like(d, cam.sigma_v) ** 2,
                        sd * sd], dim=-1)
    return torch.einsum("...ij,...j,...kj->...ik", J, Ruvd, J)


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


def information_matrix(cam: CameraConfig, uv, depth):
    """Per-feature 3×3 information = covariance⁻¹."""
    return inv3x3(point_covariance(cam, uv, depth))


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


def _direction_scaled_covariance(cov, direction, scale: float):
    d = direction / torch.clamp(
        torch.linalg.norm(direction, dim=-1, keepdim=True), min=1e-9)
    P = torch.einsum("...i,...j->...ij", d, d)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    S = eye - (1.0 - scale) * P
    return torch.einsum("...ij,...jk,...lk->...il", S, cov, S)


def normal_scaled_covariance(cov, normals, scale: float):
    """Anisotropic rescale along the surface normal: the uncertainty in the
    normal direction shrinks by ``scale``, the tangent plane keeps its own.

    cov: (...,3,3); normals: (...,3).
    """
    return _direction_scaled_covariance(cov, normals, scale)


def gradient_scaled_covariance(cov, grad_dir, scale: float):
    """Image-gradient-based anisotropy: confident across strong image
    gradients, uncertain along them. ``grad_dir`` is the in-image-plane 3D
    direction of the intensity gradient."""
    return _direction_scaled_covariance(cov, grad_dir, scale)


def strasdat_information(depth, weight: float = 1.0):
    """Depth-scaled isotropic information, ∝ 1/z⁴."""
    w = weight / torch.clamp(depth, min=1e-3) ** 4
    return w[..., None, None] * torch.eye(3, dtype=depth.dtype,
                                          device=depth.device)
