"""Batched SE(2) pose math + a planar pose-graph Gauss-Newton solver.

Port of ``putslam_tpu/geometry/se2.py:20-123`` (the reference's
``VertexSE2`` / ``EdgeSE2`` graph types, putslam_defs.h:244-529). A pose is
``(..., 3)`` = [x, y, θ]; the whole graph optimizes in one batched
Gauss-Newton pass with the normal equations built as a dense (3K, 3K)
system.

The Jacobians stay numeric forward differences (``eps = 1e-5`` in float32,
perturbing the gathered endpoints), as in the JAX package: an analytic
Jacobian would follow other iterates. The differences divide the last bits
of ``sin`` / ``cos`` by ``eps``, so the two packages agree on the converged
poses, not on each iteration's chi².
"""

from __future__ import annotations

from typing import Tuple

import torch


def identity(batch_shape=(), dtype=torch.float32, device=None):
    return torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)


def _wrap(theta):
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def compose(a, b):
    """a ∘ b (apply b then a)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    return torch.stack([x, y, _wrap(a[..., 2] + b[..., 2])], dim=-1)


def inverse(p):
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = -(c * p[..., 0] + s * p[..., 1])
    y = -(-s * p[..., 0] + c * p[..., 1])
    return torch.stack([x, y, _wrap(-p[..., 2])], dim=-1)


def relative(a, b):
    """a⁻¹ ∘ b."""
    return compose(inverse(a), b)


def apply(p, pts):
    """Transform points (..., 2) by poses (..., 3)."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = c * pts[..., 0] - s * pts[..., 1] + p[..., 0]
    y = s * pts[..., 0] + c * pts[..., 1] + p[..., 1]
    return torch.stack([x, y], dim=-1)


def _edge_residual(pi, pj, z):
    """r = z⁻¹ ∘ (pi⁻¹ ∘ pj) as a 3-vector [dx, dy, dθ]."""
    return relative(z, relative(pi, pj))


def optimize_pose_graph(poses: torch.Tensor, edges: Tuple[torch.Tensor, ...],
                        fixed: torch.Tensor, iterations: int = 10
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planar pose-graph Gauss-Newton: ``poses`` (K, 3), ``edges`` = (i (E,),
    j (E,), z (E, 3), w (E,)), ``fixed`` (K,) bool gauge mask. Returns
    (poses', chi2 (iterations,)), the chi² of each iteration's starting
    poses. ``iterations`` run with no host synchronisation. Callers keep
    i != j (planar graphs never self-loop)."""
    K = poses.shape[0]
    ei, ej, ez, ew = edges
    ei = ei.long()
    ej = ej.long()
    dt, dev = poses.dtype, poses.device
    eps = 1e-5
    frozen3 = torch.repeat_interleave(fixed, 3)
    frozen2d = frozen3[:, None] | frozen3[None, :]
    eye = torch.eye(3 * K, dtype=dt, device=dev)
    axes = eps * torch.eye(3, dtype=dt, device=dev)
    chi2s = []
    for _ in range(iterations):
        pi = poses[ei]
        pj = poses[ej]
        r0 = _edge_residual(pi, pj, ez)                        # (E, 3)
        chi2s.append(torch.sum(ew * torch.sum(r0 * r0, dim=-1)))
        # numeric Jacobians w.r.t. the two endpoints (E, 3, 3): perturb the
        # GATHERED endpoint poses per axis (a perturbation of the pose array
        # would leak into the other endpoint where vertices share edges)
        Ji = torch.stack([(_edge_residual(pi + axes[a], pj, ez) - r0) / eps
                          for a in range(3)], dim=-1)
        Jj = torch.stack([(_edge_residual(pi, pj + axes[a], ez) - r0) / eps
                          for a in range(3)], dim=-1)
        # the scatters of .at[].add: duplicates summed (on CUDA sorted by
        # index first, so the same order on every run)
        H = torch.zeros((K, K, 3, 3), dtype=dt, device=dev)
        for r, c, Ja, Jb in ((ei, ei, Ji, Ji), (ej, ej, Jj, Jj),
                             (ei, ej, Ji, Jj), (ej, ei, Jj, Ji)):
            H.index_put_((r, c), torch.einsum("e,eri,erj->eij", ew, Ja, Jb),
                         accumulate=True)
        b = torch.zeros((K, 3), dtype=dt, device=dev)
        b.index_put_((ei,), -torch.einsum("e,eri,er->ei", ew, Ji, r0),
                     accumulate=True)
        b.index_put_((ej,), -torch.einsum("e,eri,er->ei", ew, Jj, r0),
                     accumulate=True)

        Hd = H.permute(0, 2, 1, 3).reshape(3 * K, 3 * K)
        Hd = torch.where(frozen2d, torch.zeros_like(Hd), Hd)
        Hd = Hd + torch.diag(frozen3.to(dt))
        Hd = Hd + 1e-6 * eye
        bv = torch.where(frozen3, torch.zeros_like(b.reshape(-1)),
                         b.reshape(-1))
        # a failed factorisation gives NaN, as jax.scipy's cho_factor does,
        # which the isfinite guard zeroes: no host check of the status
        L, info = torch.linalg.cholesky_ex(Hd)
        L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
        dx = torch.cholesky_solve(bv[:, None], L)[:, 0].reshape(K, 3)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        new = poses + torch.where(fixed[:, None], torch.zeros_like(dx), dx)
        poses = torch.cat([new[:, :2], _wrap(new[:, 2:3])], dim=1)
    chi2 = torch.stack(chi2s) if chi2s else torch.zeros((0,), dtype=dt,
                                                        device=dev)
    return poses, chi2
