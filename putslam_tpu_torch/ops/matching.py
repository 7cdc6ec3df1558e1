"""Descriptor matching as matmuls — port of ``putslam_tpu/ops/matching.py``.

With ±1 int8 descriptors, dot(a, b) = 256 − 2·hamming, so one float32
matmul (exact: integer sums ≤ 256) scores every pair; cross-check is two
argmins, which return the first minimum as ``jnp.argmin`` does; the ratio
test takes its two nearest by a stable sort, so equal distances come lowest
index first as ``lax.top_k`` gives them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_DIST = 1e9


def hamming_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """Pairwise Hamming distances (N, M) float32; invalid rows/cols get
    INVALID_DIST."""
    bits = desc_a.shape[-1]
    dots = desc_a.float() @ desc_b.float().T
    dist = 0.5 * (bits - dots)
    big = torch.full_like(dist, INVALID_DIST)
    if valid_a is not None:
        dist = torch.where(valid_a[:, None], dist, big)
    if valid_b is not None:
        dist = torch.where(valid_b[None, :], dist, big)
    return dist


class Matches(NamedTuple):
    idx_b: torch.Tensor    # (N,) int32 — matched column per row of A
    dist: torch.Tensor     # (N,) float32
    valid: torch.Tensor    # (N,) bool — cross-checked & distance-gated


def mutual_nn(dist, max_dist: float) -> Matches:
    """(i, j) match iff j = argmin d[i, :], i = argmin d[:, j] and
    d[i, j] <= max_dist."""
    j_best = torch.argmin(dist, dim=1)
    i_best = torch.argmin(dist, dim=0)
    d_best = torch.gather(dist, 1, j_best[:, None])[:, 0]
    mutual = i_best[j_best] == torch.arange(dist.shape[0], device=dist.device)
    return Matches(j_best.to(torch.int32), d_best, mutual & (d_best <= max_dist))


def ratio_test(dist, ratio: float, max_dist: float) -> Matches:
    """Lowe-style acceptance: the best match must beat the second best by
    ``ratio`` and pass the distance gate."""
    top2, idx2 = torch.sort(dist, dim=1, stable=True)
    d1, d2 = top2[:, 0], top2[:, 1]
    valid = (d1 <= max_dist) & (d1 <= ratio * torch.clamp(d2, min=1e-6))
    return Matches(idx2[:, 0].to(torch.int32), d1, valid)


def gather_pairs(xyz_a, xyz_b, m: Matches):
    """Matched 3D point pairs (both (N, 3)); rows with ``m.valid`` False are
    garbage and must stay masked downstream."""
    return xyz_a, xyz_b[m.idx_b.long()]
