"""Hypothesis-parallel RANSAC for SE(3) from 3D-3D correspondences.

Port of ``putslam_tpu/frontend/ransac.py`` with the Euclidean error model
(``error_version=0``): a fixed batch of H hypotheses, each a
``used_pairs``-point sample drawn over the valid matches by prefix sum and
binary search, fitted at once with the batched Horn/Kabsch, scored by one
(H, N) masked error pass, then refitted on the inliers.

The uniforms of the sampler come from an explicit ``torch.Generator``, or
from ``u`` (shape (used_pairs, H)) so a test can hand both packages the
same draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from putslam_tpu_torch.config import CameraConfig, RansacConfig
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.ops import kabsch


class RansacResult(NamedTuple):
    pose: torch.Tensor          # (7,) best SE(3): q ≈ T · p
    inliers: torch.Tensor       # (N,) bool
    n_inliers: torch.Tensor     # () int32
    inlier_ratio: torch.Tensor  # () float32 — inliers / valid matches
    ok: torch.Tensor            # () bool — False → identity fallback applied


def _pair_errors(cfg: RansacConfig, T, p, q):
    """Euclidean error per (hypothesis, pair): T (..., 7); p, q (N, 3).
    Returns (..., N)."""
    if cfg.error_version != 0:
        raise NotImplementedError(
            f"ransac.error_version={cfg.error_version} is not ported yet")
    x, y, z = se3.apply_soa(T[..., None, :], p[..., 0], p[..., 1], p[..., 2])
    dx, dy, dz = x - q[..., 0], y - q[..., 1], z - q[..., 2]
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


def draw_uniforms(cfg: RansacConfig, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """(used_pairs, H) uniforms in [0, 1) for one RANSAC call."""
    return torch.rand((cfg.used_pairs, cfg.n_hypotheses), generator=generator,
                      device=device)


def estimate(cfg: RansacConfig, cam: Optional[CameraConfig], p, q, valid,
             u: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> RansacResult:
    """Estimate T with q ≈ T·p from masked correspondences p, q (N, 3);
    ``valid`` (N,) bool. ``u``: optional (used_pairs, H) uniforms, else
    drawn from ``generator``."""
    if cfg.quality_tau > 0.0:
        raise NotImplementedError("ransac.quality_tau > 0 is not ported yet")
    N = p.shape[0]
    thr = cfg.inlier_threshold_euclidean
    n_valid = torch.sum(valid)

    csum = torch.cumsum(valid.to(p.dtype), dim=0)
    total = torch.clamp(csum[-1], min=1e-9)
    if u is None:
        u = draw_uniforms(cfg, generator, p.device)
    sample_idx = torch.searchsorted(csum, (u * total).contiguous(), right=False)
    sample_idx = torch.clamp(sample_idx, 0, N - 1)          # (k, H)

    T = kabsch.kabsch_soa(p[:, 0][sample_idx], p[:, 1][sample_idx],
                          p[:, 2][sample_idx], q[:, 0][sample_idx],
                          q[:, 1][sample_idx], q[:, 2][sample_idx])  # (H, 7)

    err = _pair_errors(cfg, T, p, q)                        # (H, N)
    inl = (err < thr) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    mean_err = torch.sum(torch.where(inl, err, torch.zeros_like(err)), dim=-1) \
        / torch.clamp(counts, min=1)
    score = counts.to(torch.float32) - mean_err / (torch.max(mean_err) + 1e-6)
    best = torch.argmax(score)
    T_best = T[best]
    inl_best = inl[best]

    for _ in range(cfg.refit_iterations):
        T_n = kabsch.weighted_kabsch(p, q, inl_best.to(p.dtype))
        inl_n = (_pair_errors(cfg, T_n, p, q) < thr) & valid
        better = torch.sum(inl_n) >= torch.sum(inl_best)
        T_best = torch.where(better, T_n, T_best)
        inl_best = torch.where(better, inl_n, inl_best)

    n_inl = torch.sum(inl_best)
    ratio = n_inl.to(torch.float32) / torch.clamp(n_valid, min=1).to(torch.float32)
    ok = (ratio >= cfg.minimal_inlier_ratio) & (n_valid >= cfg.minimal_num_matches)
    pose = torch.where(ok, T_best, se3.identity(dtype=p.dtype, device=p.device))
    return RansacResult(pose, inl_best & ok, n_inl.to(torch.int32), ratio, ok)
