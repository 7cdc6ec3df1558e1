"""Hypothesis-parallel RANSAC for SE(3) from 3D-3D correspondences.

Port of ``putslam_tpu/frontend/ransac.py``: a fixed batch of H hypotheses,
each a ``used_pairs``-point sample drawn over the valid matches by prefix
sum and binary search (weighted by match quality when ``quality_tau > 0``),
fitted at once with the batched Horn/Kabsch, scored by one (H, N) masked
error pass, then refitted on the inliers. On the card the fits and the
scores of all hypotheses are one launch (``ops/ransac_score.py::
hypotheses``) and each refit's score another (``score``); on the CPU their
plain versions. Error models: Euclidean
(``error_version`` 0), reprojection (1), both (2), Mahalanobis with the
per-pair information matrices (3), depth-scaled Euclidean (4).

The uniforms of the sampler come from an explicit ``torch.Generator``, or
from ``u`` (shape (used_pairs, H)) so a test can hand both packages the
same draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from putslam_tpu_torch.config import CameraConfig, RansacConfig
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.ops import kabsch, ransac_score
from putslam_tpu_torch.utils.indexing import take_row


class RansacResult(NamedTuple):
    pose: torch.Tensor          # (7,) best SE(3): q ≈ T · p
    inliers: torch.Tensor       # (N,) bool
    n_inliers: torch.Tensor     # () int32
    inlier_ratio: torch.Tensor  # () float32 — inliers / valid matches
    ok: torch.Tensor            # () bool — False → identity fallback applied


def draw_uniforms(cfg: RansacConfig, generator: Optional[torch.Generator],
                  device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(used_pairs, H) uniforms in [0, 1) for one RANSAC call; ``out``: a
    buffer of that shape to draw into (the same numbers)."""
    return torch.rand((cfg.used_pairs, cfg.n_hypotheses), generator=generator,
                      device=device, out=out)


def draw_named(cfg: RansacConfig, names, generator: Optional[torch.Generator],
               device, out: Optional[dict] = None) -> dict:
    """One (used_pairs, H) uniform tensor per name, drawn in the order of
    ``names``; ``out``: buffers of those names to draw into."""
    return {n: draw_uniforms(cfg, generator, device,
                             out=None if out is None else out[n])
            for n in names}


def sample_indices(cfg: RansacConfig, valid, u, quality=None,
                   dtype=torch.float32):
    """The sampler: each uniform of ``u`` picks a valid index by prefix sum
    and binary search, with replacement. The weights are 1 per valid match,
    or exp(−quality/τ) with ``cfg.quality_tau > 0`` and a ``quality``."""
    if cfg.quality_tau > 0.0 and quality is not None:
        wgt = torch.where(valid, torch.exp(-quality / cfg.quality_tau),
                          torch.zeros_like(quality))
    else:
        wgt = valid.to(dtype)
    csum = torch.cumsum(wgt, dim=0)
    total = torch.clamp(csum[-1], min=1e-9)
    idx = torch.searchsorted(csum, (u * total).contiguous(), right=False)
    return torch.clamp(idx, 0, valid.shape[0] - 1)


def estimate(cfg: RansacConfig, cam: Optional[CameraConfig], p, q, valid,
             u: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             quality: Optional[torch.Tensor] = None,
             info: Optional[torch.Tensor] = None) -> RansacResult:
    """Estimate T with q ≈ T·p from masked correspondences p, q (N, 3);
    ``valid`` (N,) bool. ``u``: optional (used_pairs, H) uniforms, else
    drawn from ``generator``. ``quality``: optional per-match distance
    (lower is better) that biases the sampling when ``cfg.quality_tau > 0``;
    ``info``: optional (N, 3, 3) information matrices for the Mahalanobis
    model."""
    n_valid = torch.sum(valid)
    if u is None:
        u = draw_uniforms(cfg, generator, p.device)
    sample_idx = sample_indices(cfg, valid, u, quality, p.dtype)  # (k, H)

    # as the kernels take them (no copy where they are so already)
    p, q, valid = p.contiguous(), q.contiguous(), valid.contiguous()
    info = None if info is None else info.contiguous()
    model = ransac_score.model_of(cfg, cam)
    # the gathered samples' fits and their (H, N) scores: one launch
    T, inl, counts, err_sum = ransac_score.hypotheses(
        p, q, valid, sample_idx, model, info)
    mean_err = err_sum / torch.clamp(counts, min=1)
    score = counts.to(torch.float32) - mean_err / (torch.max(mean_err) + 1e-6)
    best = torch.argmax(score)
    T_best = take_row(T, best)
    inl_best = take_row(inl, best)
    n_best = take_row(counts, best)

    for _ in range(cfg.refit_iterations):
        T_n = kabsch.weighted_kabsch(p, q, inl_best.to(p.dtype))
        inl_n, n_n, _ = ransac_score.score(T_n[None], p, q, valid, model,
                                           info)
        better = n_n[0] >= n_best
        T_best = torch.where(better, T_n, T_best)
        inl_best = torch.where(better, inl_n[0], inl_best)
        n_best = torch.where(better, n_n[0], n_best)

    n_inl = n_best
    ratio = n_inl.to(torch.float32) / torch.clamp(n_valid, min=1).to(torch.float32)
    ok = (ratio >= cfg.minimal_inlier_ratio) & (n_valid >= cfg.minimal_num_matches)
    pose = torch.where(ok, T_best, se3.identity(dtype=p.dtype, device=p.device))
    return RansacResult(pose, inl_best & ok, n_inl.to(torch.int32), ratio, ok)
