"""Hypothesis-parallel RANSAC for SE(3) from 3D-3D correspondences.

Port of ``putslam_tpu/frontend/ransac.py``: a fixed batch of H hypotheses,
each a ``used_pairs``-point sample drawn over the valid matches by prefix
sum and binary search (weighted by match quality when ``quality_tau > 0``),
fitted at once with the batched Horn/Kabsch, scored by one (H, N) masked
error pass, then refitted on the inliers. Error models: Euclidean
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
from putslam_tpu_torch.ops import kabsch
from putslam_tpu_torch.utils.indexing import take_row


class RansacResult(NamedTuple):
    pose: torch.Tensor          # (7,) best SE(3): q ≈ T · p
    inliers: torch.Tensor       # (N,) bool
    n_inliers: torch.Tensor     # () int32
    inlier_ratio: torch.Tensor  # () float32 — inliers / valid matches
    ok: torch.Tensor            # () bool — False → identity fallback applied


def _pair_errors(cfg: RansacConfig, cam: Optional[CameraConfig], T, p, q,
                 info=None):
    """Per-pair error and threshold of the configured model. T (..., 7);
    p, q (N, 3); ``info``: optional symmetric (N, 3, 3) information
    matrices of the Mahalanobis model (only the upper triangle is read).
    Returns (err (..., N), thr: a float or a tensor that broadcasts)."""
    x, y, z = se3.apply_soa(T[..., None, :], p[..., 0], p[..., 1], p[..., 2])
    dx, dy, dz = x - q[..., 0], y - q[..., 1], z - q[..., 2]

    def reproj_err():
        zp = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        qz = q[..., 2]
        zo = torch.where(torch.abs(qz) < 1e-9, torch.full_like(qz, 1e-9), qz)
        du = cam.fu * (x / zp - q[..., 0] / zo)
        dv = cam.fv * (y / zp - q[..., 1] / zo)
        return torch.sqrt(du * du + dv * dv)

    if cfg.error_version == 0:
        return (torch.sqrt(dx * dx + dy * dy + dz * dz),
                cfg.inlier_threshold_euclidean)
    if cfg.error_version == 4:      # the threshold grows with depth
        return (torch.sqrt(dx * dx + dy * dy + dz * dz),
                cfg.inlier_threshold_euclidean
                * torch.clamp(q[..., 2], min=1.0))
    if cfg.error_version == 1:
        return reproj_err(), cfg.inlier_threshold_reprojection
    if cfg.error_version == 2:      # inlier iff both pass
        e1 = torch.sqrt(dx * dx + dy * dy + dz * dz)
        return torch.maximum(e1 / cfg.inlier_threshold_euclidean,
                             reproj_err() / cfg.inlier_threshold_reprojection
                             ), 1.0
    if cfg.error_version == 3:
        if info is None:
            err = dx * dx + dy * dy + dz * dz
        else:
            i00, i01, i02 = info[:, 0, 0], info[:, 0, 1], info[:, 0, 2]
            i11, i12, i22 = info[:, 1, 1], info[:, 1, 2], info[:, 2, 2]
            err = (i00 * dx * dx + i11 * dy * dy + i22 * dz * dz
                   + 2.0 * (i01 * dx * dy + i02 * dx * dz + i12 * dy * dz))
        return err, cfg.inlier_threshold_mahalanobis
    raise ValueError(f"unsupported error_version {cfg.error_version}")


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

    T = kabsch.kabsch_soa(p[:, 0][sample_idx], p[:, 1][sample_idx],
                          p[:, 2][sample_idx], q[:, 0][sample_idx],
                          q[:, 1][sample_idx], q[:, 2][sample_idx])  # (H, 7)

    err, thr = _pair_errors(cfg, cam, T, p, q, info)        # (H, N)
    inl = (err < thr) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    mean_err = torch.sum(torch.where(inl, err, torch.zeros_like(err)), dim=-1) \
        / torch.clamp(counts, min=1)
    score = counts.to(torch.float32) - mean_err / (torch.max(mean_err) + 1e-6)
    best = torch.argmax(score)
    T_best = take_row(T, best)
    inl_best = take_row(inl, best)

    pk, qk = p.contiguous(), q.contiguous()     # as the fit's kernel takes them
    for _ in range(cfg.refit_iterations):
        T_n = kabsch.weighted_kabsch(pk, qk, inl_best.to(p.dtype))
        err_n, thr_n = _pair_errors(cfg, cam, T_n, p, q, info)
        inl_n = (err_n < thr_n) & valid
        better = torch.sum(inl_n) >= torch.sum(inl_best)
        T_best = torch.where(better, T_n, T_best)
        inl_best = torch.where(better, inl_n, inl_best)

    n_inl = torch.sum(inl_best)
    ratio = n_inl.to(torch.float32) / torch.clamp(n_valid, min=1).to(torch.float32)
    ok = (ratio >= cfg.minimal_inlier_ratio) & (n_valid >= cfg.minimal_num_matches)
    pose = torch.where(ok, T_best, se3.identity(dtype=p.dtype, device=p.device))
    return RansacResult(pose, inl_best & ok, n_inl.to(torch.int32), ratio, ok)
