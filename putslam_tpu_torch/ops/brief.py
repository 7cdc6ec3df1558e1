"""Oriented binary descriptors (steered BRIEF), batched — torch port.

Port of ``putslam_tpu/ops/brief.py`` for ``descriptor="brief"``. The numpy
bank builders are copied verbatim, so the fused (P², 24·256 + 2) constant —
the blurred steered test columns plus the two orientation-moment columns —
is byte-equal to the JAX package's. ``describe_patches`` is one bf16
matmul with bf16 output rounding (as the reference's
``preferred_element_type=bfloat16``), the orientation from its last two
columns, and a per-keypoint bin select.
"""

from __future__ import annotations

import numpy as np
import torch

PATCH = 32
DESC_BITS = 256
TEST_SIGMA = 5.0
TEST_CLIP = 12.0
N_BINS = 24

_yy, _xx = np.mgrid[0:PATCH, 0:PATCH].astype(np.float32)
_cx = _cy = (PATCH - 1) / 2.0
_DISC = ((_xx - _cx) ** 2 + (_yy - _cy) ** 2 <= 15.0 ** 2).astype(np.float32)
_XREL_NP = _xx - _cx
_YREL_NP = _yy - _cy


def make_test_pattern(seed: int = 1234) -> np.ndarray:
    """The 256 (p, q) test-point pairs (256, 4) = [px, py, qx, qy]."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, TEST_SIGMA, size=(DESC_BITS, 4)).astype(np.float32)
    return np.clip(pts, -TEST_CLIP, TEST_CLIP)


def _bilinear_weight_matrix(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """(K,) patch-frame coords → (P*P, K) bilinear sampling matrix."""
    K = xs.shape[0]
    W = np.zeros((PATCH * PATCH, K), np.float32)
    px = np.clip(xs + _cx, 0.0, PATCH - 1.001)
    py = np.clip(ys + _cy, 0.0, PATCH - 1.001)
    x0 = np.floor(px).astype(np.int64)
    y0 = np.floor(py).astype(np.int64)
    dx = px - x0
    dy = py - y0
    for k in range(K):
        base = y0[k] * PATCH + x0[k]
        W[base, k] += (1 - dx[k]) * (1 - dy[k])
        W[base + 1, k] += dx[k] * (1 - dy[k])
        W[base + PATCH, k] += (1 - dx[k]) * dy[k]
        W[base + PATCH + 1, k] += dx[k] * dy[k]
    return W


def _make_steer_bank() -> np.ndarray:
    """(P*P, N_BINS*256): column (b, t) computes I(q_t) − I(p_t) under
    rotation by bin b's angle."""
    pat = make_test_pattern()
    bank = np.zeros((PATCH * PATCH, N_BINS * DESC_BITS), np.float32)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        c, s = np.cos(th), np.sin(th)
        rpx = c * pat[:, 0] - s * pat[:, 1]
        rpy = s * pat[:, 0] + c * pat[:, 1]
        rqx = c * pat[:, 2] - s * pat[:, 3]
        rqy = s * pat[:, 2] + c * pat[:, 3]
        Wp = _bilinear_weight_matrix(rpx, rpy)
        Wq = _bilinear_weight_matrix(rqx, rqy)
        bank[:, b * DESC_BITS:(b + 1) * DESC_BITS] = Wq - Wp
    return bank


def _make_moment_cols() -> np.ndarray:
    """(P*P, 2) columns of the ORB intensity-centroid moments (m10, m01)."""
    return np.stack([(_DISC * _XREL_NP).reshape(-1),
                     (_DISC * _YREL_NP).reshape(-1)], axis=1).astype(np.float32)


def _blur_matrix(radius: int = 2) -> np.ndarray:
    """(P², P²) separable box blur over flattened patches, edge taps
    clamped — folded into the test bank."""
    w = 2 * radius + 1
    B1 = np.zeros((PATCH, PATCH), np.float32)
    for i in range(PATCH):
        for d in range(-radius, radius + 1):
            B1[i, min(max(i + d, 0), PATCH - 1)] += 1.0 / w
    return np.kron(B1, B1)


def make_fused_bank() -> np.ndarray:
    """(P*P, N_BINS*256 + 2) float32: blurred steered test columns, then
    the two unblurred moment columns (``_get_fused_bank("brief")``)."""
    bank = _blur_matrix().T @ _make_steer_bank()
    return np.concatenate([bank, _make_moment_cols()], axis=1)


def extract_patches(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """One PATCH×PATCH window centred at each rounded keypoint, clamped
    into the image. uv (N, 2) [u, v] → (N, PATCH, PATCH)."""
    H, W = img.shape
    half = PATCH // 2
    u0 = torch.clamp(torch.round(uv[:, 0]).long() - half, 0, W - PATCH)
    v0 = torch.clamp(torch.round(uv[:, 1]).long() - half, 0, H - PATCH)
    r = torch.arange(PATCH, device=img.device)
    rows = (v0[:, None] + r[None, :])[:, :, None]
    cols = (u0[:, None] + r[None, :])[:, None, :]
    return img[rows, cols]


def describe_patches(patches: torch.Tensor):
    """(N, P, P) raw patches → (desc (N, 256) int8 ±1, angles (N,))."""
    from putslam_tpu_torch.convert import brief_bank

    N = patches.shape[0]
    bank = brief_bank(patches.device)
    flat = patches.reshape(N, PATCH * PATCH).to(torch.bfloat16)
    out = flat @ bank                                  # bf16 output rounding
    m10 = out[:, -2].float()
    m01 = out[:, -1].float()
    ang = torch.atan2(m01, m10)
    tau = torch.remainder(ang, 2.0 * np.pi)
    bins = torch.round(tau / (2.0 * np.pi / N_BINS)).to(torch.int64) % N_BINS
    diffs = out[:, :N_BINS * DESC_BITS].reshape(N, N_BINS, DESC_BITS)
    sel = diffs[torch.arange(N, device=patches.device), bins].float()
    one = torch.ones((), dtype=torch.int8, device=patches.device)
    return torch.where(sel > 0, one, -one), ang
