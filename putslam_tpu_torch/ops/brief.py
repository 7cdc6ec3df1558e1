"""Oriented binary descriptors (steered BRIEF, LDB), batched — torch port.

Port of ``putslam_tpu/ops/brief.py``. The numpy bank functions are copied
verbatim, so the fused (P², 24·256 + 2) constant of either kind — the
blurred test columns (``"brief"``: rotated point-pair tests; ``"ldb"``:
cell-average intensity and gradient tests of 2×2, 3×3 and 4×4 griddings)
plus the two orientation-moment columns — is byte-equal to the JAX
package's. ``describe_patches`` is one bf16 matmul with bf16 output
rounding (as the reference's ``preferred_element_type=bfloat16``), the
orientation from its last two columns, and a per-keypoint bin select.
``steered_brief`` does the same for angles handed in, on the unblurred
bank. The numpy banks are built once per process and kind
(``convert.brief_bank`` keeps the device copies).
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


LDB_RADIUS = 13.0  # cells live inside this disc (fits rotated in the patch)


def _ldb_cell_weights(grid: int, theta: float) -> np.ndarray:
    """(grid², P*P) normalised membership masks of a grid×grid tiling of the
    square [-r, r]², rotated by theta."""
    c, s = np.cos(theta), np.sin(theta)
    xr = c * _XREL_NP + s * _YREL_NP
    yr = -s * _XREL_NP + c * _YREL_NP
    r = LDB_RADIUS
    cell_w = 2 * r / grid
    ix = np.floor((xr + r) / cell_w).astype(np.int64)
    iy = np.floor((yr + r) / cell_w).astype(np.int64)
    inside = (xr >= -r) & (xr < r) & (yr >= -r) & (yr < r)
    W = np.zeros((grid * grid, PATCH * PATCH), np.float32)
    flat_cell = (iy * grid + ix).reshape(-1)
    flat_in = inside.reshape(-1)
    for pix in range(PATCH * PATCH):
        if flat_in[pix]:
            W[flat_cell[pix], pix] += 1.0
    W /= np.maximum(W.sum(axis=1, keepdims=True), 1.0)
    return W


def _shift_matrix(dx: int, dy: int) -> np.ndarray:
    """(P², P²): (S @ patch_flat)[y, x] = patch[y+dy, x+dx], edges clamped."""
    S = np.zeros((PATCH * PATCH, PATCH * PATCH), np.float32)
    for y in range(PATCH):
        for x in range(PATCH):
            ys, xs = min(max(y + dy, 0), PATCH - 1), min(max(x + dx, 0), PATCH - 1)
            S[y * PATCH + x, ys * PATCH + xs] = 1.0
    return S


def _make_ldb_bank() -> np.ndarray:
    """(P*P, N_BINS*256): LDB tests per orientation bin. Test set: all cell
    pairs of the 2×2 and 3×3 griddings and a fixed subset of the 4×4
    gridding, with intensity/dx/dy channels interleaved, truncated to 256."""
    Sdx = _shift_matrix(1, 0) - _shift_matrix(-1, 0)
    Sdy = _shift_matrix(0, 1) - _shift_matrix(0, -1)
    bank = np.zeros((PATCH * PATCH, N_BINS * DESC_BITS), np.float32)
    rng = np.random.default_rng(5)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        cols = []
        for grid in (2, 3, 4):
            W = _ldb_cell_weights(grid, th)           # (g², P²)
            n = W.shape[0]
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
            if grid == 4:
                sel = rng.permutation(len(pairs))[:44]
                pairs = [pairs[k] for k in sel]
            for (i, j) in pairs:
                d = W[i] - W[j]
                cols.append(d)                         # intensity
                cols.append(d @ Sdx * 0.5)             # mean dx
                cols.append(d @ Sdy * 0.5)             # mean dy
        cols = np.stack(cols[:DESC_BITS], axis=1)      # (P², 256)
        bank[:, b * DESC_BITS:(b + 1) * DESC_BITS] = cols
    return bank


KINDS = ("brief", "ldb")
_TEST_BANKS: dict = {}
_FUSED_BANKS: dict = {}


def make_test_bank(kind: str = "brief") -> np.ndarray:
    """(P*P, N_BINS*256) float32 unblurred test columns of ``kind``, built
    once per process (the LDB bank takes about a second of numpy)."""
    if kind not in KINDS:
        raise NotImplementedError(
            f"detector.descriptor={kind!r} is not known (one of {KINDS})")
    if kind not in _TEST_BANKS:
        _TEST_BANKS[kind] = (_make_steer_bank() if kind == "brief"
                             else _make_ldb_bank())
    return _TEST_BANKS[kind]


def make_fused_bank(kind: str = "brief") -> np.ndarray:
    """(P*P, N_BINS*256 + 2) float32: the test columns of ``kind`` composed
    with the box blur, then the two unblurred moment columns."""
    if kind not in _FUSED_BANKS:
        bank = _blur_matrix().T @ make_test_bank(kind)
        _FUSED_BANKS[kind] = np.concatenate([bank, _make_moment_cols()],
                                            axis=1)
    return _FUSED_BANKS[kind]


def box_blur(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Separable box blur of an (H, W) image with zero padding (BRIEF's
    pre-smoothing; ``putslam_tpu/ops/brief.py:53``). The descriptor path
    folds the same smoothing, edge taps clamped, into its bank
    (``_blur_matrix``)."""
    w = 2 * radius + 1
    k = torch.full((w,), 1.0 / w, dtype=img.dtype, device=img.device)
    x = torch.nn.functional.conv2d(img[None, None], k.view(1, 1, w, 1),
                                   padding=(radius, 0))
    x = torch.nn.functional.conv2d(x, k.view(1, 1, 1, w), padding=(0, radius))
    return x[0, 0]


def orientations(patches: torch.Tensor) -> torch.Tensor:
    """ORB intensity-centroid angle per patch, θ = atan2(m01, m10) over the
    radius-15 disc (``putslam_tpu/ops/brief.py:83``). The descriptor path
    reads the same moments from the bank's last two columns.
    patches (N, P, P) → (N,) radians."""
    disc = torch.as_tensor(_DISC, dtype=patches.dtype, device=patches.device)
    w = patches * disc
    m10 = torch.sum(w * torch.as_tensor(_XREL_NP, dtype=patches.dtype,
                                        device=patches.device), dim=(-1, -2))
    m01 = torch.sum(w * torch.as_tensor(_YREL_NP, dtype=patches.dtype,
                                        device=patches.device), dim=(-1, -2))
    return torch.atan2(m01, m10)


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


def _select_bits(diffs: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """(N, N_BINS·256) test responses → the ±1 int8 bits of each keypoint's
    orientation bin."""
    N = diffs.shape[0]
    tau = torch.remainder(angles, 2.0 * np.pi)
    bins = torch.round(tau / (2.0 * np.pi / N_BINS)).to(torch.int64) % N_BINS
    diffs = diffs.reshape(N, N_BINS, DESC_BITS)
    sel = diffs[torch.arange(N, device=diffs.device), bins].float()
    one = torch.ones((), dtype=torch.int8, device=diffs.device)
    return torch.where(sel > 0, one, -one)


def patch_matrix(patches: torch.Tensor) -> torch.Tensor:
    """(N, P, P) float32 patches → the (N, P·P) bfloat16 operand of the
    descriptor product, rounded to nearest even."""
    return patches.reshape(patches.shape[0], PATCH * PATCH).to(torch.bfloat16)


def describe_patches(patches: torch.Tensor, kind: str = "brief"):
    """(N, P, P) raw patches, or their (N, P·P) bfloat16 matrix
    (``patch_matrix``; the detector's keypoint chain writes it directly) →
    (desc (N, 256) int8 ±1, angles (N,))."""
    from putslam_tpu_torch.convert import brief_bank

    bank = brief_bank(patches.device, kind)
    flat = patch_matrix(patches) if patches.dim() == 3 else patches
    out = flat @ bank                                  # bf16 output rounding
    ang = torch.atan2(out[:, -1].float(), out[:, -2].float())
    return _select_bits(out[:, :N_BINS * DESC_BITS], ang), ang


def steered_brief(patches: torch.Tensor, angles: torch.Tensor,
                  kind: str = "brief") -> torch.Tensor:
    """256-bit steered binary descriptors as ±1 int8 for ``angles`` handed
    in, from the unblurred test bank (``describe_patches`` derives the angle
    from the same matmul and is the path the detector takes)."""
    from putslam_tpu_torch.convert import brief_bank

    bank = brief_bank(patches.device, kind, fused=False)
    return _select_bits(patch_matrix(patches) @ bank, angles)


def describe(img: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
             smooth_radius: int = 2, kind: str = "brief"):
    """Raw patches → fused orientation + descriptor (the pre-smoothing lives
    inside the bank; ``smooth_radius`` is kept for the signature, radius 2
    is baked in). Returns (desc (N, 256) int8 ±1, angles (N,)); invalid
    keypoints get zero descriptors."""
    desc, ang = describe_patches(extract_patches(img, uv), kind)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc)), ang


def pack_bits(desc_pm1: torch.Tensor) -> torch.Tensor:
    """±1 int8 (N, 256) → packed (N, 8) words, bit j of word w = test
    32·w + j. torch has no uint32 arithmetic, so the words are int64 holding
    the unsigned 32-bit values."""
    bits = (desc_pm1 > 0).to(torch.int64).reshape(desc_pm1.shape[0], 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=desc_pm1.device)
    return torch.sum(bits << shifts[None, None, :], dim=-1)
