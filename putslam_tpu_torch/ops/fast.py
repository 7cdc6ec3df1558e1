"""FAST-9 corner detection: score map, NMS, grid cap, sub-pixel refine.

Port of ``putslam_tpu/ops/fast.py``. ``fast_score_map`` + ``nms`` are the
plain PyTorch version of the FAST kernel; ``detect`` takes the score map and
its NMS from ``ops.fast_cuda``, which launches the hand-written CUDA kernel
for CUDA tensors (one launch for all pyramid levels of a frame through
``fast_score_nms_levels``) and runs the plain version for CPU tensors. All
outputs are fixed-capacity tensors + validity masks.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — the 16 FAST offsets in clockwise order.
FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _shift2d(img, dx: int, dy: int):
    """result[y, x] = img[y+dy, x+dx], zero outside the image."""
    H, W = img.shape
    core = img[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return F.pad(core, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))


def fast_score_map(gray: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 response of every pixel of ``gray`` (H, W) in [0, 1];
    ``threshold`` on the 0..255 scale. 0 where the segment test fails and
    within 3 px of the border."""
    img = gray * 255.0
    t = float(threshold)
    mask_b = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    mask_d = torch.zeros_like(mask_b)
    excess_b = torch.zeros_like(img)
    excess_d = torch.zeros_like(img)
    for k, (dx, dy) in enumerate(FAST_OFFSETS):
        diff = _shift2d(img, dx, dy) - img
        mask_b = mask_b | ((diff > t).to(torch.int32) << k)
        mask_d = mask_d | ((diff < -t).to(torch.int32) << k)
        excess_b = excess_b + torch.clamp(diff - t, min=0.0)
        excess_d = excess_d + torch.clamp(-diff - t, min=0.0)
    is_bright = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    is_dark = torch.zeros_like(is_bright)
    for s in range(16):
        arc = ((0x1FF << s) | (0x1FF >> (16 - s))) & 0xFFFF
        is_bright = is_bright | ((mask_b & arc) == arc)
        is_dark = is_dark | ((mask_d & arc) == arc)
    zero = torch.zeros_like(img)
    score = torch.where(is_bright, excess_b, zero) + torch.where(
        is_dark, excess_d, zero)
    H, W = gray.shape
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inside = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(inside, score, zero)


def nms(score: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep local maxima within a (2r+1)² window (−inf padding)."""
    w = 2 * radius + 1
    pooled = F.max_pool2d(score[None, None], w, stride=1, padding=radius)[0, 0]
    return torch.where((score >= pooled) & (score > 0.0), score,
                       torch.zeros_like(score))


def subtile_grid(H: int, W: int, grid_rows: int, grid_cols: int,
                 max_features: int) -> Tuple[int, int, int, int]:
    """``grid_topk``'s split of an (H, W) map: (subtile rows, subtile
    columns, subtile height, subtile width). Each grid cell is split m × m,
    m the ceiling of the square root of twice its share of
    ``max_features``."""
    k_cell = -(-max_features // (grid_rows * grid_cols)) * 2
    m = max(int(-(-(k_cell ** 0.5) // 1)), 1)
    nsh, nsw = grid_rows * m, grid_cols * m
    return nsh, nsw, -(-H // nsh), -(-W // nsw)


def grid_topk(score: torch.Tensor, grid_rows: int, grid_cols: int,
              max_features: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Subtile grid cap: one winner per subtile of an m×m split of each
    grid cell, then the global top-``max_features``. Ties go to the lower
    index, as ``lax.top_k`` / ``argmax`` do. Returns (uv (K,2) [u, v],
    response (K,), valid (K,)); invalid slots have response 0, uv −1."""
    H, W = score.shape
    nsh, nsw, sub_h, sub_w = subtile_grid(H, W, grid_rows, grid_cols,
                                          max_features)
    padded = F.pad(score, (0, sub_w * nsw - W, 0, sub_h * nsh - H))
    tiles = padded.reshape(nsh, sub_h, nsw, sub_w).permute(0, 2, 1, 3)
    tiles = tiles.reshape(nsh * nsw, sub_h * sub_w)
    tile_best = torch.amax(tiles, dim=1)
    tile_arg = torch.argmax(tiles, dim=1)      # first maximum, as jnp.argmax
    s = torch.arange(nsh * nsw, device=score.device)
    cy = (s // nsw) * sub_h + tile_arg // sub_w
    cx = (s % nsw) * sub_w + tile_arg % sub_w

    return _global_cap(tile_best, cx, cy, max_features)


def _global_cap(cand_score, cand_x, cand_y, max_features: int):
    """The global top-``max_features`` of the flat candidates, by a stable
    descending sort (equal scores lowest index first, as ``lax.top_k``),
    padded to ``max_features`` slots."""
    k = min(max_features, cand_score.shape[0])
    top_scores, order = torch.sort(cand_score, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], order[:k]
    uv = torch.stack([cand_x[top_idx].float(), cand_y[top_idx].float()],
                     dim=-1)
    valid = top_scores > 0.0
    uv = torch.where(valid[:, None], uv, torch.full_like(uv, -1.0))
    if k < max_features:
        pad = max_features - k
        uv = F.pad(uv, (0, 0, 0, pad), value=-1.0)
        top_scores = F.pad(top_scores, (0, pad))
        valid = F.pad(valid, (0, pad))
    return uv, torch.where(valid, top_scores, torch.zeros_like(top_scores)), valid


def grid_topk_exact(score: torch.Tensor, grid_rows: int, grid_cols: int,
                    max_features: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact per-cell top-k: every grid cell keeps its ``k_cell`` strongest
    responses (a stable descending sort of the whole cell, so ties and the
    zeros of an empty cell come lowest index first, as ``lax.top_k`` gives
    them), then the global top-``max_features``. Same outputs as
    ``grid_topk``."""
    H, W = score.shape
    k_cell = -(-max_features // (grid_rows * grid_cols)) * 2
    cell_h = -(-H // grid_rows)
    cell_w = -(-W // grid_cols)
    padded = F.pad(score, (0, cell_w * grid_cols - W, 0, cell_h * grid_rows - H))
    cells = padded.reshape(grid_rows, cell_h, grid_cols, cell_w)
    cells = cells.permute(0, 2, 1, 3).reshape(grid_rows * grid_cols,
                                              cell_h * cell_w)
    k_cell = min(k_cell, cell_h * cell_w)
    c_scores, c_arg = torch.sort(cells, dim=1, descending=True, stable=True)
    c_scores, c_arg = c_scores[:, :k_cell], c_arg[:, :k_cell]
    cidx = torch.arange(grid_rows * grid_cols, device=score.device)[:, None]
    cy = (cidx // grid_cols) * cell_h + c_arg // cell_w
    cx = (cidx % grid_cols) * cell_w + c_arg % cell_w
    return _global_cap(c_scores.reshape(-1), cx.reshape(-1), cy.reshape(-1),
                       max_features)


def subpixel_refine(score: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """3×3 parabola fit on the response map; offsets clamped to ±0.5 px."""
    H, W = score.shape
    u = torch.clamp(uv[:, 0].to(torch.int64), 1, W - 2)
    v = torch.clamp(uv[:, 1].to(torch.int64), 1, H - 2)

    def grab(du, dv):
        return score[v + dv, u + du]

    s_c = grab(0, 0)
    dx = 0.5 * (grab(1, 0) - grab(-1, 0))
    dy = 0.5 * (grab(0, 1) - grab(0, -1))
    dxx = grab(1, 0) - 2 * s_c + grab(-1, 0)
    dyy = grab(0, 1) - 2 * s_c + grab(0, -1)
    zero = torch.zeros_like(dx)
    ou = torch.where(torch.abs(dxx) > 1e-6, -dx / dxx, zero)
    ov = torch.where(torch.abs(dyy) > 1e-6, -dy / dyy, zero)
    return uv + torch.stack([torch.clamp(ou, -0.5, 0.5),
                             torch.clamp(ov, -0.5, 0.5)], dim=-1)


GRID_POLICIES = ("subtile", "exact")


def detect(gray: torch.Tensor, threshold: float, nms_radius: int,
           grid_rows: int, grid_cols: int, max_features: int,
           grid_policy: str = "subtile", maps=None):
    """FAST score + NMS → grid cap → sub-pixel refine on the raw score map.
    ``maps`` is this level's (raw, nms) pair where the caller already has it
    from the one launch over all levels of the frame; without it the level
    gets a launch of its own (the plain version on the CPU). Returns
    ``grid_policy``: "subtile" (one winner per subtile) or "exact" (per-cell
    top-k). Returns (uv (K,2), response (K,), valid (K,))."""
    if grid_policy not in GRID_POLICIES:
        raise NotImplementedError(
            f"detector.grid_policy={grid_policy!r} is not known "
            f"(one of {GRID_POLICIES})")
    if maps is None:
        from putslam_tpu_torch.ops.fast_cuda import fast_score_nms

        maps = fast_score_nms(gray, threshold, nms_radius)
    raw, s = maps
    cap = grid_topk if grid_policy == "subtile" else grid_topk_exact
    uv, resp, valid = cap(s, grid_rows, grid_cols, max_features)
    uv = torch.where(valid[:, None], subpixel_refine(raw, uv), uv)
    return uv, resp, valid
