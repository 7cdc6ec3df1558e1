"""The hand-written FAST-9 + NMS kernel's layout, checks and launch.

The kernel (``csrc/fast_score_nms.cu``, built and bound by
``utils/cuda_lib.py``) replaces the JAX package's Pallas kernel
``putslam_tpu/ops/fast_pallas.py::fast_score_nms``.

``fast_score_nms_levels`` takes all pyramid levels of a frame and makes
**one** launch for them: one flat grid walks the tiles of every level
(``tile_layout``), and one ``torch.empty`` holds every output
(``output_layout``). ``fast_score_nms`` is its one-level case. A CPU tensor
goes through the plain PyTorch version (``ops/fast.py``), a CUDA tensor
launches the kernel or raises. The launch counts one on the card
(``_LIB.launch_count()``; not under ``cuda_lib.uncounted()``), a launch
recorded into a CUDA graph one a replay.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from putslam_tpu_torch.utils import cuda_lib

MAX_RADIUS = 16
MAX_LEVELS = 8
# output tile of one block (checked against the library when it is loaded)
TILE_W, TILE_H = 32, 24
# every output map starts on a multiple of this many floats in the one
# output buffer, so that a level whose rows allow 16-byte stores gets them
OUT_ALIGN = 32


def _bind(lib) -> None:
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.fast_score_nms_levels_launch.argtypes = [
        ctypes.c_int, ptrs, ptrs, ptrs, ints, ints, ints, ints, ints,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.fast_score_nms_levels_launch.restype = ctypes.c_int


_LIB = cuda_lib.Library("fast_score_nms", _bind,
                        constants={"tile_w": TILE_W, "tile_h": TILE_H})


@functools.lru_cache(maxsize=64)
def tile_layout(shapes: Tuple[Tuple[int, int], ...], tile_w: int = TILE_W,
                tile_h: int = TILE_H):
    """The flat grid over the tiles of every level, level 0 first: per level
    the tiles in one row of tiles and the index of its first tile, and the
    number of tiles in all. ``shapes`` is a tuple of (H, W)."""
    tiles_x, first_tile, total = [], [], 0
    for H, W in shapes:
        nx, ny = -(-W // tile_w), -(-H // tile_h)
        tiles_x.append(nx)
        first_tile.append(total)
        total += nx * ny
    return tuple(tiles_x), tuple(first_tile), total


def tile_origin(shapes, block: int, tile_w: int = TILE_W,
                tile_h: int = TILE_H) -> Tuple[int, int, int]:
    """(level, y0, x0) of the tile that block ``block`` of the flat grid
    works on: the kernel's own mapping, in Python."""
    tiles_x, first_tile, total = tile_layout(tuple(shapes), tile_w, tile_h)
    if not 0 <= block < total:
        raise IndexError(f"block {block} outside the grid of {total} tiles")
    level = max(i for i, f in enumerate(first_tile) if block >= f)
    ty, tx = divmod(block - first_tile[level], tiles_x[level])
    return level, ty * tile_h, tx * tile_w


@functools.lru_cache(maxsize=64)
def output_layout(shapes: Tuple[Tuple[int, int], ...]):
    """Offsets, in floats, of each level's raw map and NMS map in the one
    output buffer (each a multiple of OUT_ALIGN), and the buffer's size."""
    raw, nms, total = [], [], 0
    for offsets in (raw, nms):
        for H, W in shapes:
            offsets.append(total)
            total += -(-(H * W) // OUT_ALIGN) * OUT_ALIGN
    return tuple(raw), tuple(nms), total


def _access_width(W: int, *ptrs: int) -> int:
    """Floats per memory access a level allows: 4 (16 bytes) or 2 where the
    row pitch and every pointer are so aligned, else 1."""
    for vec in (4, 2):
        if W % vec == 0 and all(p % (4 * vec) == 0 for p in ptrs):
            return vec
    return 1


def _check_levels(levels, nms_radius, what):
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{what}: need 1 to {MAX_LEVELS} levels, got "
                         f"{len(levels)}")
    if not 0 <= int(nms_radius) <= MAX_RADIUS:
        raise ValueError(f"{what}: nms_radius must be in [0, {MAX_RADIUS}], "
                         f"got {nms_radius}")
    dev = levels[0].device
    for g in levels:
        if g.device != dev:
            raise ValueError(f"{what}: levels on different devices "
                             f"({dev}, {g.device})")
        if g.dtype != torch.float32 or g.dim() != 2:
            raise ValueError(f"{what}: need 2-D float32 tensors, got "
                             f"{tuple(g.shape)} {g.dtype}")
        if not g.is_contiguous():
            raise ValueError(f"{what}: every level must be contiguous")


def launch_levels(levels: Sequence[torch.Tensor], threshold: float,
                  nms_radius: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The CUDA path of ``fast_score_nms_levels``: checks the levels, makes
    the one output buffer and the one launch."""
    what = "fast_score_nms_levels"
    _check_levels(levels, nms_radius, what)
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    shapes = tuple((int(g.shape[0]), int(g.shape[1])) for g in levels)
    tiles_x, first_tile, total = tile_layout(shapes)
    raw_off, nms_off, size = output_layout(shapes)
    out = torch.empty(size, dtype=torch.float32, device=dev)
    maps = [(out[r:r + H * W].view(H, W), out[m:m + H * W].view(H, W))
            for (H, W), r, m in zip(shapes, raw_off, nms_off)]
    n = len(levels)
    gray_p = [g.data_ptr() for g in levels]
    raw_p = [raw.data_ptr() for raw, _ in maps]
    nms_p = [nms.data_ptr() for _, nms in maps]
    vec = [_access_width(W, *p) for (_, W), *p in
           zip(shapes, gray_p, raw_p, nms_p)]
    ptr_arr, int_arr = ctypes.c_void_p * n, ctypes.c_int * n
    with torch.cuda.device(dev):
        lib = _LIB.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        _LIB.check(lib.fast_score_nms_levels_launch(
            n, ptr_arr(*gray_p), ptr_arr(*raw_p), ptr_arr(*nms_p),
            int_arr(*(H for H, _ in shapes)), int_arr(*(W for _, W in shapes)),
            int_arr(*tiles_x), int_arr(*first_tile), int_arr(*vec), total,
            float(threshold), int(nms_radius), cuda_lib.counted(), stream),
            f"{what} kernel launch")
    return maps


def fast_score_nms_levels(levels: Sequence[torch.Tensor], threshold: float,
                          nms_radius: int
                          ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every level (H_l, W_l) float32 in [0, 1] → [(raw, nms), ...]: per
    level the FAST-9 score map and its (2r+1)² non-maximum suppression,
    bit-exact with ``ops.fast.fast_score_map`` / ``ops.fast.nms``. CUDA
    levels: one kernel launch for all of them, the maps are views of one
    buffer. CPU levels: the plain version, level by level."""
    levels = list(levels)
    if levels and all(g.device.type == "cpu" for g in levels):
        from putslam_tpu_torch.ops import fast

        out = []
        for g in levels:
            raw = fast.fast_score_map(g, threshold)
            out.append((raw, fast.nms(raw, nms_radius)))
        return out
    return launch_levels(levels, threshold, nms_radius)


def fast_score_nms(gray: torch.Tensor, threshold: float, nms_radius: int):
    """(H, W) float32 intensities in [0, 1] → (raw, nms), both (H, W)
    float32: the one-level case of ``fast_score_nms_levels``."""
    return fast_score_nms_levels([gray], threshold, nms_radius)[0]

