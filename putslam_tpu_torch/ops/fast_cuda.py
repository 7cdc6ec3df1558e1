"""Build, bind and launch the hand-written FAST-9 + NMS kernel.

The kernel (``csrc/fast_score_nms.cu``) replaces the JAX package's Pallas
kernel ``putslam_tpu/ops/fast_pallas.py::fast_score_nms``. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C entry
point and bound through ``ctypes``. The library is built at first use into
``putslam_tpu_torch/build/``, named by a hash of the source and the flags,
so a fresh checkout builds it on its first CUDA call and a changed source
rebuilds; what ``ptxas -v`` said of it is kept beside it (``build_log``).

``fast_score_nms_levels`` takes all pyramid levels of a frame and makes
**one** launch for them: one flat grid walks the tiles of every level
(``tile_layout``), and one ``torch.empty`` holds every output
(``output_layout``). ``fast_score_nms`` is its one-level case. A CPU tensor
goes through the plain PyTorch version (``ops/fast.py``), a CUDA tensor
launches the kernel or raises. ``fast_score_nms.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fast_score_nms.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
MAX_RADIUS = 16
MAX_LEVELS = 8
# output tile of one block: the defaults of FAST_TILE_W / FAST_TILE_H in the
# source (checked against the library when it is loaded)
TILE_W, TILE_H = 32, 24
# every output map starts on a multiple of this many floats in the one
# output buffer, so that a level whose rows allow 16-byte stores gets them
OUT_ALIGN = 32

_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc "
                           "on PATH): cannot build the FAST kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _flags(defines: Sequence[str]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(defines: Sequence[str] = ()) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(_flags(defines)).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"fast_score_nms_{digest}.so"


def build(defines: Sequence[str] = ()) -> Path:
    """Compile the kernel library if this source has not been built yet with
    these ``-D`` defines (the source's build-time variants; none for the
    main path). Returns its path. Raises with the compiler's output on
    failure."""
    out = library_path(defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *_flags(defines), "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_log(defines: Sequence[str] = ()) -> str:
    """What nvcc and ``ptxas -v`` printed when this library was built:
    registers, shared memory and spills of each kernel."""
    return build(defines).with_suffix(".log").read_text()


class _Library:
    """The loaded library of one set of defines and its bound entry points;
    built and loaded on first use (the source is hashed once, not per
    launch)."""

    def __init__(self, defines: Tuple[str, ...]):
        lib = ctypes.CDLL(str(build(defines)))
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        self.levels = lib.fast_score_nms_levels_launch
        self.levels.argtypes = [ctypes.c_int, ptrs, ptrs, ptrs, ints, ints,
                                ints, ints, ints, ctypes.c_int,
                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        self.levels.restype = ctypes.c_int
        self.tile32 = lib.fast_score_nms_tile32_launch
        self.tile32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        self.tile32.restype = ctypes.c_int
        for fn in (lib.fast_score_nms_tile_w, lib.fast_score_nms_tile_h):
            fn.argtypes, fn.restype = [], ctypes.c_int
        self.tile_w = lib.fast_score_nms_tile_w()
        self.tile_h = lib.fast_score_nms_tile_h()
        if not defines and (self.tile_w, self.tile_h) != (TILE_W, TILE_H):
            raise RuntimeError(
                f"the source's default tile {self.tile_w}x{self.tile_h} is "
                f"not this module's {TILE_W}x{TILE_H}")
        self.lib = lib      # keep the library loaded


def _library(defines: Sequence[str] = ()) -> _Library:
    key = tuple(defines)
    lib = _libs.get(key)
    if lib is None:
        lib = _libs[key] = _Library(key)
    return lib


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
                  nms_radius: int, defines: Sequence[str] = ()
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The CUDA path of ``fast_score_nms_levels``: checks the levels, makes
    the one output buffer and the one launch. ``defines`` picks a build-time
    variant of the source (for measurement; the main path passes none)."""
    what = "fast_score_nms_levels"
    _check_levels(levels, nms_radius, what)
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    lib = _library(defines)
    shapes = tuple((int(g.shape[0]), int(g.shape[1])) for g in levels)
    tiles_x, first_tile, total = tile_layout(shapes, lib.tile_w, lib.tile_h)
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.levels(
            n, ptr_arr(*gray_p), ptr_arr(*raw_p), ptr_arr(*nms_p),
            int_arr(*(H for H, _ in shapes)), int_arr(*(W for _, W in shapes)),
            int_arr(*tiles_x), int_arr(*first_tile), int_arr(*vec), total,
            float(threshold), int(nms_radius), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    fast_score_nms.launches += 1
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


fast_score_nms.launches = 0


def fast_score_nms_tile32(gray: torch.Tensor, threshold: float,
                          nms_radius: int):
    """The first port's kernel (one launch per level, 32×32 tiles), kept as
    the yardstick the new kernel is timed against in the same call. CUDA
    only; not counted in ``fast_score_nms.launches``; nothing on the main
    path calls it."""
    what = "fast_score_nms_tile32"
    _check_levels([gray], nms_radius, what)
    if gray.device.type != "cuda":
        raise ValueError(f"{what}: needs a CUDA tensor, got {gray.device}")
    lib = _library()
    H, W = gray.shape
    raw = torch.empty_like(gray)
    nms = torch.empty_like(gray)
    with torch.cuda.device(gray.device):
        stream = torch.cuda.current_stream(gray.device).cuda_stream
        err = lib.tile32(gray.data_ptr(), raw.data_ptr(), nms.data_ptr(), H,
                         W, float(threshold), int(nms_radius), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    return raw, nms
