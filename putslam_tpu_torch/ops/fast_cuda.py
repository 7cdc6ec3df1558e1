"""Build, bind and launch the hand-written FAST-9 + NMS kernel.

The kernel (``csrc/fast_score_nms.cu``) replaces the JAX package's Pallas
kernel ``putslam_tpu/ops/fast_pallas.py::fast_score_nms``. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C entry
point and bound through ``ctypes``. The library is built at first use into
``putslam_tpu_torch/build/``, named by a hash of the source and the flags,
so a fresh checkout builds it on its first CUDA call and a changed source
rebuilds.

``fast_score_nms`` is the one entry point: a CPU tensor goes through the
plain PyTorch version (``ops/fast.py``), a CUDA tensor launches the kernel
or raises. ``fast_score_nms.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fast_score_nms.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
MAX_RADIUS = 16

_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc "
                           "on PATH): cannot build the FAST kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"fast_score_nms_{digest}.so"


def build() -> Path:
    """Compile the kernel library if this source has not been built yet.
    Returns its path. Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _launcher():
    """The bound C entry point; built and loaded on the first call of the
    process (the source is hashed once, not per launch)."""
    fn = _libs.get("launch")
    if fn is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.fast_score_nms_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _libs["launch"] = fn
        _libs["lib"] = lib      # keep the library loaded
    return fn


def fast_score_nms(gray: torch.Tensor, threshold: float, nms_radius: int):
    """(H, W) float32 intensities in [0, 1] → (raw, nms), both (H, W)
    float32: the FAST-9 score map and its (2r+1)² non-maximum suppression,
    bit-exact with ``ops.fast.fast_score_map`` / ``ops.fast.nms``."""
    if gray.device.type == "cpu":
        from putslam_tpu_torch.ops import fast

        raw = fast.fast_score_map(gray, threshold)
        return raw, fast.nms(raw, nms_radius)
    if gray.device.type != "cuda":
        raise ValueError(f"fast_score_nms: unsupported device {gray.device}")
    if gray.dtype != torch.float32 or gray.dim() != 2:
        raise ValueError("fast_score_nms: need a 2-D float32 tensor, got "
                         f"{tuple(gray.shape)} {gray.dtype}")
    if not gray.is_contiguous():
        raise ValueError("fast_score_nms: input must be contiguous")
    if not 0 <= int(nms_radius) <= MAX_RADIUS:
        raise ValueError(f"fast_score_nms: nms_radius must be in "
                         f"[0, {MAX_RADIUS}], got {nms_radius}")
    launch = _launcher()
    H, W = gray.shape
    raw = torch.empty_like(gray)
    nms = torch.empty_like(gray)
    with torch.cuda.device(gray.device):
        stream = torch.cuda.current_stream(gray.device).cuda_stream
        err = launch(gray.data_ptr(), raw.data_ptr(), nms.data_ptr(), H, W,
                     float(threshold), int(nms_radius), stream)
    if err != 0:
        raise RuntimeError(f"fast_score_nms kernel launch failed: CUDA error "
                           f"{err}")
    fast_score_nms.launches += 1
    return raw, nms


fast_score_nms.launches = 0
