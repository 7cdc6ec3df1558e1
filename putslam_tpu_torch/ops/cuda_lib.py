"""The hand-written kernel libraries that count their launches on the card:
``csrc/segment_sum.cu`` (``ops/segment.py``), ``csrc/kabsch_fit.cu``
(``ops/kabsch.py``), ``csrc/ransac_score.cu`` (``ops/ransac_score.py``) and
``csrc/keypoints.cu`` (``ops/keypoints.py``).

Each is compiled with ``nvcc`` for ``sm_90a`` at first use into
``putslam_tpu_torch/build/`` (named by a hash of the source, the headers it
includes and the flags, as ``ops/fast_cuda.py`` builds the FAST kernel) and
bound with ``ctypes``.
Its plain C entry points follow one pattern, ``<name>`` the source's stem:
``<name>_load`` loads the kernels and finds the counters before any
capture, ``<name>_read_launches`` / ``<name>_reset_launches`` read and
reset the counter, ``<name>_error`` names a ``cudaError_t``; the launch
functions are the library's own (``bind``).

A launch adds one to a counter on the card: a launch recorded into a CUDA
graph, inside a conditional node's body, runs at a replay only where the
card takes the branch, which the host does not see. Launches made under
``uncounted()`` (the warm-up before a capture) go to a second counter that
nothing reads.
"""

from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path
from typing import Callable

import torch

from putslam_tpu_torch.ops import fast_cuda

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_counted = True


@contextlib.contextmanager
def uncounted():
    """Launches made inside the block are not counted (the warm-up pass
    before a capture, which is not a step)."""
    global _counted
    old, _counted = _counted, False
    try:
        yield
    finally:
        _counted = old


def counted() -> int:
    """The ``counted`` argument of a launch: 1, or 0 under ``uncounted``."""
    return int(_counted)


class CountedLibrary:
    """The library built from ``csrc/<name>.cu``; ``bind(lib)`` declares the
    argument and result types of its launch functions."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._bind = bind
        self._lib = None

    def build(self) -> Path:
        """Compile the library unless it is built already; returns its
        path. Raises with the compiler's output on failure."""
        return fast_cuda.compile_library(self.source, NVCC_FLAGS)

    def build_log(self) -> str:
        """What nvcc and ``ptxas -v`` printed when the library was built."""
        return self.build().with_suffix(".log").read_text()

    def _fn(self, lib, suffix):
        return getattr(lib, f"{self.name}_{suffix}")

    def library(self) -> ctypes.CDLL:
        """The loaded library, its kernels loaded on the current device."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            for suffix, args in (
                    ("load", []), ("reset_launches", []),
                    ("read_launches", [ctypes.POINTER(ctypes.c_ulonglong)])):
                fn = self._fn(lib, suffix)
                fn.argtypes, fn.restype = args, ctypes.c_int
            err = self._fn(lib, "error")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self._check(lib, self._fn(lib, "load")(),
                        f"loading the {self.name} kernels")
            self._lib = lib
        return self._lib

    def _check(self, lib, rc: int, what: str) -> None:
        if rc:
            msg = self._fn(lib, "error")(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

    def check(self, rc: int, what: str) -> None:
        """Raise where a launch function returned a CUDA error."""
        self._check(self.library(), rc, what)

    def launch_count(self, device="cuda") -> int:
        """Counted kernel launches on ``device`` since the last reset, graph
        replays included (synchronises the device)."""
        with torch.cuda.device(torch.device(device)):
            lib = self.library()
            torch.cuda.synchronize()
            value = ctypes.c_ulonglong(0)
            self._check(lib, self._fn(lib, "read_launches")(
                ctypes.byref(value)), "reading the launch count")
        return int(value.value)

    def reset_launch_count(self, device="cuda") -> None:
        """Set the launch count on ``device`` to 0 (synchronises the
        device)."""
        with torch.cuda.device(torch.device(device)):
            lib = self.library()
            torch.cuda.synchronize()
            self._check(lib, self._fn(lib, "reset_launches")(),
                        "resetting the launch count")
