"""Segment sums in a fixed order: the plan, the plain version and the
hand-written CUDA kernel behind the solvers' sums.

The JAX package forms every Hessian block and gradient of its solvers as
one-hot matrix products (``putslam_tpu/backend/optimize.py``: ``Pf``,
``Qf`` and ``P_full``, "loop-invariant, built once", and ``Pb`` / ``Qb`` in
``schur_subtrahend_mm``). Their order is fixed, so a JAX run repeats
itself bit for bit. ``index_add_`` on the card sums with atomics, in an
order that changes from run to run; from 34 free keyframes on the
bf16-rounded reduced system turns such last-bit differences into other
Gauss-Newton steps (ROADMAP 3ac). So every floating-point segment sum of
the port's solvers (``backend/optimize.py``, ``parallel/dist_ba.py``) goes
through a ``SegmentPlan``:

* ``SegmentPlan(idx, n)``: ``idx`` (M,) int64 in [0, n], n the sentinel of
  a dropped row. It holds the stable sort permutation of ``idx`` and the
  segment offsets (``torch.searchsorted`` of the sorted keys), built on the
  device with no host read, so a plan can be built inside a branch of a
  captured frame. The index sets of a solve do not change between its
  Gauss-Newton iterations: a solver builds its plans once, before the
  loop, as the JAX package builds its one-hot matrices once.
* ``plan.sum(x)``: (M, ...) rows → (n, ...) segment sums, the sentinel
  segment dropped. A CPU tensor takes the plain version, ``index_add_``
  into a zeroed (n + 1, ...) buffer (the CPU's ``index_add_`` adds the rows
  in ascending order). A CUDA tensor launches ``csrc/segment_sum.cu`` or
  raises: one thread a (segment, column) adds its rows in ascending row
  index, which the stable sort gives, so the kernel equals the plain
  version bit for bit, and a run, its replay and a second run agree.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``putslam_tpu_torch/build/`` (named by a hash of the source and the flags,
as ``ops/fast_cuda.py`` builds the FAST kernel) and bound with ``ctypes``.
Its launches are counted on the card (``launch_count``,
``reset_launch_count``): a launch recorded into a CUDA graph, inside a
conditional node's body, runs at a replay only where the card takes the
branch, which the host does not see. Launches made under ``uncounted()``
(the warm-up before a capture) are not counted.

Sums that stay as they are, being exact in any order: the integer counts
(``models/slam.py`` ``feat_matched``, ``parallel/multi_session.py``
``obs_count``, ``parallel/dist_ba.py::owner_partition``), the ``amin`` /
``amax`` ``scatter_reduce``s of ``models/slam.py``, and the word histogram
of ``loopclosure/bow.py``, which adds 1.0s (exact below 2**24).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from pathlib import Path

import torch

from putslam_tpu_torch.ops import fast_cuda

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "segment_sum.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_lib = None
_counted = True


def build() -> Path:
    """Compile the kernel library unless it is built already; returns its
    path. Raises with the compiler's output on failure."""
    return fast_cuda.compile_library(SOURCE, NVCC_FLAGS)


def build_log() -> str:
    """What nvcc and ``ptxas -v`` printed when the library was built."""
    return build().with_suffix(".log").read_text()


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr = ctypes.c_void_p
        lib.segment_sum_launch.argtypes = [ptr, ptr, ptr, ptr,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ptr]
        lib.segment_sum_read_launches.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong)]
        for fn in (lib.segment_sum_launch, lib.segment_sum_load,
                   lib.segment_sum_read_launches,
                   lib.segment_sum_reset_launches):
            fn.restype = ctypes.c_int
        lib.segment_sum_load.argtypes = []
        lib.segment_sum_reset_launches.argtypes = []
        lib.segment_sum_error.argtypes = [ctypes.c_int]
        lib.segment_sum_error.restype = ctypes.c_char_p
        _check(lib, lib.segment_sum_load(), "loading the segment-sum kernel")
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc:
        msg = lib.segment_sum_error(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def launch_count(device="cuda") -> int:
    """Counted kernel launches on ``device`` since the last reset, graph
    replays included (synchronises the device)."""
    with torch.cuda.device(torch.device(device)):
        lib = _library()
        torch.cuda.synchronize()
        value = ctypes.c_ulonglong(0)
        _check(lib, lib.segment_sum_read_launches(ctypes.byref(value)),
               "reading the launch count")
    return int(value.value)


def reset_launch_count(device="cuda") -> None:
    """Set the launch count on ``device`` to 0 (synchronises the device)."""
    with torch.cuda.device(torch.device(device)):
        lib = _library()
        torch.cuda.synchronize()
        _check(lib, lib.segment_sum_reset_launches(),
               "resetting the launch count")


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


class SegmentPlan:
    """The fixed summation order of one index set: ``idx`` (M,) integers in
    [0, n], ``n`` the sentinel of a dropped row. Holds the stable sort
    permutation ``perm`` (M,) and the segment offsets ``offsets`` (n + 2,):
    segment s is the sorted positions [offsets[s], offsets[s + 1]), s = n
    the dropped rows. Built on the device of ``idx`` with no host read."""

    def __init__(self, idx: torch.Tensor, n: int):
        self.idx = idx.reshape(-1).long()
        self.n = int(n)
        # 32-bit keys where they fit: the radix sort makes half the passes
        kt = torch.int32 if self.n < 2 ** 31 - 2 else torch.int64
        keys, self.perm = torch.sort(self.idx.to(kt), stable=True)
        self.offsets = torch.searchsorted(
            keys, torch.arange(self.n + 2, dtype=kt, device=keys.device))

    @property
    def rows(self) -> int:
        return self.idx.shape[0]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(M, ...) float rows summed into (n, ...) segments, each in
        ascending row order; the sentinel segment is dropped. CPU rows: the
        plain version; CUDA rows: the kernel, bit-equal to it."""
        if x.device.type == "cpu":
            return plain_segment_sum(x, self)
        return launch(x, self)


def plain_segment_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The plain version: ``index_add_`` into a zeroed (n + 1, ...) buffer,
    the sentinel row sliced off."""
    out = torch.zeros((plan.n + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out.index_add_(0, plan.idx, x)
    return out[:plan.n]


def launch(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The CUDA path of ``SegmentPlan.sum``: checks the inputs, makes the
    output and the one launch."""
    what = "segment_sum"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if plan.perm.device != x.device:
        raise ValueError(f"{what}: plan on {plan.perm.device}, rows on "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: needs float32 rows, got {x.dtype}")
    if x.dim() < 1 or x.shape[0] != plan.rows:
        raise ValueError(f"{what}: {tuple(x.shape)} rows for a plan of "
                         f"{plan.rows}")
    x = x.contiguous()
    cols = math.prod(x.shape[1:])
    out = torch.empty((plan.n,) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        lib = _library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib, lib.segment_sum_launch(
            x.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
            out.data_ptr(), plan.n * cols, cols, int(_counted), stream),
            f"{what} kernel launch")
    return out
