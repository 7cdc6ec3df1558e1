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
  raises: a block a run of consecutive segments stages their rows in
  shared memory, and a thread a (segment, column) adds them in ascending
  row index, which the stable sort gives, so the kernel equals the plain
  version bit for bit, and a run, its replay and a second run agree.

The kernel is built, bound and its launches counted on the card by
``utils/cuda_lib.py`` (``_LIB.launch_count()``; not under
``cuda_lib.uncounted()``, the warm-up before a capture).

Sums that stay as they are, being exact in any order: the integer counts
(``models/slam.py`` ``feat_matched``, ``parallel/multi_session.py``
``obs_count``, ``parallel/dist_ba.py::owner_partition``), the ``amin`` /
``amax`` ``scatter_reduce``s of ``models/slam.py``, and the word histogram
of ``loopclosure/bow.py``, which adds 1.0s (exact below 2**24).
"""

from __future__ import annotations

import ctypes
import math

import torch

from putslam_tpu_torch.utils import cuda_lib


def _bind(lib) -> None:
    ptr = ctypes.c_void_p
    lib.segment_sum_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ptr]
    lib.segment_sum_launch.restype = ctypes.c_int
    lib.segment_sum_max_cols.argtypes = []
    lib.segment_sum_max_cols.restype = ctypes.c_int


_LIB = cuda_lib.Library("segment_sum", _bind)


class SegmentPlan:
    """The fixed summation order of one index set: ``idx`` (M,) integers in
    [0, n], ``n`` the sentinel of a dropped row. Holds the stable sort
    permutation ``perm`` (M,), the sorted keys ``keys`` (M,) and the
    segment offsets ``offsets`` (n + 2,): segment s is the sorted positions
    [offsets[s], offsets[s + 1]), s = n the dropped rows. Keys and offsets
    are int32 below 2**31 - 2 segments. Built on the device of ``idx`` with
    no host read."""

    def __init__(self, idx: torch.Tensor, n: int):
        self.idx = idx.reshape(-1).long()
        self.n = int(n)
        # 32-bit keys where they fit: the radix sort makes half the passes,
        # and the kernel reads the sorted keys and the offsets as int32
        small = self.n < 2 ** 31 - 2
        kt = torch.int32 if small else torch.int64
        self.keys, self.perm = torch.sort(self.idx.to(kt), stable=True)
        self.offsets = torch.searchsorted(
            self.keys, torch.arange(self.n + 2, dtype=kt, device=idx.device),
            out_int32=small)

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
    if plan.keys.dtype != torch.int32 or plan.rows >= 2 ** 31:
        raise ValueError(f"{what}: {plan.rows} rows into n {plan.n} need "
                         f"64-bit keys, which the kernel does not take")
    x = x.contiguous()
    cols = math.prod(x.shape[1:])
    out = torch.empty((plan.n,) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        lib = _LIB.library()
        if cols > lib.segment_sum_max_cols():
            raise ValueError(f"{what}: {cols} columns, the kernel takes at "
                             f"most {lib.segment_sum_max_cols()}")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _LIB.check(lib.segment_sum_launch(
            x.data_ptr(), plan.perm.data_ptr(), plan.keys.data_ptr(),
            plan.offsets.data_ptr(), out.data_ptr(), plan.n, cols,
            cuda_lib.counted(), stream), f"{what} kernel launch")
    return out
