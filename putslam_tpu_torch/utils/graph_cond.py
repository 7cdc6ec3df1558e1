"""Conditional IF nodes of a CUDA graph under stream capture.

The capture side of ``utils/control.py::cond``: ``if_node(pred)`` is a
context in which everything PyTorch launches is captured into the body of
an IF node of the graph being captured, which a replay runs only where the
0-d bool ``pred`` on the card holds. The node, its handle and the
one-thread kernel that sets the handle from ``pred`` are made by
``csrc/graph_cond.cu`` (built and bound by ``utils/cuda_lib.py``).

A body is captured on a stream of its own (one per nesting depth, made by
``prepare``), made PyTorch's current stream for the body. The caching
allocator serves the capturing stream from the graph's private pool, but
not a body's stream (its capture is another one), so the bodies allocate
from a second private pool, a ``torch.cuda.MemPool`` that the caller keeps
as long as the graph (``prepare(device, body_pool)``): what a body
allocates is never handed to code outside the graphs.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from putslam_tpu_torch.utils import cuda_lib

MAX_DEPTH = 8

_streams: dict = {}      # device index -> body streams, one per depth
_body_pool = None        # (device index, MemPool) of the capture under way
_depth = 0
launches = 0             # set-condition kernels captured (one a node)


def _bind(lib) -> None:
    lib.graph_cond_begin.argtypes = [ctypes.c_void_p] * 3
    lib.graph_cond_end.argtypes = [ctypes.c_void_p]
    lib.graph_cond_begin.restype = lib.graph_cond_end.restype = ctypes.c_int


_LIB = cuda_lib.Library("graph_cond", _bind, counted=False)


def prepare(device, body_pool) -> None:
    """Before a capture on ``device``: build and load the library, make the
    body streams, and name the ``torch.cuda.MemPool`` the bodies allocate
    from."""
    global _body_pool
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    _LIB.library()
    if idx not in _streams:
        _streams[idx] = [torch.cuda.Stream(idx) for _ in range(MAX_DEPTH)]
    _body_pool = (idx, body_pool)


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the block into the body of an IF node on ``pred``."""
    global _depth, launches
    if _body_pool is None or _body_pool[0] != pred.device.index:
        raise RuntimeError("graph_cond.prepare(device, body_pool) was not "
                           "called for this capture")
    if _depth >= MAX_DEPTH:
        raise RuntimeError(f"IF nodes nested deeper than {MAX_DEPTH}")
    idx, pool = _body_pool
    parent = torch.cuda.current_stream(idx)
    body = _streams[idx][_depth]
    _LIB.check(_LIB.library().graph_cond_begin(
        parent.cuda_stream, body.cuda_stream, pred.data_ptr()),
        "opening a conditional graph node")
    launches += 1
    _depth += 1
    try:
        with contextlib.ExitStack() as stack:
            if _depth == 1:
                stack.enter_context(torch.cuda.use_mem_pool(pool, idx))
            stack.enter_context(torch.cuda.stream(body))
            yield
    finally:
        _depth -= 1
        _LIB.check(_LIB.library().graph_cond_end(body.cuda_stream),
                   "closing a conditional graph node")
