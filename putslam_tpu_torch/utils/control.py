"""Data-dependent branches: the port's ``jax.lax.cond``.

The JAX frame is one device program in which a ``lax.cond`` skips the work
a frame does not need (the map retry ladder, the VO retry, the loop-closure
verification, the keyframe bookkeeping, the bundle adjustment and each of
its Gauss-Newton iterations, the sorted observation slots). ``cond(pred,
body, out)`` is that branch here: ``body()`` returns a tree shaped like
``out``, a tree of existing tensors that holds the value of the skipped
branch and receives the result in place. The caller's context, not a
config knob, decides how it runs (``branching``):

* ``"capture"`` (inside a CUDA-graph capture, ``models/compiled.py``): a
  conditional IF node on ``pred`` (0-d bool on the card, ``utils/
  graph_cond.py``); ``body`` and the copy into ``out`` are captured into the
  node's body graph, which a replay runs only where ``pred`` holds. The
  card reads the predicate; the host does not.
* ``"masked"`` (the default: the eager step, and the warm-up pass before a
  capture): ``body`` runs and its result is selected into ``out`` with
  ``torch.where``. No host read, and both sides of every branch run, which
  is what a warm-up needs (cuBLAS handles, workspaces, the FAST kernel's
  build).
* ``"host"`` (a runner with ``capture=False``, on any device, and the
  eager end of the run: ``finalize(graph=False)``, ``finalize_dist``, the
  global BA's eager window solves): ``pred`` is read once and ``body``
  runs only where it holds: the host's stand-in for the IF node, the same
  body and the same ``out``.

``name`` records the body as a stage of the flight recorder
(``utils/timing.py``): a stamp at each end of the body in a capture, the
host's clock in ``"host"`` mode, nothing when masked.

A tensor the body allocates is garbage after a replay that skipped the
body: only ``out`` may be read after the branch. ``checking()`` turns on a
guard that raises where a body writes in place to a tensor it did not
create itself (its ``out`` is written only by the copy that closes the
branch, outside the guard). Branches nest.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from putslam_tpu_torch.utils import timing

MODES = ("masked", "host", "capture")
_mode = "masked"
_checker = None          # the active _WriteCheck, or None
predicate_reads = 0      # host reads of a predicate ("host" mode)


def mode() -> str:
    """The branching mode in force."""
    return _mode


@contextlib.contextmanager
def branching(new_mode: str):
    """Run the ``cond``s made inside the block in ``new_mode``."""
    global _mode
    if new_mode not in MODES:
        raise ValueError(f"branching mode {new_mode!r} (one of {MODES})")
    old, _mode = _mode, new_mode
    try:
        yield
    finally:
        _mode = old


def leaves(tree):
    """The tensors of a tree of NamedTuples, tuples, lists and dicts, in
    order; leaves that are no tensor (None, numbers) are skipped."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return []


def clone(tree):
    """A copy of the tree with every tensor cloned."""
    if tree is None or torch.is_tensor(tree):
        return None if tree is None else tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    items = [clone(x) for x in tree]
    if hasattr(tree, "_fields"):           # a NamedTuple
        return type(tree)(*items)
    return type(tree)(items)


def assign(dst, src, keep=None):
    """Copy every leaf of ``src`` into the leaf of ``dst`` at its place
    (``keep``: a 0-d bool, True keeps ``dst``). Leaves that are ``dst``'s
    own are skipped; a source that shares storage with a destination is
    read before any destination is written."""
    ld, ls = leaves(dst), leaves(src)
    if len(ld) != len(ls):
        raise ValueError(f"{len(ls)} tensors for {len(ld)} destinations")
    pairs = []
    for d, s in zip(ld, ls):
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"a {tuple(s.shape)} {s.dtype} result for a "
                             f"{tuple(d.shape)} {d.dtype} destination")
        if s is not d:
            pairs.append((d, s))
    if keep is not None:
        pairs = [(d, torch.where(keep, d, s)) for d, s in pairs]
    held = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in held else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


def cond(pred: torch.Tensor, body: Callable, out,
         name: Optional[str] = None):
    """``out`` ← ``body()`` where the 0-d bool ``pred`` holds, else left as
    it is; returns ``out``. See the module docstring for the three modes;
    ``name``: the body's stage (``timing.STAGES``), or None."""
    global predicate_reads
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"a branch predicate is a 0-d bool, not "
                         f"{pred.dtype} of shape {tuple(pred.shape)}")
    if _mode == "host":
        predicate_reads += 1
        if bool(pred):
            with timing.stage(name):
                assign(out, _checked(body))
    elif _mode == "masked":
        assign(out, _checked(body), keep=~pred)
    else:
        if not (pred.is_cuda and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("cond in capture mode outside a CUDA-graph "
                               "capture (or with a predicate off the card)")
        from putslam_tpu_torch.utils import graph_cond

        with graph_cond.if_node(pred), timing.stage(name):
            assign(out, _checked(body))
    return out


# ---- the write guard -------------------------------------------------------


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _WriteCheck(TorchDispatchMode):
    """Raises where an operator writes in place to a tensor that the
    innermost running body did not create. ``frames``: per running body,
    the storages it created (a view creates none)."""

    def __init__(self):
        super().__init__()
        self.frames = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if self.frames:
            for i, arg in enumerate(schema.arguments):
                if arg.alias_info is None or not arg.alias_info.is_write:
                    continue
                val = args[i] if i < len(args) else kwargs.get(arg.name)
                for t in leaves(val):
                    if t.numel() and _storage(t) not in self.frames[-1]:
                        raise RuntimeError(
                            f"a branch body writes in place ({func}) to a "
                            f"tensor it did not create: only its out may "
                            f"receive its result")
        result = func(*args, **kwargs)
        if self.frames:
            outs = result if isinstance(result, (tuple, list)) else (result,)
            for ret, val in zip(schema.returns, outs):
                if ret.alias_info is None:
                    made = {_storage(t) for t in leaves(val) if t.numel()}
                    for frame in self.frames:
                        frame |= made
        return result


@contextlib.contextmanager
def checking():
    """Guard every body run inside the block (see the module docstring)."""
    global _checker
    if _checker is not None:
        yield
        return
    _checker = _WriteCheck()
    try:
        with _checker:
            yield
    finally:
        _checker = None


def _checked(body: Callable):
    if _checker is None:
        return body()
    _checker.frames.append(set())
    try:
        return body()
    finally:
        _checker.frames.pop()
