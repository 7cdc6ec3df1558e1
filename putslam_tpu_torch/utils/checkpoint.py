"""Checkpoint / resume of the full SLAM state, the port's counterpart of
``putslam_tpu/utils/checkpoint.py:36,43``.

The whole ``SlamState`` is a tree of NamedTuples with tensor leaves, so any
step's state can be written out and the run continued from it exactly.

Format: one ``.npz`` of arrays keyed by their path in the tree
(``map/kf_pose``, ``graph/obs_kf``, ``lc_queue/prob``, ``ekf/x``, ...), the
JAX package's keys, so a checkpoint written by either package loads into the
other. The JAX package's ``SlamState.key`` has no counterpart here (RANSAC
draws come from a ``torch.Generator`` held outside the state): ``save_state``
writes no ``key`` leaf and ``load_state`` ignores one in the file. To resume
a run exactly, carry the generator's ``get_state()`` beside the checkpoint.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch

from putslam_tpu_torch.utils.device import as_numpy


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf, fields joined by '/', in field order."""
    if _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{prefix}{name}/")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{prefix}{i}/")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _rebuild(template: Any, leaves: Iterator[Any]) -> Any:
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(x, leaves) for x in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(x, leaves) for x in template)
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def save_state(path: str, state: Any) -> None:
    """Write any tree of tensors (e.g. ``models.slam.SlamState``) to
    ``path`` (``putslam_tpu/utils/checkpoint.py:36``)."""
    arrays = {key: as_numpy(v) for key, v in _leaves(state)}
    np.savez_compressed(path, **arrays)


def load_state(path: str, template: Any) -> Any:
    """Restore a tree written by ``save_state`` of either package
    (``putslam_tpu/utils/checkpoint.py:43``). ``template`` gives the tree
    structure, the shapes to hold the file against, and the device of each
    leaf (e.g. a freshly initialised state of the same config). A leaf
    missing from the file raises ``KeyError``, a shape that differs
    ``ValueError``; leaves the template lacks (the JAX package's ``key``)
    are ignored."""
    leaves = []
    with np.load(path) as data:
        for key, tmpl in _leaves(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if arr.shape != tuple(np.shape(tmpl)):
                raise ValueError(
                    f"checkpoint leaf {key!r} shape {arr.shape} != template "
                    f"{tuple(np.shape(tmpl))} (config mismatch?)")
            if torch.is_tensor(tmpl):
                leaves.append(torch.as_tensor(arr, dtype=tmpl.dtype,
                                              device=tmpl.device))
            else:
                leaves.append(arr)
    return _rebuild(template, iter(leaves))
