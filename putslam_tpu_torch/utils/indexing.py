"""Fixed-shape index helpers standing in for JAX's array semantics.

* ``nonzero_fixed`` is ``jnp.nonzero(mask, size=, fill_value=)``: a cumsum
  compaction with a static output size and no host sync (``torch.nonzero``
  has a dynamic shape and syncs).
* ``take_row`` is ``x[i]`` for a 0-d index tensor as a device gather:
  indexing with a 0-d tensor converts it to a Python int, a host sync.
* ``set_rows`` is ``x.at[idx].set(v)`` with JAX's drop of out-of-bounds
  writes: the caller sends masked lanes to index ``len(x)``, which lands in
  a sentinel row that is sliced off (torch raises on, and CUDA asserts on,
  an out-of-bounds index). Only the sentinel row may receive duplicate
  writes, so no real row has an undefined winner.
"""

from __future__ import annotations

import torch


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of the first ``size`` True entries of the 1-D ``mask``, in
    order, padded with ``fill``. Returns (size,) int64."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    target = torch.where(mask & (rank < size), rank,
                         torch.full_like(rank, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, target, torch.arange(n, device=mask.device))
    return out[:size]


def take_row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d integer tensor ``i``, without a host sync."""
    return x.index_select(0, i.reshape(1).long())[0]


def set_rows(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Copy of ``x`` with rows ``idx`` set to ``vals``; ``idx == len(x)``
    writes are dropped."""
    ext = torch.cat([x, x[:1]], dim=0)
    # a Python value becomes a device fill, not a host → device copy (which
    # synchronises)
    ext[idx.long()] = vals if torch.is_tensor(vals) else torch.full(
        (), vals, dtype=x.dtype, device=x.device)
    return ext[:-1]
