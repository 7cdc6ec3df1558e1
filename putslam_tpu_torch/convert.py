"""State bridge between the JAX package and the port, and the BRIEF bank.

``from_numpy(tree, device)`` maps the JAX package's ``Features``,
``MapState``, ``GraphState``, ``SlamState`` (with the ``LCQueue`` and
``EKFState`` it carries), ``GuidedMatchResult`` and the tracking VO's
``TrackState``, given as numpy arrays
— e.g. taken with ``jax.tree.map(np.asarray, state)`` — onto the port's NamedTuples of the
same names and fields, on ``device``. ``to_numpy(tree)`` maps back to numpy.
JAX's ``SlamState.key`` has no counterpart (the port holds its
``torch.Generator`` outside the state) and is skipped.

``brief_bank(device)`` is the fused steered-BRIEF constant, bf16 on the
device, built once per device from the numpy builders of ``ops/brief.py``.
"""

from __future__ import annotations

import numpy as np
import torch

_BANKS: dict = {}


def brief_bank(device) -> torch.Tensor:
    device = torch.device(device)
    bank = _BANKS.get(device)
    if bank is None:
        from putslam_tpu_torch.ops.brief import make_fused_bank

        bank = torch.as_tensor(make_fused_bank()).to(device=device,
                                                     dtype=torch.bfloat16)
        _BANKS[device] = bank
    return bank


def _classes():
    from putslam_tpu_torch.backend.graph import GraphState
    from putslam_tpu_torch.frontend.detector import Features
    from putslam_tpu_torch.loopclosure.bow import LCQueue
    from putslam_tpu_torch.models.slam import SlamState
    from putslam_tpu_torch.models.vo import TrackState
    from putslam_tpu_torch.motion.ekf import EKFState
    from putslam_tpu_torch.slam_map.features_map import (GuidedMatchResult,
                                                         MapState)

    return {c.__name__: c for c in
            (Features, MapState, GraphState, SlamState, LCQueue, EKFState,
             GuidedMatchResult, TrackState)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_numpy(tree, device):
    """JAX-package state (numpy leaves) → port state (tensors on device)."""
    if _is_namedtuple(tree):
        cls = _classes()[type(tree).__name__]
        return cls(**{f: from_numpy(getattr(tree, f), device)
                      for f in cls._fields})
    return torch.as_tensor(np.array(tree), device=device)


def to_numpy(tree):
    """Port state → the same NamedTuples with numpy leaves."""
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(x) for x in tree))
    return tree.detach().cpu().numpy()
