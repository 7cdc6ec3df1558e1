"""Config and state bridge between the JAX package and the port, and the
BRIEF bank.

``config_from_jax(cfg)`` maps the JAX package's ``SlamConfig`` (or one of its
sub-configs, or the ``dataclasses.asdict`` of either) onto the port's own
classes of ``putslam_tpu_torch/config.py``, field by field.

``from_numpy(tree, device)`` maps the JAX package's ``Features``,
``MapState``, ``GraphState``, ``SlamState`` (with the ``LCQueue`` and
``EKFState`` it carries), ``GuidedMatchResult`` and the tracking VO's
``TrackState``, given as numpy arrays
— e.g. taken with ``jax.tree.map(np.asarray, state)`` — onto the port's NamedTuples of the
same names and fields, on ``device``. ``to_numpy(tree)`` maps back to numpy.
JAX's ``SlamState.key`` has no counterpart (the port holds its
``torch.Generator`` outside the state) and is skipped.

``brief_bank(device, kind)`` is the fused descriptor constant (steered BRIEF
or LDB), bf16 on the device, made once per kind and device from the numpy
banks of ``ops/brief.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from putslam_tpu_torch import config as config_mod

_BANKS: dict = {}


def config_from_jax(cfg, cls=None):
    """The JAX package's config object, or its ``dataclasses.asdict``, →
    the port's class of the same name (``cls`` names the class for a dict;
    default ``SlamConfig``). Raises ``TypeError`` on a field the port's copy
    lacks; a field the source lacks keeps the port's default."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cls = cls or getattr(config_mod, type(cfg).__name__, None)
        if cls is None:
            raise TypeError(f"config_from_jax: the port has no counterpart of "
                            f"{type(cfg).__name__}")
        values = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)}
    elif isinstance(cfg, dict):
        cls = cls or config_mod.SlamConfig
        values = cfg
    else:
        raise TypeError(f"config_from_jax: need a config dataclass or a dict, "
                        f"got {type(cfg).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - set(fields))
    if unknown:
        raise TypeError(f"config_from_jax: {cls.__name__} has no field "
                        f"{', '.join(unknown)}")
    out = {}
    for name, value in values.items():
        sub = fields[name].default_factory
        if isinstance(sub, type) and dataclasses.is_dataclass(sub):
            value = config_from_jax(value, sub)
        out[name] = value
    return cls(**out)


def brief_bank(device, kind: str = "brief", fused: bool = True
               ) -> torch.Tensor:
    """The descriptor bank of ``kind`` ("brief" or "ldb") as bf16 on
    ``device``: the fused constant (blurred tests + moment columns), or with
    ``fused=False`` the unblurred test columns alone."""
    key = (torch.device(device), kind, fused)
    bank = _BANKS.get(key)
    if bank is None:
        from putslam_tpu_torch.ops import brief

        make = brief.make_fused_bank if fused else brief.make_test_bank
        bank = torch.as_tensor(make(kind)).to(device=key[0],
                                              dtype=torch.bfloat16)
        _BANKS[key] = bank
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
