"""Device selection for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """A torch.device; raises when CUDA is asked for and absent — no entry
    point carries on on the CPU when the card was requested."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           "not available")
    return dev


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` (tensor, numpy or JAX array, sequence) as a tensor on
    ``device``; host arrays are copied (they may be read-only)."""
    if not torch.is_tensor(x):
        x = torch.tensor(np.array(x))
    return x.to(device=device, dtype=dtype)


def as_numpy(x) -> np.ndarray:
    """``x`` (tensor on any device, numpy array, sequence) as a numpy
    array on the host."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def use_graphs(graph, device) -> bool:
    """Whether a sequence replays its step from CUDA graphs: ``graph=None``
    means yes on a CUDA device and no elsewhere; True on another device
    raises."""
    dev = torch.device(device)
    if graph is None:
        return dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, not {dev}")
    return bool(graph)
