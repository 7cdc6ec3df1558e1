"""The multi-process runtime, the port's counterpart of
``putslam_tpu/parallel/multihost.py:30-80``.

Every process calls :func:`initialize_distributed`, which joins one
``torch.distributed`` process group through :func:`join_group` (a caller
that wants a group of one, as on one card, calls that itself);
:func:`global_mesh` then builds the one-axis ``parallel.mesh.Mesh`` over
every rank of it, and the distributed computations
(``parallel/dist_ba.py``, ``parallel/mesh.py``) run unchanged over that
mesh. A process is one rank and drives one device. The only
collective is ``all_reduce`` (sum): the distributed BA sends the
(6·K)² reduced camera system once per Gauss-Newton iteration, independent
of the map size.

Backends: NCCL when the process's device is CUDA, gloo on the CPU. NCCL
refuses two ranks on one card, so ranks that share a card pass
``backend="gloo"``: gloo all-reduces CUDA tensors by staging them through
the host.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from putslam_tpu_torch.parallel.mesh import make_mesh
from putslam_tpu_torch.utils.device import resolve_device

# a lost rank fails the run after this long instead of hanging it
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None,
                           autodetect: bool = False, device="cuda",
                           backend: Optional[str] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT
                           ) -> bool:
    """Join (or skip) the multi-process runtime. Returns True when a
    process group was initialised.

    With ``num_processes`` ≤ 1, or with no argument and ``autodetect``
    False, this is a no-op returning False, as in the JAX package.
    ``coordinator_address`` is ``host:port`` (``tcp://`` init) or a
    ``file://`` / ``tcp://`` URL; with it ``num_processes`` and
    ``process_id`` are required. ``autodetect=True`` reads torchrun's
    variables (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``). ``local_device_ids[0]`` is the CUDA
    device of this process (default ``LOCAL_RANK`` under torchrun, else the
    index of ``device``). ``backend``: default NCCL for a CUDA ``device``,
    gloo for the CPU."""
    if num_processes is not None and num_processes <= 1:
        return False
    explicit = (coordinator_address, num_processes, process_id)
    if autodetect:
        init_method, world, rank = "env://", -1, -1
    elif all(x is None for x in explicit):
        return False                  # nothing to join: stay single-process
    elif any(x is None for x in explicit):
        raise ValueError("initialize_distributed: coordinator_address, "
                         "num_processes and process_id go together")
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
    index = (local_device_ids[0] if local_device_ids else
             int(os.environ.get("LOCAL_RANK", 0)) if autodetect else None)
    join_group(init_method, world, rank, device=device, backend=backend,
               timeout=timeout, device_index=index)
    return True


def join_group(init_method: str, world_size: int, rank: int, device="cuda",
               backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               device_index: Optional[int] = None) -> str:
    """Join a process group of any size, world 1 included (a group of one
    on NCCL still runs its collectives; ``initialize_distributed`` skips
    it). Sets this process's CUDA device first (``device_index``, default
    the index of ``device``); the backend is NCCL for a CUDA ``device`` and
    gloo for the CPU unless ``backend`` names one. ``world_size`` and
    ``rank`` -1: read from ``env://``'s variables. Returns the backend."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(device_index if device_index is not None
                              else dev.index or 0)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=timeout)
    return backend


def global_mesh(axis_name: str = "lm", device="cuda"):
    """One-axis mesh over every rank of the joined group (the landmark-block
    axis of the distributed BA); one rank, reduction the identity, when no
    group was joined."""
    return make_mesh(axis=axis_name, device=device)


def process_info():
    """(process_index, process_count, local_devices, global_devices): one
    device per process."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        return dist.get_rank(), world, 1, world
    return 0, 1, 1, 1


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
