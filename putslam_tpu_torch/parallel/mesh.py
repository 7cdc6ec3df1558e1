"""The rank mesh and session-parallel VO, the port's counterpart of
``putslam_tpu/parallel/mesh.py:24-56``.

``Mesh`` stands in for ``jax.sharding.Mesh`` with one axis: ``size`` ranks
(``mesh.devices.size``), ``axis_names``, this process's ``rank`` and
``device``. Three kinds, by how ``make_mesh`` finds the runtime:

* a ``torch.distributed`` group is initialised: one rank per process, the
  reduction is ``all_reduce`` (sum) over the group;
* no group, one rank: the reduction is the identity;
* no group, ``n_devices`` > 1: that many virtual ranks run one after
  another in this process (the counterpart of the JAX package's virtual
  CPU devices) and the reduction is the caller's local sum over them.

A sharded computation loops over ``mesh.ranks`` (the ranks this process
runs), sums their partial results and hands the sum to ``all_reduce_``.
Blocks of a sharded array are gathered by all-reducing a zero-padded full
array, so gloo and NCCL need the one collective.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from putslam_tpu_torch.config import SlamConfig
from putslam_tpu_torch.models import vo as vo_mod
from putslam_tpu_torch.utils.device import as_tensor, resolve_device


class Mesh:
    """One axis of ``size`` ranks. ``group``: the process group, or None
    (one process runs every rank). Counts every all-reduce it makes
    (``n_all_reduce``, ``all_reduce_bytes``); with ``timed`` True it also
    synchronises the device around each and sums the seconds
    (``all_reduce_s``)."""

    def __init__(self, size: int, axis_names: Sequence[str], device,
                 group=None, rank: int = 0):
        self.size = int(size)
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)
        self.group = group
        self.rank = rank
        self.ranks = (rank,) if group is not None else tuple(range(size))
        self.timed = False
        self.n_all_reduce = 0
        self.all_reduce_bytes = 0
        self.all_reduce_s = 0.0

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the group in place (the caller has summed the
        partials of ``self.ranks``); the identity without a group."""
        if self.group is None:
            return x
        self.n_all_reduce += 1
        self.all_reduce_bytes += x.numel() * x.element_size()
        if self.timed and x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        if self.timed:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            self.all_reduce_s += time.perf_counter() - t0
        return x

    def __repr__(self):
        if self.group is not None:
            how = (f"rank {self.rank} of a {dist.get_backend(self.group)} "
                   f"group")
        elif self.size == 1:
            how = "one process, no group: the reduction is the identity"
        else:
            how = (f"{self.size} virtual ranks in one process, no group: the "
                   f"reduction is a local sum")
        return (f"Mesh(size={self.size}, axis_names={self.axis_names}, "
                f"device={self.device}, {how})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "session",
              device="cuda") -> Mesh:
    """A one-axis mesh named ``axis``. Over the initialised process group
    (``n_devices`` None or its world size), else ``n_devices`` (default 1)
    ranks in this process."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices not in (None, world):
            raise ValueError(f"make_mesh: {n_devices} ranks asked for, the "
                             f"process group has {world}")
        return Mesh(world, (axis,), dev, group=dist.group.WORLD,
                    rank=dist.get_rank())
    return Mesh(n_devices or 1, (axis,), dev)


def session_seed(seed: int, b: int, n_sessions: int) -> int:
    """The seed of session ``b``'s RANSAC generator: ``seed · B + b`` for B
    sessions, distinct for every (seed, b) at a given B. (The JAX package
    splits ``PRNGKey(seed)`` into B keys; its draws are not torch's.)"""
    return seed * n_sessions + b


def vo_sessions_sharded(cfg: SlamConfig, mesh: Mesh, grays, depths,
                        seed: int = 0) -> torch.Tensor:
    """B independent VO sessions, in contiguous blocks of B / size along
    the mesh axis (``P(axis)``); each session is one ``models/vo.py::
    vo_sequence`` from the identity pose with its own generator
    (``session_seed``). grays / depths: (B, T, H, W), host or device.
    Returns poses (B, T, 7) on ``mesh.device``, the same on every rank."""
    B, T = grays.shape[0], grays.shape[1]
    if B % mesh.size:
        raise ValueError(f"vo_sessions_sharded: {B} sessions do not split "
                         f"over {mesh.size} ranks")
    per = B // mesh.size
    dev = mesh.device
    out = torch.zeros((B, T, 7), dtype=torch.float32, device=dev)
    for r in mesh.ranks:
        for b in range(r * per, (r + 1) * per):
            gen = torch.Generator(device=dev)
            gen.manual_seed(session_seed(seed, b, B))
            poses, _ = vo_mod.vo_sequence(
                cfg, as_tensor(grays[b], dev, torch.float32),
                as_tensor(depths[b], dev, torch.float32), generator=gen)
            out[b] = poses
    return mesh.all_reduce_(out)
