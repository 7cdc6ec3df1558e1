"""Pose-pose edge graphs for the tests of ``ops/pp_edge.py``: made on the
CPU from a seed, then moved to the device, so the CPU and the card see the
same numbers.

Each graph holds K keyframe poses (random rotations, rotations near the
identity, exact identities, quaternions with w < 0, zero translations) and
E edge slots whose residual's rotation angle is drawn across both Taylor
windows of the chain (0 exactly, 1e-6 .. 1e-2, just inside and outside
θ² = 0.25, up to θ near π), with measured poses given with w < 0 on some
slots, invalid slots and stale generations on others."""

from __future__ import annotations

import math

import torch

from putslam_tpu_torch.backend.graph import GraphState
from putslam_tpu_torch.geometry import se3

ANGLES = (0.0, 1e-6, 1e-4, 1e-2, 0.3, 0.499, 0.501, 1.0, 2.0, 3.0,
          math.pi - 1e-3, math.pi - 1e-6)


def _unit(g, n):
    v = torch.randn((n, 3), generator=g)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _quats(g, n):
    """Random rotations, a third near the identity, every 7th the identity,
    a quarter with w < 0."""
    ang = torch.rand((n,), generator=g) * 2 * math.pi
    small = torch.rand((n,), generator=g) < 0.33
    ang = torch.where(small, ang * 1e-4, ang)
    q = torch.cat([torch.cos(ang / 2)[:, None],
                   torch.sin(ang / 2)[:, None] * _unit(g, n)], dim=-1)
    q[::7] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    flip = torch.rand((n,), generator=g) < 0.25
    return torch.where(flip[:, None], -q, q)


def make(E: int, K: int, seed: int, device="cpu", stale: bool = True):
    """(g, kf_pose (K, 7), kf_gen (K,) int32) with E pose-pose slots."""
    g = torch.Generator().manual_seed(seed)
    t = torch.randn((K, 3), generator=g) * 2.0
    t[::5] = 0.0
    kf_pose = torch.cat([t, _quats(g, K)], dim=-1)
    pi = torch.randint(0, K, (E,), generator=g, dtype=torch.int32)
    pj = torch.randint(0, K, (E,), generator=g, dtype=torch.int32)
    # the residual's rotation: an angle of ANGLES about a random axis
    ang = torch.tensor(ANGLES)[torch.randint(0, len(ANGLES), (E,),
                                             generator=g)]
    xi = torch.cat([torch.randn((E, 3), generator=g) * 0.05,
                    _unit(g, E) * ang[:, None]], dim=-1)
    xi[ang == 0.0, :3] = 0.0
    rel = se3.compose(se3.relative(kf_pose[pi.long()], kf_pose[pj.long()]),
                      se3.exp(-xi))
    flip = torch.rand((E,), generator=g) < 0.3
    rel = torch.cat([rel[:, :3], torch.where(flip[:, None], -rel[:, 3:],
                                             rel[:, 3:])], dim=-1)
    kf_gen = torch.randint(0, 4, (K,), generator=g, dtype=torch.int32)
    gen_i = kf_gen[pi.long()].clone()
    gen_j = kf_gen[pj.long()].clone()
    if stale:
        gen_i[torch.rand((E,), generator=g) < 0.1] += 1
        gen_j[torch.rand((E,), generator=g) < 0.1] += 1
    valid = torch.rand((E,), generator=g) < 0.75
    w = torch.rand((E,), generator=g) * 100.0
    z = torch.zeros((1,), dtype=torch.int32)
    graph = GraphState(
        obs_kf=z, obs_lm=z, obs_xyz=torch.zeros((1, 3)),
        obs_w=torch.zeros((1,)), obs_info=torch.zeros((1, 3, 3)),
        obs_gen=z, obs_kfgen=z, obs_seq=z,
        obs_valid=torch.zeros((1,), dtype=torch.bool),
        n_obs=torch.zeros((), dtype=torch.int32), pp_i=pi, pp_j=pj,
        pp_rel=rel.contiguous(), pp_w=w, pp_gen_i=gen_i, pp_gen_j=gen_j,
        pp_valid=valid, n_pp=torch.tensor(E, dtype=torch.int32))
    dev = torch.device(device)
    return (GraphState(*(x.to(dev) for x in graph)), kf_pose.to(dev),
            kf_gen.to(dev))


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) \
        if x.dtype == torch.float32 else x
