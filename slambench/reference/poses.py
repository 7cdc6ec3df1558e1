"""Pose arithmetic of the check in numpy float64: the re-anchored
trajectory worked out again, and relative poses against the ground truth.

A pose is ``[tx, ty, tz, qw, qx, qy, qz]`` (camera→world, Hamilton
quaternions). Imports nothing of the port. ``dtype`` is the precision the
arithmetic runs in (the check's control runs it in bfloat16, which numpy
lacks: each result is rounded to bfloat16 through torch).
"""

from __future__ import annotations

import numpy as np
import torch


def _round(x, dtype):
    if dtype == np.float64:
        return x
    return torch.as_tensor(x).to(dtype).double().numpy()


def qmul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def qrot(q, v):
    w, u = q[..., :1], q[..., 1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def compose(a, b, dtype=np.float64):
    """a ∘ b (b applied first)."""
    q = qmul(a[..., 3:], b[..., 3:])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    t = a[..., :3] + qrot(a[..., 3:], b[..., :3])
    return _round(np.concatenate([t, q], axis=-1), dtype)


def inverse(p, dtype=np.float64):
    qc = p[..., 3:] * np.array([1.0, -1.0, -1.0, -1.0])
    return _round(np.concatenate([-qrot(qc, p[..., :3]), qc], axis=-1), dtype)


def reanchor(pose, anchor_ring, anchor_seq, anchor_pose, kf_pose, kf_seq,
             dtype=np.float64):
    """Each frame's pose moved with its anchor keyframe: kf_now ∘
    anchor_pose⁻¹ ∘ pose, where the ring slot still holds the keyframe the
    frame was anchored on; else the pose as emitted. (T, 7)."""
    pose, anchor_pose, kf_pose = (_round(np.asarray(x, np.float64), dtype)
                                  for x in (pose, anchor_pose, kf_pose))
    ring = np.asarray(anchor_ring, np.int64)
    same = np.asarray(kf_seq)[ring] == np.asarray(anchor_seq)
    moved = compose(kf_pose[ring], compose(inverse(anchor_pose, dtype), pose,
                                           dtype), dtype)
    return np.where(same[:, None], moved, pose)


def relative(a, b):
    """a⁻¹ ∘ b."""
    return compose(inverse(a), b)



def dead_reckon(gt, dtype=np.float64):
    """(T, 7) the trajectory chained from ``gt[0]`` by ``gt``'s
    frame-to-frame motions, each composition rounded to ``dtype``."""
    gt = np.asarray(gt, np.float64)
    rel = _round(relative(gt[:-1], gt[1:]), dtype)
    out = [_round(gt[0], dtype)]
    for r in rel:
        out.append(compose(out[-1], r, dtype))
    return np.stack(out)
