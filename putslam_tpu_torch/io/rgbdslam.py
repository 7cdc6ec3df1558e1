"""RGB-D SLAM trajectory exchange, the port's counterpart of
``putslam_tpu/io/rgbdslam.py:22,48``: one ``timestamp tx ty tz qx qy qz qw``
line per keyframe out, and a trajectory read back as a pose graph whose
consecutive vertices are linked by unit-weight relative edges, the first
vertex fixed. Text on the host in numpy; ``import_rgbdslam`` returns tensors
on ``device``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from putslam_tpu_torch.backend.graph import (GraphState, add_pose_pose,
                                             init_graph)
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.utils.device import as_numpy


def export_rgbdslam(path: str, kf_pose, kf_valid,
                    timestamps: Optional[np.ndarray] = None,
                    kf_seq=None) -> int:
    """Write the valid keyframes as RGB-D SLAM trajectory lines, ordered by
    keyframe sequence number when ``kf_seq`` is given, in ring order
    otherwise (``putslam_tpu/io/rgbdslam.py:22``). Returns the number of
    lines written."""
    kf_pose = as_numpy(kf_pose)
    kf_valid = as_numpy(kf_valid)
    idx = np.nonzero(kf_valid)[0]
    if kf_seq is not None:
        seq = as_numpy(kf_seq)[idx]
        idx = idx[np.argsort(seq, kind="stable")]
    if timestamps is None:
        timestamps = np.arange(len(idx), dtype=np.float64)
    n = 0
    with open(path, "w") as f:
        for row, k in enumerate(idx):
            tx, ty, tz, qw, qx, qy, qz = [float(v) for v in kf_pose[k]]
            ts = float(timestamps[row] if row < len(timestamps) else row)
            f.write(f"{ts:.6f} {tx} {ty} {tz} {qx} {qy} {qz} {qw}\n")
            n += 1
    return n


def import_rgbdslam(path: str, max_keyframes: int, max_pose_pose: int,
                    device="cpu"
                    ) -> Tuple[torch.Tensor, torch.Tensor, GraphState,
                               torch.Tensor, np.ndarray]:
    """Read an RGB-D SLAM trajectory into array state and a pose graph with
    consecutive relative edges of weight 1, first vertex fixed
    (``putslam_tpu/io/rgbdslam.py:48``).

    Returns (kf_pose (K,7), kf_valid (K,), GraphState, fixed_kf (K,),
    timestamps (n,) numpy)."""
    kf_pose = np.tile(np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                      (max_keyframes, 1))
    kf_valid = np.zeros(max_keyframes, bool)
    stamps = []
    n = 0
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if len(tok) < 8:
                raise ValueError(
                    f"{path}: malformed RGB-D SLAM line "
                    f"(need 8 values): {line.rstrip()!r}")
            if n >= max_keyframes:
                break
            ts, tx, ty, tz, qx, qy, qz, qw = map(float, tok[:8])
            kf_pose[n] = [tx, ty, tz, qw, qx, qy, qz]
            kf_valid[n] = True
            stamps.append(ts)
            n += 1

    g = init_graph(8, max_pose_pose, device)
    kf_t = torch.as_tensor(kf_pose, device=device)
    for i in range(1, n):
        # edge i-1 → i measures rel = pose_{i-1}⁻¹ ∘ pose_i
        rel = se3.relative(kf_t[i - 1], kf_t[i])
        g = add_pose_pose(g, i - 1, i, rel, 1.0, True)
    fixed = np.zeros(max_keyframes, bool)
    if n:
        fixed[0] = True
    return (kf_t, torch.as_tensor(kf_valid, device=device), g,
            torch.as_tensor(fixed, device=device), np.asarray(stamps))
