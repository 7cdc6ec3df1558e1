"""Relative Pose Error — TUM benchmark semantics, numpy only.

Counterpart of ``putslam_tpu/eval/rpe.py`` on numpy poses: for frame pairs
``delta`` apart, compare the estimate's relative motion with ground truth.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _to_matrix(p: np.ndarray) -> np.ndarray:
    """(N, 7) [t, q_wxyz] → (N, 4, 4)."""
    p = np.asarray(p, np.float64)
    q = p[:, 3:7] / np.linalg.norm(p[:, 3:7], axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(-1, 3, 3)
    T = np.tile(np.eye(4), (len(p), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = p[:, :3]
    return T


def rpe(gt_poses: np.ndarray, est_poses: np.ndarray, delta: int = 1
        ) -> Tuple[float, float]:
    """Frame-indexed RPE over all pairs (i, i+delta) of frame-aligned
    (N, 7) trajectories. Returns (trans_rmse_m, rot_rmse_rad)."""
    n = min(len(gt_poses), len(est_poses))
    if n <= delta:
        raise ValueError("not enough poses for the requested delta")
    gt = _to_matrix(gt_poses[:n])
    est = _to_matrix(est_poses[:n])
    gt_rel = np.linalg.inv(gt[:-delta]) @ gt[delta:]
    est_rel = np.linalg.inv(est[:-delta]) @ est[delta:]
    err = np.linalg.inv(est_rel) @ gt_rel
    terr = np.linalg.norm(err[:, :3, 3], axis=1)
    cos = np.clip((np.trace(err[:, :3, :3], axis1=1, axis2=2) - 1.0) / 2.0,
                  -1.0, 1.0)
    return (float(np.sqrt((terr ** 2).mean())),
            float(np.sqrt((np.arccos(cos) ** 2).mean())))
