"""Absolute Trajectory Error — TUM benchmark semantics, numpy only.

Copy of ``putslam_tpu/eval/ate.py`` (which is numpy too, but its package
imports JAX): Horn closed-form rigid alignment, timestamp association and
translational RMSE.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """R, t minimising ||R·model + t − data|| for (3, N) point sets.
    Returns (R (3,3), t (3,1), per-point error norms (N,))."""
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    model_zc = model - model.mean(axis=1, keepdims=True)
    data_zc = data - data.mean(axis=1, keepdims=True)
    W = model_zc @ data_zc.T
    U, _, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = data.mean(axis=1, keepdims=True) - R @ model.mean(axis=1, keepdims=True)
    err = np.linalg.norm(R @ model + t - data, axis=0)
    return R, t, err


def associate_timestamps(ts_a: np.ndarray, ts_b: np.ndarray,
                         max_difference: float = 0.02):
    """Greedy best-first 1-1 matching of two timestamp arrays
    (``putslam_tpu/eval/ate.py:39``)."""
    cand = []
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        d = abs(ts_b[j] - ta)
        if d < max_difference:
            cand.append((d, i, j))
    cand.sort()
    used_a, used_b, pairs = set(), set(), []
    for _, i, j in cand:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            pairs.append((i, j))
    pairs.sort()
    return pairs


def ate_rmse(gt_ts: np.ndarray, gt_poses: np.ndarray,
             est_ts: np.ndarray, est_poses: np.ndarray,
             max_difference: float = 0.02) -> float:
    """ATE RMSE (m) between a ground-truth and an estimated trajectory, both
    (N, 7) [t, q_wxyz] with timestamps: associate, Horn-align, RMSE
    (``putslam_tpu/eval/ate.py:59``)."""
    pairs = associate_timestamps(np.asarray(est_ts), np.asarray(gt_ts),
                                 max_difference)
    if len(pairs) < 2:
        raise ValueError("trajectories do not overlap in time")
    est_xyz = np.stack([est_poses[i][:3] for i, _ in pairs], axis=1)
    gt_xyz = np.stack([gt_poses[j][:3] for _, j in pairs], axis=1)
    _, _, err = horn_align(est_xyz, gt_xyz)
    return float(np.sqrt((err ** 2).mean()))


def ate_rmse_aligned_frames(gt_poses: np.ndarray, est_poses: np.ndarray) -> float:
    """ATE RMSE (m) of frame-aligned (N, 7) trajectories."""
    n = min(len(gt_poses), len(est_poses))
    _, _, err = horn_align(np.asarray(est_poses)[:n, :3].T,
                           np.asarray(gt_poses)[:n, :3].T)
    return float(np.sqrt((err ** 2).mean()))
