"""Absolute Trajectory Error — TUM benchmark semantics, numpy only.

Copy of ``putslam_tpu/eval/ate.py`` (which is numpy too, but its package
imports JAX): Horn closed-form rigid alignment and translational RMSE.
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


def ate_rmse_aligned_frames(gt_poses: np.ndarray, est_poses: np.ndarray) -> float:
    """ATE RMSE (m) of frame-aligned (N, 7) trajectories."""
    n = min(len(gt_poses), len(est_poses))
    _, _, err = horn_align(np.asarray(est_poses)[:n, :3].T,
                           np.asarray(gt_poses)[:n, :3].T)
    return float(np.sqrt((err ** 2).mean()))
