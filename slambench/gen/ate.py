"""Absolute trajectory error, TUM RGB-D's ``evaluate_ate``: Horn's
closed-form rigid alignment of the estimated positions onto the ground
truth, then the RMSE of the residuals.

Frozen copy of ``putslam_tpu_torch/eval/ate.py`` at commit 6b05da9
(``horn_align``), numpy in float64.
"""

from __future__ import annotations

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray):
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


def aligned_errors(gt_poses: np.ndarray, est_poses: np.ndarray) -> np.ndarray:
    """Per-frame position errors (m) of frame-aligned (N, 7) trajectories
    after Horn's alignment of the estimate onto the ground truth."""
    _, _, err = horn_align(np.asarray(est_poses)[:, :3].T,
                           np.asarray(gt_poses)[:, :3].T)
    return err
