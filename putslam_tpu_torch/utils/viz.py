"""Offline visualization: trajectory and map renders to image files.

Port of ``putslam_tpu/utils/viz.py:15-102`` (``plot_trajectory``,
``plot_map``, ``plot_run_stats``): the same figures from the same arrays.
The inputs may be tensors on any device, numpy arrays or sequences; each
goes to the host through ``utils/device.py::as_numpy``. matplotlib is
imported lazily, with the Agg backend, when a plot is drawn: this module
imports without it, and a plot raises ``ImportError`` where it is absent.
"""

from __future__ import annotations

import numpy as np

from putslam_tpu_torch.utils.device import as_numpy


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(path: str, est_poses, gt_poses=None, title: str = ""):
    """Top-down (x-z) + height profile of a trajectory; optional ground
    truth overlay (``putslam_tpu/utils/viz.py:24``)."""
    plt = _plt()
    est = as_numpy(est_poses)
    gt = None if gt_poses is None else as_numpy(gt_poses)
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    axes[0].plot(est[:, 0], est[:, 2], "b-", lw=1.2, label="estimate")
    if gt is not None:
        axes[0].plot(gt[:, 0], gt[:, 2], "g--", lw=1.0, label="ground truth")
    axes[0].set_xlabel("x [m]")
    axes[0].set_ylabel("z [m]")
    axes[0].axis("equal")
    axes[0].legend()
    axes[0].set_title(title or "trajectory (top-down)")
    axes[1].plot(est[:, 1], "b-", lw=1.0, label="est y")
    if gt is not None:
        axes[1].plot(gt[:, 1], "g--", lw=1.0, label="gt y")
    axes[1].set_xlabel("frame")
    axes[1].set_ylabel("y [m]")
    axes[1].legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_map(path: str, map_state, est_poses=None, title: str = ""):
    """Landmarks (x-z scatter colored by observation count) + keyframes
    (``putslam_tpu/utils/viz.py:50``)."""
    plt = _plt()
    lm = as_numpy(map_state.lm_pos)
    ok = as_numpy(map_state.lm_valid)
    nobs = as_numpy(map_state.lm_n_obs)
    kf = as_numpy(map_state.kf_pose)
    kv = as_numpy(map_state.kf_valid)
    fig, ax = plt.subplots(figsize=(7, 6))
    sc = ax.scatter(lm[ok, 0], lm[ok, 2], c=np.clip(nobs[ok], 0, 20), s=4,
                    cmap="viridis", alpha=0.7)
    fig.colorbar(sc, ax=ax, label="observations")
    ax.plot(kf[kv, 0], kf[kv, 2], "r^-", ms=4, lw=0.8, label="keyframes")
    if est_poses is not None:
        est = as_numpy(est_poses)
        ax.plot(est[:, 0], est[:, 2], "b-", lw=0.8, alpha=0.6,
                label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.set_title(title or f"map: {int(ok.sum())} landmarks")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_run_stats(path: str, outs, title: str = ""):
    """Per-frame inliers / landmark growth / keyframes / BA chi²
    (``putslam_tpu/utils/viz.py:77``; the content of the reference's
    generated statistics.py)."""
    plt = _plt()
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    axes[0, 0].plot(as_numpy(outs.n_map_inliers), lw=0.9)
    axes[0, 0].set_title("map-matching inliers / frame")
    axes[0, 1].plot(as_numpy(outs.n_landmarks), lw=0.9)
    axes[0, 1].set_title("landmarks")
    kfs = as_numpy(outs.is_keyframe).astype(int)
    axes[1, 0].plot(np.cumsum(kfs), lw=0.9)
    axes[1, 0].set_title("cumulative keyframes")
    chi = as_numpy(outs.chi2)
    if chi.ndim == 2:
        chi = chi[:, -1]
    ba = as_numpy(outs.ba_ran).astype(bool)
    axes[1, 1].semilogy(np.nonzero(ba)[0], np.maximum(chi[ba], 1e-9), "o-",
                        ms=3, lw=0.8)
    axes[1, 1].set_title("BA chi² (at BA steps)")
    for ax in axes.flat:
        ax.set_xlabel("frame")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
