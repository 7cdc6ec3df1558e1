"""Camera walks through the room, drawn from a seed.

``handheld`` is a frozen copy of ``putslam_tpu_torch/io/synthetic.py::
handheld_trajectory`` at commit 6b05da9: Gaussian-smoothed random walks in
translation and rotation, each rescaled so that its median step a frame is
the given one, clamped to stay inside the room, the camera near (0, 0,
-0.5) facing the +z wall. ``walk`` is the one generator the traffic files
drive: that handheld jitter, its steps and amplitudes given by the
traffic file.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.gen import se3


def _smooth_channels(n_frames: int, rng, specs):
    """One smoothed random walk per (amplitude, median step) in ``specs``,
    drawn in order from ``rng`` (numpy (n_frames, len(specs)))."""
    sigma = 25.0
    pad = int(4 * sigma)
    k = np.exp(-0.5 * ((np.arange(-pad, pad + 1)) / sigma) ** 2)
    k /= k.sum()
    out = []
    for amp, target_step in specs:
        raw = rng.normal(size=(n_frames + 2 * pad,))
        s = np.convolve(raw, k, mode="valid")[:n_frames]
        s = s - s.mean()
        d = np.abs(np.diff(s))
        scale = target_step / max(np.median(d), 1e-12)
        out.append(np.clip(s * scale, -amp, amp))
    return np.stack(out, axis=-1)


def handheld(n_frames: int, seed: int = 0, step_t: float = 0.013,
             step_r: float = 0.011, pos_amp=(0.9, 0.45, 0.6),
             rot_amp: float = 0.35):
    """(translations (n, 3), rotation vectors (n, 3)) as numpy float64: the
    handheld walk at fr1_desk-like steps (0.013 m, 0.011 rad a frame)."""
    rng = np.random.default_rng(seed)
    t = _smooth_channels(n_frames, rng, (
        (pos_amp[0], step_t), (pos_amp[1], 0.6 * step_t),
        (pos_amp[2], 0.8 * step_t)))
    t = t + np.array([0.0, 0.0, -0.5])
    rv = _smooth_channels(n_frames, rng, (
        (rot_amp * 0.6, 0.6 * step_r), (rot_amp, step_r),
        (rot_amp * 0.4, 0.4 * step_r)))
    return t, rv


def walk(n_frames: int, seed: int, step_t: float, step_r: float,
         pos_amp=(0.9, 0.45, 0.6), rot_amp: float = 0.35, device="cpu"):
    """(n_frames, 7) float32 camera→world poses on ``device``: the
    handheld walk (``step_t``, ``step_r``, ``pos_amp``, ``rot_amp``)."""
    t, rv = handheld(n_frames, seed, step_t, step_r, pos_amp, rot_amp)
    rv = torch.as_tensor(rv, dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    return se3.make_pose(t, se3.so3_exp_quat(rv))
