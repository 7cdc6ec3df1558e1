"""What the per-layer metrics of the port's flight recorder read
(``putslam_tpu_torch/utils/timing.py``): its snapshot, taken once a run
(after the window) and shared by the readers through their ``ctx``, and
the replays that no profiler slowed. Where the port has no recorder or it
recorded nothing (the eager path on the CPU), a reader returns None."""

from __future__ import annotations

import numpy as np

KEY = "recorder_snapshot"


def _take():
    try:
        from putslam_tpu_torch.utils import timing
    except ImportError:
        return None
    take = getattr(timing, "snapshot", None)
    return None if take is None else take()


def snapshot(ctx):
    """The recorder's snapshot (taken on the first call of a run), or
    None."""
    if KEY not in ctx:
        ctx[KEY] = _take()
    return ctx[KEY]


def replays(snap, root: str):
    """Indices of the replays whose row the stage ``root`` opened, kept in
    the ring, made while no profiler recorded; None where there are none."""
    if snap is None or root not in snap["stages"]:
        return None
    k = snap["stages"].index(root)
    idx = np.flatnonzero(snap["valid"] & ~snap["profiled"]
                         & (snap["root"] == k))
    return idx if len(idx) else None


def column(snap, field: str, stage: str) -> np.ndarray:
    """``snap[field]`` (``begin``, ``end``, ``total``, ``count``) of one
    stage, over all replays."""
    return snap[field][:, snap["stages"].index(stage)]


def mean_ms(snap, root: str, stage: str):
    """Mean ms of ``stage`` a replay opened by ``root`` (unprofiled)."""
    idx = replays(snap, root)
    if idx is None:
        return None
    return 1e-6 * float(column(snap, "total", stage)[idx].mean())
