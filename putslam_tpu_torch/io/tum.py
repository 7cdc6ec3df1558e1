"""TUM-format trajectory output (``save_trajectory`` of
``putslam_tpu/io/tum.py``). Reading TUM sequences is not ported yet."""

from __future__ import annotations

import numpy as np


def save_trajectory(path: str, timestamps: np.ndarray, poses: np.ndarray) -> None:
    """Write ``t tx ty tz qx qy qz qw`` lines."""
    with open(path, "w") as f:
        for ts, p in zip(timestamps, poses):
            tx, ty, tz, qw, qx, qy, qz = [float(x) for x in p[:7]]
            f.write(f"{ts:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")
