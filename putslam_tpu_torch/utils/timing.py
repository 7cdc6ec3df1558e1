"""Per-stage wall-clock timing and run statistics with the reference's dump
names (``times.txt``, ``fps.res``, ``statistics.txt``) — copy of
``putslam_tpu/utils/timing.py``.
Stages timed around device work must end in ``torch.cuda.synchronize()``
to measure the device and not the enqueue."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


class StageTimer:
    """Accumulates wall-clock samples per named stage."""

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"mean_ms": 1e3 * sum(xs) / max(len(xs), 1),
                       "total_s": sum(xs), "count": len(xs)}
                for name, xs in self.samples.items()}

    def write_times_txt(self, path: str) -> None:
        """times.txt: per-stage mean/total."""
        with open(path, "w") as f:
            for name, s in sorted(self.summary().items()):
                f.write(f"{name}: mean {s['mean_ms']:.3f} ms over "
                        f"{int(s['count'])} calls (total {s['total_s']:.3f} s)\n")


def write_fps(path: str, n_frames: int, total_seconds: float) -> None:
    """fps.res — a single number."""
    with open(path, "w") as f:
        f.write(f"{n_frames / max(total_seconds, 1e-9):.3f}\n")


def write_run_statistics(path: str, outs) -> None:
    """statistics.txt: inlier counts, map matches, keyframe / BA cadence and
    landmark growth of a SLAM run, one ``key value`` per line, with the JAX
    package's keys and formats. ``outs``: ``SlamOutputs`` with numpy (or
    tensor) fields stacked over the frames."""
    import numpy as np

    def arr(name):
        x = getattr(outs, name)
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    with open(path, "w") as f:
        f.write(f"frames {len(arr('pose'))}\n")
        f.write(f"vo_ok_fraction {float(arr('vo_ok').mean()):.4f}\n")
        f.write(f"map_ok_fraction {float(arr('map_ok').mean()):.4f}\n")
        f.write(f"keyframes {int(arr('is_keyframe').sum())}\n")
        f.write(f"ba_runs {int(arr('ba_ran').sum())}\n")
        f.write(f"map_inliers_median "
                f"{float(np.median(arr('n_map_inliers'))):.1f}\n")
        f.write(f"map_matches_median "
                f"{float(np.median(arr('n_map_matches'))):.1f}\n")
        f.write(f"landmarks_final {int(arr('n_landmarks')[-1])}\n")
