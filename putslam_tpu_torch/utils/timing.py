"""Per-stage wall-clock timing with the reference's dump names
(``times.txt``, ``fps.res``) — copy of ``putslam_tpu/utils/timing.py``.
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
