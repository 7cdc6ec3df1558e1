"""95th percentile of the replayed frame's device ms (the ``frame``
stamps), over the replays no profiler slowed."""

import numpy as np

from slambench import recorder


def read(ctx):
    s = recorder.snapshot(ctx)
    idx = recorder.replays(s, "frame")
    if idx is None:
        return None
    return 1e-6 * float(np.percentile(
        recorder.column(s, "total", "frame")[idx], 95))
