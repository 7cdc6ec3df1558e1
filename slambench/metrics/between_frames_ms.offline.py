"""Mean device ms between two replayed frames of one ``run_sequence`` call:
from a replay's last stamp to the next one's first (the card's clock), the
eager draws, copies and clones between them plus any idle; over the pairs
of consecutive unprofiled replays of one call."""

import numpy as np

from slambench import recorder


def read(ctx):
    s = recorder.snapshot(ctx)
    idx = recorder.replays(s, "frame")
    if idx is None or len(idx) < 2:
        return None
    a, b = idx[:-1], idx[1:]
    pair = ((s["replay"][b] == s["replay"][a] + 1)
            & (s["call"][a] == s["call"][b]) & (s["call"][a] >= 0)
            & (s["on_device"][a] == s["on_device"][b]))
    if not pair.any():
        return None
    gap = (recorder.column(s, "begin", "frame")[b[pair]]
           - recorder.column(s, "end", "frame")[a[pair]])
    return 1e-6 * float(np.mean(gap))
