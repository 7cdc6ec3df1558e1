"""Mean host ms of one ``slam_sequence`` call through the graph runner (the
``step`` span, one frame live: the state's load, the frame's copies, the
draws, the replay's launch, the clones), over the calls no profiler
recorded and that captured no graph."""

import numpy as np

from slambench import recorder


def read(ctx):
    s = recorder.snapshot(ctx)
    if s is None:
        return None
    sp = s["spans"]
    captured = np.isin(sp["index"], sp["parent"][sp["name"] == "capture"])
    sel = (sp["name"] == "step") & ~sp["profiled"] & ~captured
    if not sel.any():
        return None
    return 1e-6 * float((sp["end"][sel] - sp["start"][sel]).mean())
