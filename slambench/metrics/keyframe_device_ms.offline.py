"""Mean device ms of a keyframe's bookkeeping and finish: the ``keyframe``
stage (its IF body) less the in-loop BA inside it, over the unprofiled
replays that took it."""

from slambench import recorder


def read(ctx):
    s = recorder.snapshot(ctx)
    idx = recorder.replays(s, "frame")
    if idx is None:
        return None
    idx = idx[recorder.column(s, "count", "keyframe")[idx] > 0]
    if not len(idx):
        return None
    own = (recorder.column(s, "total", "keyframe")[idx]
           - recorder.column(s, "total", "ba")[idx])
    return 1e-6 * float(own.mean())
