"""Rungs of the map retry ladder run a frame: the ``map_retry`` stage's
count (one a rung whose IF body the card took) over the unprofiled
replays, divided by those replays."""

from slambench import recorder


def read(ctx):
    s = recorder.snapshot(ctx)
    idx = recorder.replays(s, "frame")
    if idx is None:
        return None
    return float(recorder.column(s, "count", "map_retry")[idx].sum()) / len(idx)
