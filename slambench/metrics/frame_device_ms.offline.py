"""Mean device ms of the replayed frame: the ``frame`` stamps (first to last
node of ``slam_frame``'s graph, the card's clock) over the replays no
profiler slowed (the window's and the warm-up's)."""

from slambench import recorder


def read(ctx):
    return recorder.mean_ms(recorder.snapshot(ctx), "frame", "frame")
