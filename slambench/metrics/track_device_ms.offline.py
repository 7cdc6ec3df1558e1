"""Mean device ms a replayed frame of its ``track`` stage (``slam_track``:
detection, VO and its retry, guided matching with the retry ladder, the
gate and the flags), over the replays no profiler slowed."""

from slambench import recorder


def read(ctx):
    return recorder.mean_ms(recorder.snapshot(ctx), "frame", "track")
