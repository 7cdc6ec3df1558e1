"""Mean device ms a replayed frame of its ``detect`` stage
(``frontend/detector.py::detect_and_describe`` inside ``slam_track``: the
pyramid, FAST, the keypoint chain and the descriptor product), over the
replays no profiler slowed; None where the port's recorder has no such
stage."""

from slambench import recorder


def read(ctx):
    snap = recorder.snapshot(ctx)
    if snap is None or "detect" not in snap["stages"]:
        return None
    return recorder.mean_ms(snap, "frame", "detect")
