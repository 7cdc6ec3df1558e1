"""Mean device ms a replayed frame of its ``guided`` stage (guided map
matching inside ``slam_track``: the landmarks in the camera frame and the
match of every landmark against the frame, its first pass and each rung of
the retry ladder that ran), over the replays no profiler slowed; None where
the port's recorder has no such stage."""

from slambench import recorder


def read(ctx):
    snap = recorder.snapshot(ctx)
    if snap is None or "guided" not in snap["stages"]:
        return None
    return recorder.mean_ms(snap, "frame", "guided")
