"""Mean device ms of one in-loop BA call (the ``ba`` stage, its IF body),
over the unprofiled replays."""

from slambench import recorder


def read(ctx):
    s = recorder.snapshot(ctx)
    idx = recorder.replays(s, "frame")
    if idx is None:
        return None
    calls = int(recorder.column(s, "count", "ba")[idx].sum())
    if not calls:
        return None
    return 1e-6 * float(recorder.column(s, "total", "ba")[idx].sum()) / calls
