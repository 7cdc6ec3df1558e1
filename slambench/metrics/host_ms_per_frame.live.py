"""Host ms a live frame: the mean latency (due time to pose on the host)
of the window's untraced frames less the device busy time a frame of its
traced frames (the window's last ``trace_frames``): the hand-off, the
draws, the state's load and clone, the replay's launch and the pose read.
The traced frames' own latencies are not used: under the profiler each
graph replay's launch takes milliseconds longer."""


def read(ctx):
    w = ctx["window"]
    if not w.traced_frames or not w.latencies:
        return None
    return 1e3 * (sum(w.latencies) / len(w.latencies)
                  - ctx["trace"].busy_s / w.traced_frames)
