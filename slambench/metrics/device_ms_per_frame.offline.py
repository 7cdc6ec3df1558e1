"""Device ms a frame over the traced sequence (the window's last, run
once more under the profiler): the union of the intervals of every
kernel, copy and fill (torch.profiler) over its frames."""


def read(ctx):
    n = ctx["window"].traced_frames
    return 1e3 * ctx["trace"].busy_s / n if n else None
