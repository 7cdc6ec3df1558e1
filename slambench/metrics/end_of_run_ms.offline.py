"""Mean ms per sequence of the end of an offline run: from ``slam.finalize``'s
call (after a synchronise) to ``run_slam_final``'s return with both
trajectories on the host, host clock, over the traced run's sequences."""


def read(ctx):
    spans = ctx["window"].end_of_run_s
    return 1e3 * sum(spans) / len(spans) if spans else None
