"""Mean device ms of the end-of-run polish: the ``finalize`` stamps (first
to last node of ``FinalizeGraphs``'s graph), a sequence, over the replays
no profiler slowed."""

from slambench import recorder


def read(ctx):
    return recorder.mean_ms(recorder.snapshot(ctx), "finalize", "finalize")
