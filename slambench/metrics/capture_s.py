"""Seconds of the process's CUDA-graph captures (the ``capture`` spans:
warm-up, capture and the recorder's ring, a graph each), part of set-up."""

from slambench import recorder


def read(ctx):
    s = recorder.snapshot(ctx)
    t = None if s is None else s["span_totals"].get("capture")
    return None if not t or not t["count"] else 1e-9 * t["total_ns"]
