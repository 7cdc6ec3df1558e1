"""What a traced run reads from ``torch.profiler`` on the card: the device
operations (kernels, copies, fills), the host's spans and operations, the
device's busy time as the union of the operations' intervals (IF-node
bodies run on a stream of their own, so summed times could count one
instant twice), the idle gaps between them named by what the host was
doing, and the operations that took most time."""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "slambench.window"
# a gap shorter than this is a launch gap inside a graph or between
# back-to-back launches, not the host holding the card back
GAP_NAMED_US = 20.0
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list            # (name, start_ns, duration_ns) of device operations
    idle_gaps: list      # [[what the host did, seconds]], longest first
    device_ops: list     # [[name, seconds]], most time first

    def kernel_durations_s(self, fragment: str) -> list:
        """Own durations (s) of the device operations whose name holds
        ``fragment``."""
        return [d * 1e-9 for n, _, d in self.ops if fragment in n]


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _kind(e) -> str:
    """The activity type of a kineto event; older PyTorch builds lack
    ``activity_type``, and their kinds are told apart by device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    annotation = e.name().startswith("slambench.")
    if "CUDA" in str(e.device_type()):
        if annotation:
            return "gpu_user_annotation"
        name = e.name()
        return "gpu_memcpy" if name.startswith("Memcpy") else \
            "gpu_memset" if name.startswith("Memset") else "kernel"
    return "user_annotation" if annotation else "cpu_op"


def read(prof) -> Trace:
    """The trace of a ``torch.profiler.profile`` whose traced work ran
    inside one ``record_function(WINDOW)``."""
    events = prof.profiler.kineto_results.events()
    ops, host, spans = [], [], defaultdict(list)
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            if e.duration_ns() > 0:
                ops.append((e.name(), e.start_ns(), e.duration_ns()))
        elif kind in HOST_KINDS:
            s, d = e.start_ns(), e.duration_ns()
            host.append((e.name(), s, s + d))
            if kind == "user_annotation" and e.name().startswith("slambench."):
                spans[e.name()].append((s, s + d))
    if not spans.get(WINDOW):
        raise RuntimeError("the traced run has no window span")
    w0, w1 = spans[WINDOW][0]
    starts = np.array([s for _, s, _ in ops], np.int64)
    ends = starts + np.array([d for _, _, d in ops], np.int64)
    keep = (ends > w0) & (starts < w1)
    starts, ends = np.clip(starts[keep], w0, w1), np.clip(ends[keep], w0, w1)
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    # union of intervals: a new run begins where a start passes every
    # earlier end
    run_end = np.maximum.accumulate(ends) if len(ends) else ends
    new = np.ones(len(starts), bool)
    new[1:] = starts[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    u_start = starts[idx]
    u_end = np.append(run_end[idx[1:] - 1], run_end[-1]) if len(idx) else idx
    busy_ns = int(np.sum(u_end - u_start)) if len(idx) else 0

    gap_s = np.concatenate([[w0], u_end]) if len(idx) else np.array([w0])
    gap_e = np.concatenate([u_start, [w1]]) if len(idx) else np.array([w1])
    gaps = gap_e - gap_s
    named = gaps > GAP_NAMED_US * 1e3
    idle = defaultdict(float)
    idle[f"gaps under {GAP_NAMED_US:g} us"] = float(np.sum(gaps[~named])) * 1e-9
    if named.any() and host:
        h_name = [n for n, _, _ in host]
        h_s = np.array([s for _, s, _ in host], np.int64)
        h_e = np.array([e for _, _, e in host], np.int64)
        h_len = h_e - h_s
        for gs, ge in zip(gap_s[named], gap_e[named]):
            mid = (gs + ge) // 2
            inside = np.flatnonzero((h_s <= mid) & (h_e >= mid))
            what = "host idle (no span or operation)"
            if len(inside):
                what = h_name[inside[np.argmin(h_len[inside])]]
            idle[_short(what)] += float(ge - gs) * 1e-9
    by_name = defaultdict(float)
    for n, _, d in ops:
        by_name[_short(n)] += d * 1e-9
    return Trace(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, ops=ops,
        idle_gaps=[[k, v] for k, v in sorted(idle.items(),
                                             key=lambda kv: -kv[1])[:TOP]],
        device_ops=[[k, v] for k, v in sorted(by_name.items(),
                                              key=lambda kv: -kv[1])[:TOP]])
