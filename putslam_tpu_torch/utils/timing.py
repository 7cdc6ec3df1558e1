"""The port's flight recorder, and the reference's dump names (``times.txt``,
``fps.res``, ``statistics.txt``; ``putslam_tpu/utils/timing.py``, after
PUTSLAM's ``TimeMeasurement``).

The recorder is always on, bounded and in memory. It has two halves:

* **Host spans** (``span(name)``): name, start and end
  (``time.perf_counter_ns``), the span open around it (its parent) and the
  number of the replay it belongs to, in a ring of the last
  ``span_capacity`` spans, with each name's count and total kept for the
  whole process. While a ``torch.profiler`` records, a span is also a
  host operation ``putslam.<name>`` on the profiler's trace and its clock
  (``_RecordFunctionFast``: an operation, not a user annotation, of which
  the profiler would make a second event on the card's timeline, spanning
  the work launched inside it); otherwise the check for that is one call.
  The spans of the port: ``step`` (one ``compiled.run_sequence`` call)
  with its children ``load``, ``inputs``, ``draws``, ``replay`` and
  ``clone``; ``finalize``; ``capture`` (one CUDA-graph capture, warm-up
  included); ``build`` (one nvcc build, ``utils/cuda_lib.py``).
  ``StageTimer`` is a named group of spans with its own samples.

* **Stages** (``stage(name)``, ``STAGES``): a row a replay of a graph that
  opens one of the ``ROOTS`` stages (``frame``, one replay of
  ``slam.slam_frame``; ``finalize``, one of ``slam.finalize_map``) holds,
  for each stage, the time it last began and ended, its summed duration and
  how often it ran in that replay. Inside a CUDA-graph capture
  (``control.branching("capture")``) a stage's boundaries are launches of a
  one-thread kernel (``csrc/stamp.cu``) that reads the card's nanosecond
  clock (``%globaltimer``) and writes the row in a ring on the card: a node
  of the graph's serial chain, which works inside a conditional node's body
  (a stage there runs, and counts, only where the card takes the branch),
  and which ``control.checking()`` does not see (no torch operation). Under
  ``control.branching("host")`` (a runner with ``capture=False``) the same
  row is written from the host's clock into a ring on the host. In the
  ``"masked"`` mode (the eager step, the warm-up before a capture) nothing
  is recorded, nor outside a root stage. A capture records stages only
  inside ``capture(device)``, which makes the card's ring first.

One clock: at the card ring's creation one stamp is launched after a
synchronise between two reads of the host's clock (the narrowest of five
tries); the midpoint gives the offset between the two clocks and half the
bracket its error. ``snapshot`` measures it again and states a row's times
on the host's clock, the offset interpolated between the two readings
(the clocks drift apart by a few microseconds a minute). ``snapshot()`` (one copy of each card ring to the host, made only
when asked) returns the rows, the spans and the kernels' launch counters
(``cuda_lib.launch_counts()``) as plain numpy arrays.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from putslam_tpu_torch.utils import control, cuda_lib

STAGES = ("frame", "track", "vo_retry", "map_retry", "tail", "keyframe",
          "ba", "gn_iteration", "finalize", "detect", "guided")
ROOTS = ("frame", "finalize")
FIELDS = ("begin", "end", "total", "count")    # per stage in a row
WIDTH = 1 + len(FIELDS) * len(STAGES)    # a row: its sequence number first
HEAD = 8         # a card ring's header: rows opened, the open row, clocks
CLOCK_TRIES = 5
CAPACITY = 32768     # rows: the last replays kept
SPAN_CAPACITY = 131072
_OPEN, _BEGIN, _END, _CLOCK = range(4)         # the stamp kernel's operations
_STAGE = {name: i for i, name in enumerate(STAGES)}
_profiling = torch.autograd._profiler_enabled


def _bind(lib) -> None:
    lib.stamp_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.stamp_launch.restype = ctypes.c_int


_LIB = cuda_lib.Library("stamp", _bind, counted=False)


class _HostRing:
    """The rows of host-mode runs, on the host's clock."""

    on_device = False

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.rows = np.zeros((capacity, WIDTH), np.int64)
        self.seq = 0          # rows opened (counted by Recorder.replayed)
        self.slot = 0         # the open row's slot

    def stamp(self, stage: int, op: int) -> None:
        t = time.perf_counter_ns()
        if op == _OPEN:
            seq = self.seq - 1            # the row Recorder.replayed took
            self.slot = seq % self.capacity
            self.rows[self.slot] = 0
            self.rows[self.slot, 0] = seq
        s = self.rows[self.slot, 1 + len(FIELDS) * stage:]
        if op == _END:
            s[1] = t
            s[2] += t - s[0]
            s[3] += 1
        else:
            s[0] = t

    def read(self) -> np.ndarray:
        return self.rows


class _DeviceRing:
    """The rows of one card, written by the stamp kernel on its clock;
    ``seq`` counts on the host the rows the card has been asked to open."""

    on_device = True

    def __init__(self, capacity: int, device: torch.device):
        self.capacity = capacity
        self.device = device
        self.tensor = torch.zeros(HEAD + capacity * WIDTH, dtype=torch.int64,
                                  device=device)
        self.seq = 0
        self.first = self.measure_offset()

    def stamp(self, stage: int, op: int) -> None:
        _LIB.check(_LIB.library().stamp_launch(
            self.tensor.data_ptr(), self.capacity, len(STAGES), stage, op,
            torch.cuda.current_stream(self.device).cuda_stream),
            "launching a stamp")

    def measure_offset(self):
        """(the card's clock, card clock − host clock, half the bracket) in
        ns: the narrowest of ``CLOCK_TRIES`` stamps, each launched after a
        synchronise between two reads of the host's clock."""
        brackets = []
        for i in range(CLOCK_TRIES):
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter_ns()
            self.stamp(2 + i, _CLOCK)
            torch.cuda.synchronize(self.device)
            brackets.append((t0, time.perf_counter_ns()))
        clocks = self.tensor[2:2 + CLOCK_TRIES].tolist()
        i = min(range(CLOCK_TRIES), key=lambda k: brackets[k][1]
                - brackets[k][0])
        t0, t1 = brackets[i]
        return clocks[i], clocks[i] - (t0 + t1) // 2, (t1 - t0 + 1) // 2

    def to_host(self, t: np.ndarray, last) -> np.ndarray:
        """Card times ``t`` (ns) on the host's clock, the offset
        interpolated between the first reading and ``last``; 0 stays 0."""
        (c0, o0, _), (c1, o1, _) = self.first, last
        offset = o0 + (o1 - o0) * (t - c0) // max(c1 - c0, 1)
        return np.where(t != 0, t - offset, 0)

    def read(self) -> np.ndarray:
        return self.tensor[HEAD:].cpu().numpy().reshape(self.capacity, WIDTH)


class _Capture:
    def __init__(self, ring):
        self.ring = ring
        self.roots: List[int] = []     # root stages the capture opened


class Recorder:
    """The flight recorder's state: rings of rows and spans and what is
    open. One is current at a time (``recorder``, ``recording``)."""

    def __init__(self, capacity: int = CAPACITY,
                 span_capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self.span_capacity = span_capacity
        self.host = _HostRing(capacity)
        self.devices: Dict[int, _DeviceRing] = {}
        self.n_replays = 0
        # per replay, at replay % capacity: (replay, ring, ring row's
        # sequence number, root stage, step span, profiled)
        self.meta: list = [None] * capacity
        self.stages: List[int] = []        # open stages of a run or capture
        self.capturing: Optional[_Capture] = None
        self.n_spans = 0
        self.spans: list = [None] * span_capacity
        self.open_spans: List[int] = []
        self.call = -1                     # the open ``step`` span
        self.names: List[str] = []
        self.name_ids: Dict[str, int] = {}
        self.totals: List[list] = []       # per name: [count, total ns]

    def name_id(self, name: str) -> int:
        i = self.name_ids.get(name)
        if i is None:
            i = self.name_ids[name] = len(self.names)
            self.names.append(name)
            self.totals.append([0, 0])
        return i

    def device_ring(self, device) -> _DeviceRing:
        dev = torch.device(device)
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        ring = self.devices.get(idx)
        if ring is None:
            _LIB.library()
            ring = self.devices[idx] = _DeviceRing(self.capacity,
                                                   torch.device("cuda", idx))
        return ring

    def replayed(self, ring, root: int) -> None:
        """A row opened in ``ring`` by the root stage ``root``: the next
        replay."""
        r = self.n_replays
        self.meta[r % self.capacity] = (r, ring, ring.seq, root, self.call,
                                        _profiling())
        ring.seq += 1
        self.n_replays = r + 1


_recorder = Recorder()


def recorder() -> Recorder:
    """The current recorder."""
    return _recorder


@contextlib.contextmanager
def recording(rec: Recorder):
    """Make ``rec`` the current recorder inside the block (tests). A graph
    keeps the recorder it was captured under."""
    global _recorder
    old, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = old


# ---- host spans -------------------------------------------------------------


class _Span:
    __slots__ = ("rec", "nid", "name", "replay", "index", "parent", "t0",
                 "rf", "call")

    def __init__(self, rec, name, replay):
        self.rec, self.name, self.replay = rec, name, replay
        self.nid = rec.name_id(name)

    def __enter__(self):
        rec = self.rec
        self.index = i = rec.n_spans
        rec.n_spans = i + 1
        self.parent = rec.open_spans[-1] if rec.open_spans else -1
        rec.open_spans.append(i)
        if self.replay is None:
            self.replay = rec.n_replays
        self.call = rec.call
        if self.name == "step":
            rec.call = i
        self.rf = None
        if _profiling():
            self.rf = torch._C._profiler._RecordFunctionFast(
                "putslam." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec.open_spans.pop()
        rec.call = self.call
        rec.spans[self.index % rec.span_capacity] = (
            self.index, self.nid, self.t0, t1, self.parent, self.replay,
            self.rf is not None)
        tot = rec.totals[self.nid]
        tot[0] += 1
        tot[1] += t1 - self.t0
        return False


def span(name: str, replay: Optional[int] = None) -> _Span:
    """A host span around the block. ``replay``: the replay it belongs to
    (default: the next one)."""
    return _Span(_recorder, name, replay)


def next_replay() -> int:
    """The number the next replay will take."""
    return _recorder.n_replays


def span_total_s(name: str) -> float:
    """Seconds of all spans named ``name`` in this process (the current
    recorder's)."""
    i = _recorder.name_ids.get(name)
    return 0.0 if i is None else _recorder.totals[i][1] * 1e-9


class StageTimer:
    """Wall-clock samples per named stage, each one a span of the
    recorder."""

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"mean_ms": 1e3 * sum(xs) / max(len(xs), 1),
                       "total_s": sum(xs), "count": len(xs)}
                for name, xs in self.samples.items()}

    def write_times_txt(self, path: str) -> None:
        """times.txt: per-stage mean/total of this timer, then the
        recorder's: per span name its host mean, per stage its mean a run
        and counts (``recorder_lines``)."""
        with open(path, "w") as f:
            for name, s in sorted(self.summary().items()):
                f.write(f"{name}: mean {s['mean_ms']:.3f} ms over "
                        f"{int(s['count'])} calls "
                        f"(total {s['total_s']:.3f} s)\n")
            for line in recorder_lines(snapshot(), skip=self.samples):
                f.write(line + "\n")


# ---- stages -----------------------------------------------------------------


class _Stage:
    __slots__ = ("rec", "ring", "stage", "op")

    def __init__(self, rec, ring, stage, op):
        self.rec, self.ring, self.stage, self.op = rec, ring, stage, op

    def __enter__(self):
        rec = self.rec
        if self.op == _OPEN:
            if rec.capturing is not None:
                rec.capturing.roots.append(self.stage)
            else:
                rec.replayed(self.ring, self.stage)
        self.ring.stamp(self.stage, self.op)
        rec.stages.append(self.stage)
        return self

    def __exit__(self, exc_type, *exc):
        self.rec.stages.pop()
        if exc_type is None:
            self.ring.stamp(self.stage, _END)
        return False


def stage(name: Optional[str]):
    """Record the block as the stage ``name`` (one of ``STAGES``; None
    records nothing) in the branching mode in force: stamps in a capture,
    the host's clock in ``"host"`` mode, nothing when masked or outside a
    root stage."""
    if name is None:
        return contextlib.nullcontext()
    mode = control.mode()
    rec = _recorder
    st = _STAGE[name]
    root = not rec.stages
    if mode == "masked" or (root and name not in ROOTS):
        return contextlib.nullcontext()
    if mode == "capture":
        if rec.capturing is None:
            return contextlib.nullcontext()
        ring = rec.capturing.ring
    else:
        ring = rec.host
    return _Stage(rec, ring, st, _OPEN if root else _BEGIN)


@contextlib.contextmanager
def capture(device):
    """Around one CUDA-graph capture on ``device`` (a ``capture`` span):
    makes the card's ring before the capture begins; yields the list of
    root stages the capture opens, one replayed row each."""
    rec = _recorder
    with span("capture"):
        ring = rec.device_ring(device)
        cap = _Capture(ring)
        old, rec.capturing = rec.capturing, cap
        try:
            yield cap
        finally:
            rec.capturing = old


# ---- reading ----------------------------------------------------------------


def snapshot(rec: Optional[Recorder] = None) -> dict:
    """What the recorder holds, as plain numpy arrays (one copy of each card
    ring to the host):

    * ``stages``: ``STAGES``; per replay kept, in order (n of them):
      ``replay``, ``root`` (the stage that opened its row), ``on_device``,
      ``profiled`` (a ``torch.profiler`` recorded at its replay), ``call``
      (the index of the ``step`` span it ran in, or -1), ``valid`` (its row
      is still in the ring); per replay and stage (n, len(STAGES)):
      ``begin`` and ``end`` (the stage's last, ns on the host's clock, 0
      where it did not run), ``total`` (ns) and ``count``;
    * ``spans``: ``index``, ``name``, ``start``, ``end`` (ns), ``parent``,
      ``replay``, ``profiled`` of the spans kept; ``span_totals``: per name
      of the whole process, ``count`` and ``total_ns``;
    * ``clock``: per card, ``offset_ns`` (card − host, first reading),
      ``drift_ns`` (the offset now less the first), ``over_s`` (seconds
      between the two) and ``error_ns`` (the wider half bracket);
    * ``launches``: the launch counters of the kernels that are loaded
      (``cuda_lib.launch_counts()``: ``{name: n}``, ``{name.mode: n}``)."""
    rec = rec or _recorder
    n = min(rec.n_replays, rec.capacity)
    meta = [rec.meta[r % rec.capacity]
            for r in range(rec.n_replays - n, rec.n_replays)]
    tables = {id(rec.host): rec.host.read()}
    clock, last = {}, {}
    for idx, ring in rec.devices.items():
        tables[id(ring)] = ring.read()
        last[id(ring)] = c1, o1, e1 = ring.measure_offset()
        c0, o0, e0 = ring.first
        clock[idx] = {"offset_ns": o0, "drift_ns": o1 - o0,
                      "over_s": (c1 - c0) * 1e-9, "error_ns": max(e0, e1)}
    S = len(STAGES)
    rows = np.zeros((n, S, len(FIELDS)), np.int64)
    valid = np.zeros(n, bool)
    for i, (_, ring, seq, _, _, _) in enumerate(meta):
        row = tables[id(ring)][seq % ring.capacity]
        if row[0] == seq and (seq or row[1:].any()):
            valid[i] = True
            rows[i] = row[1:].reshape(S, len(FIELDS))
    for ring in rec.devices.values():
        sel = np.array([m[1] is ring for m in meta], bool) & valid
        rows[sel, :, :2] = ring.to_host(rows[sel, :, :2], last[id(ring)])
    out = {"stages": STAGES,
           "replay": np.array([m[0] for m in meta], np.int64),
           "on_device": np.array([m[1].on_device for m in meta], bool),
           "root": np.array([m[3] for m in meta], np.int64),
           "call": np.array([m[4] for m in meta], np.int64),
           "profiled": np.array([m[5] for m in meta], bool),
           "valid": valid}
    for k, f in enumerate(FIELDS):
        out[f] = rows[:, :, k]
    m = min(rec.n_spans, rec.span_capacity)
    kept = [e for e in (rec.spans[j % rec.span_capacity]
                        for j in range(rec.n_spans - m, rec.n_spans))
            if e is not None and e[0] >= rec.n_spans - m]   # closed ones
    cols = list(zip(*kept)) if kept else [()] * 7
    out["spans"] = {
        "index": np.array(cols[0], np.int64),
        "name": np.array([rec.names[j] for j in cols[1]], dtype=object),
        "start": np.array(cols[2], np.int64),
        "end": np.array(cols[3], np.int64),
        "parent": np.array(cols[4], np.int64),
        "replay": np.array(cols[5], np.int64),
        "profiled": np.array(cols[6], bool)}
    out["span_totals"] = {name: {"count": c, "total_ns": t}
                          for name, (c, t) in zip(rec.names, rec.totals)}
    out["clock"] = clock
    out["launches"] = cuda_lib.launch_counts()
    return out


def recorder_lines(snap: dict, skip=()) -> List[str]:
    """``times.txt``'s lines of the recorder: per span name (but those in
    ``skip``) its host mean; per stage and clock its mean a run, the runs
    and the replays it ran in."""
    lines = []
    for name, t in sorted(snap["span_totals"].items()):
        if name not in skip and t["count"]:
            ms = 1e-6 * t["total_ns"] / t["count"]
            lines.append(f"span {name}: mean {ms:.3f} ms over {t['count']} "
                         f"calls (total {1e-9 * t['total_ns']:.3f} s), "
                         f"host clock")
    for on_device, clock in ((True, "device"), (False, "host")):
        rows = snap["valid"] & (snap["on_device"] == on_device)
        for k, name in enumerate(STAGES):
            count = snap["count"][rows, k]
            runs = int(count.sum())
            if runs:
                ms = 1e-6 * float(snap["total"][rows, k].sum()) / runs
                lines.append(f"stage {name}: mean {ms:.3f} ms over {runs} runs"
                             f" in {int((count > 0).sum())} of "
                             f"{int(rows.sum())} replays, {clock} clock")
    return lines


def write_fps(path: str, n_frames: int, total_seconds: float) -> None:
    """fps.res — a single number."""
    with open(path, "w") as f:
        f.write(f"{n_frames / max(total_seconds, 1e-9):.3f}\n")


def write_run_statistics(path: str, outs) -> None:
    """statistics.txt: inlier counts, map matches, keyframe / BA cadence and
    landmark growth of a SLAM run, one ``key value`` per line, with the JAX
    package's keys and formats. ``outs``: ``SlamOutputs`` with numpy (or
    tensor) fields stacked over the frames."""

    def arr(name):
        x = getattr(outs, name)
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    with open(path, "w") as f:
        f.write(f"frames {len(arr('pose'))}\n")
        f.write(f"vo_ok_fraction {float(arr('vo_ok').mean()):.4f}\n")
        f.write(f"map_ok_fraction {float(arr('map_ok').mean()):.4f}\n")
        f.write(f"keyframes {int(arr('is_keyframe').sum())}\n")
        f.write(f"ba_runs {int(arr('ba_ran').sum())}\n")
        f.write(f"map_inliers_median "
                f"{float(np.median(arr('n_map_inliers'))):.1f}\n")
        f.write(f"map_matches_median "
                f"{float(np.median(arr('n_map_matches'))):.1f}\n")
        f.write(f"landmarks_final {int(arr('n_landmarks')[-1])}\n")
