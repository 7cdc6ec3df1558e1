"""The benchmark of putslam_tpu_torch: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``) is a configuration (``configs/<name>.json``:
camera, rate, sequence length and the port's settings) under a traffic
mix (``traffic/<name>.json``: the camera walk and how frames arrive). Set-up
renders a pool of sequences from the seed in the raycast room
(``gen/``), quantised to the sensor's wire formats (gray uint8, depth
uint16) in pinned host memory, and warms up every shape the window uses:
the frame's and ``finalize``'s CUDA graphs are captured there. The window
then drives the port's public calls:

- ``offline``: ``slam.run_slam_final`` on whole sequences back to back,
  the pool cycled, each with its own RANSAC seed; the window ends at the
  first end of a cycle of the pool after ``--seconds``, so that every walk
  of the pool runs as often as the others. ``frames_per_s`` counts every
  frame of every sequence over the window's wall time.
- ``live``: the camera's clock. ``slam.slam_init`` takes frame 0, then
  ``slam.slam_sequence`` one frame a call, each handed over (copied to the
  card and cast, as ``run_slam`` does) at its due time and its pose read
  back; ``frame_ms_p95`` is the 95th percentile of due time to pose. At a
  sequence's end ``slam.finalize`` and the re-anchor run and the next
  sequence's clock starts when they return. Frames due after ``--seconds``
  are not sent.

``--trace 1`` runs the same window with the harness's spans around the
port's calls, and ``torch.profiler`` over part of it (live: the window's
last ``trace_frames`` frames; offline: the window's last sequence run
once more after the window with the same seed, the same work bit for
bit), and reports the per-layer metrics (``metrics/<name>.py``) instead
of the end-to-end ones.

After the window, the device memory peak is read and the program's state
freed; then ``check.py`` compares what the window produced with the plain
reference and prints each number beside its limit. The last line of
standard output is the result as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "putslam_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own libraries build into ``putslam_tpu_torch/build/``)."""
    cache = root / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


class Setup:
    """The cell's inputs, made from the seed: the pool of sequences (gray
    uint8, depth uint16, pinned) and their ground truth, the RANSAC seeds.
    The pool's walks are the traffic's walks 0 … pool − 1 for every seed;
    the seed orders them and draws the room's texture."""

    def __init__(self, cell, seed: int, device, pin: bool):
        import numpy as np
        import torch

        from slambench.gen import render, walks
        from slambench import spec

        conf, traffic = cell.config, cell.traffic
        self.cfg = spec.slam_config(conf.get("slam", {}))
        self.cam = self.cfg.camera
        self.n_frames = int(round(conf["duration_s"] * conf["fps"]))
        words = np.random.SeedSequence(seed).generate_state(3)
        self.texture_seed = int(words[0])
        self.ransac_root = int(words[1])
        # every seed runs the same walks (the work), in its own order, in a
        # room of its own texture, with its own RANSAC draws
        order = np.random.default_rng(int(words[2])).permutation(
            traffic["pool"])
        self.pool = []
        for i in order:
            gt = walks.walk(self.n_frames, int(i), device=device,
                            **traffic["walk"])
            g, d = render.render_wire(self.cam, gt, self.cam.depth_image_scale,
                                      self.texture_seed, pin)
            self.pool.append((g, d, gt.cpu().numpy()))

    def ransac_seed(self, k: int) -> int:
        import numpy as np

        return int(np.random.SeedSequence([self.ransac_root, k])
                   .generate_state(1)[0])


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def handoff(cfg, gray_u8, depth_u16, dev):
    """Decoded frames (T, H, W) to the card as float32, the way
    ``run_slam`` takes them: uint8 / 255; uint16 counts cross as their
    int16 bits and are widened with a mask, then / depth_image_scale."""
    import torch

    g = gray_u8.to(dev, non_blocking=True).to(torch.float32) / 255.0
    d = depth_u16.view(torch.int16).to(dev, non_blocking=True)
    d = (d.to(torch.int32) & 0xFFFF).to(torch.float32) \
        / cfg.camera.depth_image_scale
    return g, d


def _host_state(state, traj, outs, gt, gray, depth):
    """The check's record of a finished sequence (host copies)."""
    import dataclasses

    from slambench.check import Sequence
    from slambench.reference import optimality

    f = state.prev_feat
    return Sequence(
        gt=gt, gray=gray, depth=depth, traj=traj,
        outs={k: v.cpu().numpy() if hasattr(v, "cpu") else v
              for k, v in outs._asdict().items()},
        feat={k: getattr(f, k).cpu().numpy() for k in
              ("uv", "octave", "valid", "desc", "xyz", "has_depth")},
        kf_pose=state.map.kf_pose.cpu().numpy(),
        kf_seq=state.map.kf_seq.cpu().numpy(),
        graph=optimality.Graph(**{
            f.name: getattr(state.map if f.name[:3] in ("kf_", "lm_")
                            else state.graph, f.name).cpu()
            for f in dataclasses.fields(optimality.Graph)}))


class Window:
    """The timed part of a run and what it leaves for the check."""

    def __init__(self, setup: Setup, traffic: dict, dev, trace: bool):
        self.s, self.traffic, self.dev, self.trace = setup, traffic, dev, trace
        self.frames = 0
        self.done = []          # (state, traj, outs, pool index) finished
        self.latencies = []
        self.traced_frames = 0
        self.lost = 0
        self.seq_s = []         # offline: wall seconds of each sequence
        self.open = None        # live: the sequence the window cut

    def _span(self, name):
        import contextlib

        from torch.profiler import record_function

        return record_function(f"slambench.{name}") if self.trace \
            else contextlib.nullcontext()

    # ---- offline ---------------------------------------------------------
    def offline(self, seconds: float, prof=None):
        from putslam_tpu_torch.models import slam

        real_finalize = slam.finalize

        def finalize_spanned(cfg, state, graph=None):
            _sync(self.dev)
            self._end_start = time.perf_counter()
            return real_finalize(cfg, state, graph=graph)

        pool = self.s.pool
        chunk = int(self.traffic["chunk_size"])

        def sequence(k):
            g, d, gt = pool[k % len(pool)]
            return slam.run_slam_final(self.s.cfg, g, d, init_pose=gt[0],
                                       seed=self.s.ransac_seed(k),
                                       chunk_size=chunk, device=self.dev)

        t0 = time.perf_counter()
        k = 0
        self.end_of_run_s = []
        if self.trace:
            slam.finalize = finalize_spanned
        try:
            while True:
                t_seq = time.perf_counter()
                with self._span("sequence"):
                    _, traj, outs, state = sequence(k)
                t_end = time.perf_counter()
                self.seq_s.append(t_end - t_seq)
                if self.trace:
                    self.end_of_run_s.append(t_end - self._end_start)
                self.frames += len(traj)
                self.lost += int((~outs.vo_ok & ~outs.map_ok).sum())
                self.done.append((state, traj, outs, k % len(pool)))
                k += 1
                if k % len(pool) == 0 and time.perf_counter() - t0 >= seconds:
                    break
        finally:
            slam.finalize = real_finalize
        self.elapsed = time.perf_counter() - t0
        if self.trace:
            # the window's last sequence once more under the profiler, with
            # its RANSAC seed: the same work bit for bit (a traced replay is
            # slower, so its wall time is read from the untraced run); the
            # last, because the host's slow spells mostly hold the first
            prof.start()
            try:
                with self._span("window"):
                    traj = sequence(k - 1)[1]
                _sync(self.dev)
            finally:
                prof.stop()
            self.traced_frames = len(traj)

    # ---- live ------------------------------------------------------------
    def live(self, seconds: float, prof=None):
        import torch

        from putslam_tpu_torch.models import slam

        s, cfg, dev = self.s, self.s.cfg, self.dev
        period = 1.0 / float(self.traffic["rate_hz"])
        # a traced run traces the window's last frames: stopping the
        # profiler takes seconds, which would make every later frame late
        trace_from = seconds - int(self.traffic.get("trace_frames", 0)) * period
        gen = torch.Generator(device=dev)
        t_win = time.perf_counter()
        k = 0
        span = None
        while True:
            g, d, gt = s.pool[k % len(s.pool)]
            gen.manual_seed(s.ransac_seed(k))
            outs = []
            t_seq = time.perf_counter()
            state = None
            for j in range(len(gt)):
                due = t_seq + j * period
                if due - t_win >= seconds:
                    break
                if self.trace and span is None and due - t_win >= trace_from:
                    prof.start()
                    span = self._span("window")
                    span.__enter__()
                while True:
                    left = due - time.perf_counter()
                    if left <= 0:
                        break
                    time.sleep(left - 1e-3 if left > 2e-3 else 0)
                with self._span("frame"):
                    if j == 0:
                        gray, depth = handoff(cfg, g[0], d[0], dev)
                        state = slam.slam_init(cfg, gray, depth, gt[0])
                        _sync(dev)
                    else:
                        gray, depth = handoff(cfg, g[j:j + 1], d[j:j + 1], dev)
                        state, o = slam.slam_sequence(cfg, state, gray, depth,
                                                      generator=gen)
                        o.pose.cpu()
                        outs.append(o)
                lat = time.perf_counter() - due
                if span is None:
                    self.latencies.append(lat)
                else:
                    self.traced_frames += 1
                self.frames += 1
            else:
                self._finish(state, outs, k)
                k += 1
                continue
            self.open = (state, outs, k)
            break
        if span is not None:
            _sync(dev)
            span.__exit__(None, None, None)
            prof.stop()
        self.elapsed = time.perf_counter() - t_win

    def _finish(self, state, outs, k):
        """A live sequence's end: finalize and the re-anchored trajectory."""
        import torch

        from putslam_tpu_torch.models import slam

        stacked = slam.SlamOutputs(*(torch.cat(x) for x in zip(*outs)))
        state = slam.finalize(self.s.cfg, state)
        gt = self.s.pool[k % len(self.s.pool)][2]
        traj = torch.cat([torch.as_tensor(gt[:1], device=self.dev),
                          slam.reanchor_trajectory(state, stacked)])
        traj = traj.cpu().numpy()
        out_np = slam.SlamOutputs(*(x.cpu().numpy() for x in stacked))
        self.lost += int((~out_np.vo_ok & ~out_np.map_ok).sum())
        self.done.append((state, traj, out_np, k % len(self.s.pool)))

    def close(self):
        """Finish a live sequence the window cut (outside the window)."""
        if self.open and self.open[1]:
            state, outs, k = self.open
            self._finish(state, outs, k)
        self.open = None


def records(window: Window):
    """The check's host records of the finished sequences, the program's
    state dropped as each is read."""
    out = []
    while window.done:
        state, traj, outs, i = window.done.pop(0)
        g, d, gt = window.s.pool[i]
        n = len(traj)
        out.append(_host_state(state, traj, outs, gt[:n], g[n - 1], d[n - 1]))
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             here: Path = HERE) -> dict:
    """One run of ``cell`` (a ``spec.Cell``): set-up, window, check. Returns
    the result line as a dict; the numbers compared go to stderr."""
    import dataclasses

    import numpy as np
    import torch

    from slambench import check, spec

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_cell = process_age_s()
    s = Setup(cell, seed, dev, pin=on_card)
    if on_card:
        # the peak is the program's: the renderer's buffers are not
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t_inputs = process_age_s()
    mode = cell.traffic["mode"]
    # the warm-up captures the frame's and finalize's CUDA graphs
    if mode == "offline":
        from putslam_tpu_torch.models import slam

        g, d, gt = s.pool[0]
        chunk = int(cell.traffic["chunk_size"])
        slam.run_slam_final(s.cfg, g[:1 + chunk], d[:1 + chunk],
                            init_pose=gt[0], seed=0, chunk_size=chunk,
                            device=dev)
    else:
        warm = Window(s, cell.traffic, dev, trace=False)
        warm.live(4.0 / float(cell.traffic["rate_hz"]))
        warm.close()
    _sync(dev)
    setup_s = process_age_s()
    print(f"setup: {t_cell:.2f} s to the cell (imports), {t_inputs - t_cell:.2f}"
          f" s the inputs, {setup_s - t_inputs:.2f} s the warm-up",
          file=sys.stderr)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                          if on_card else [])
        prof = profile(activities=acts)
    win = Window(s, cell.traffic, dev, trace)
    getattr(win, mode)(float(seconds), prof)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    win.close()
    seqs = records(win)
    if on_card:
        torch.cuda.empty_cache()

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s}
        if mode == "offline":
            values["frames_per_s"] = win.frames / win.elapsed
        else:
            values["frame_ms_p95"] = 1e3 * float(np.percentile(
                win.latencies, 95))
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    tr = None
    if trace:
        from slambench import trace as trace_mod

        tr = trace_mod.read(prof)
        ctx = dict(trace=tr, window=win, cell=cell, cfg=s.cfg,
                   power_limit=card_power_limit() if on_card else None)
        for m in cell.per_layer:
            v = spec.load_module("metrics", m["name"], here).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    from slambench.reference import optimality

    backend = dataclasses.asdict(s.cfg.backend)
    for k, q in enumerate(seqs):
        o = q.outs
        repairs = optimality.undo_repair(q.graph, backend, dev)[1]
        print(f"sequence {k}: {len(q.traj)} frames, "
              f"{1 + int(o['is_keyframe'].sum())} keyframes, "
              f"{int(o['ba_ran'].sum())} BA calls, "
              f"{int((~o['vo_ok'] & ~o['map_ok']).sum())} lost, "
              + (f"{win.seq_s[k]:.3f} s, " if k < len(win.seq_s) else "")
              + f"{repairs} trajectory repairs undone, "
              + f"ATE {check.ate_rmse_mm([q]):.3f} mm", file=sys.stderr)
    _, kf, pooled = check.ba_steps_mm(seqs, backend, dev)
    print(f"info ate_rmse_mm: {check.ate_rmse_mm(seqs)!r}; "
          + "; ".join(f"{n} {v!r}" for n, v in check.rpe_info(seqs).items())
          + f"; ba_pose_step_mm {kf!r}; ba_pose_step_pooled_mm {pooled!r}",
          file=sys.stderr)
    det = dataclasses.asdict(s.cfg.detector)
    cam = dataclasses.asdict(s.cfg.camera)
    checks = check.numbers(seqs, det, cam, backend, dev,
                           cell.config.get("limits"))
    correct = all(ok for _, _, ok in checks.values())
    for name, (v, lim, ok) in checks.items():
        print(f"check {name}: {v!r} limit {lim!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(win.frames),
            "failed": int(win.lost), "metrics": metrics,
            "device": device_info}
    if trace:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        device_info["power_limit"] = ctx["power_limit"]
        line["breakdown"] = {"device_ops": tr.device_ops,
                             "idle_gaps": tr.idle_gaps}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, (v, lim, _) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    from slambench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"slambench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {bad}, which the port must not "
              f"import", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
