#!/usr/bin/env python
"""Per-stage device time of the port's VO front end (the counterpart of
``tools/profile_vo.py``).

    python tools/profile_vo_torch.py [--frames 64] [--device cuda]
                                     [--runs 5] [--json-out FILE]

At the fr1 config, on a ``--frames``-frame synthetic orbit (radius 0.10 m,
yaw 0.1) rendered on the device, times the stages of ``tools/profile_vo.py``
over the whole sequence:

- ``vo_sequence`` end to end (detection, matching and RANSAC of every pair,
  the pose chain; on a CUDA device each step replayed from a CUDA graph,
  ``models/compiled.py``);
- ``detect_sequence``: detect + describe of every frame, all levels (one
  launch of the FAST kernel a frame);
- ``fast.detect`` at level 0 of every frame;
- extract + describe at level 0 (``brief.extract_patches`` →
  ``brief.describe_patches``) of every frame's keypoints;
- ``vo_step`` (match + RANSAC) over the T − 1 consecutive pairs.

Each stage prints ms a call and ms a frame. On a CUDA device a call is
timed between two CUDA events with a spin kernel queued first, so the
host's enqueueing before the call does not show as idle time (the median of
``--runs`` calls after a warm-up); on the CPU by the host clock.
``--json-out`` writes the stages, the device and its power limit as JSON.
``main(argv, cfg=)`` takes another config (a CPU test runs the tiny one).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPIN_CYCLES = 20_000_000   # ~10 ms of an H100's clock


def median_ms(fn, dev, runs):
    """Median ms of one call of ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return times[len(times) // 2]


def main(argv=None, cfg=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.models import vo
    from putslam_tpu_torch.ops import brief as brief_mod
    from putslam_tpu_torch.ops import fast as fast_mod
    from putslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = tum_fr1_config() if cfg is None else cfg
    det = cfg.detector
    T = args.frames
    poses = synthetic.orbit_trajectory(T, radius=0.10, yaw_amp=0.1,
                                       device=dev)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    print(f"device: {dev} | {smi or 'no nvidia-smi'} | frames {T}",
          flush=True)

    def generator():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return gen

    feats = vo.detect_sequence(cfg, grays, depths)
    stages = {}

    def timeit(name, fn, per=T):
        ms = median_ms(fn, dev, args.runs)
        stages[name] = {"ms_per_call": ms, "ms_per_frame": ms / per,
                        "frames": per}
        print(f"{name:36s} {ms:9.2f} ms/call {ms / per:8.3f} ms/frame",
              flush=True)

    timeit("vo_sequence (end-to-end)",
           lambda: vo.vo_sequence(cfg, grays, depths, generator=generator()))
    timeit("detect_sequence (all levels)",
           lambda: vo.detect_sequence(cfg, grays, depths))
    timeit("fast.detect (level 0)",
           lambda: [fast_mod.detect(g, det.fast_threshold, det.nms_radius,
                                    det.grid_rows, det.grid_cols,
                                    det.max_features,
                                    grid_policy=det.grid_policy)
                    for g in grays])
    timeit("extract+describe (level 0)",
           lambda: [brief_mod.describe_patches(
               brief_mod.extract_patches(g, f.uv), det.descriptor)
               for g, f in zip(grays, feats)])
    timeit("vo_step (match+ransac)",
           lambda: [vo.vo_step(cfg, a, b, generator=gen)
                    for gen in [generator()]
                    for a, b in zip(feats[:-1], feats[1:])],
           per=T - 1)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump({"device": str(dev), "nvidia_smi": smi, "frames": T,
                       "runs": args.runs, "stages": stages}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
