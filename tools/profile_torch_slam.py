#!/usr/bin/env python
"""Profile the PyTorch port's SLAM loop on a CUDA card.

Usage (repository root, one card):
    python tools/profile_torch_slam.py [--frames 33] [--out results]
                                       [--uncertainty]

Runs the bench workload (fr1 config, synthetic orbit radius 0.10 / yaw 0.1,
rendered on the card) through ``run_slam`` twice — as is, and with every
tracked frame a keyframe (``map.min_keyframe_matches`` above the feature
count, so the keyframe bookkeeping and the in-loop BA run) — under
``torch.profiler``. Prints, per workload, the wall time per frame, the
card's busy share (summed kernel time over wall time) and the kernels by
device time; writes the same as JSON to ``<out>/profile_torch_slam.json``.
With ``--uncertainty`` a third workload: the keyframe-dense run with the
uncertainty path on (``map.use_uncertainty`` with the normal-shaped sensor
model, ``backend.use_obs_info``, the Mahalanobis RANSAC at a gate of 16
squared sigmas).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from torch.profiler import ProfilerActivity, profile


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=33)
    ap.add_argument("--out", default="results")
    ap.add_argument("--uncertainty", action="store_true",
                    help="also profile the keyframe-dense uncertainty run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.models import slam

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg = tum_fr1_config()
    poses = synthetic.orbit_trajectory(64, radius=0.10, yaw_amp=0.1,
                                       device=dev)[:args.frames]
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    gt0 = poses[0].cpu().numpy()
    workloads = {
        "bench": cfg,
        "keyframe_dense": cfg.replace(map=dataclasses.replace(
            cfg.map, min_keyframe_matches=10_000)),
    }
    if args.uncertainty:
        dense = workloads["keyframe_dense"]
        workloads["keyframe_dense_uncertainty"] = dense.replace(
            map=dataclasses.replace(dense.map, use_uncertainty=True,
                                    uncertainty_model="normal"),
            backend=dataclasses.replace(dense.backend, use_obs_info=True),
            ransac=dataclasses.replace(dense.ransac, error_version=3,
                                       inlier_threshold_mahalanobis=16.0))
    report = {"device": smi, "frames": args.frames, "workloads": {}}
    for name, wcfg in workloads.items():
        slam.run_slam(wcfg, grays, depths, init_pose=gt0, device=dev)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, outs, _ = slam.run_slam(wcfg, grays, depths, init_pose=gt0,
                                       device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            r = by_name.setdefault(ev.name[:90], {"name": ev.name[:90],
                                                  "device_ms": 0.0, "count": 0})
            r["device_ms"] += ev.time_range.elapsed_us() / 1e3
            r["count"] += 1
        rows = list(by_name.values())
        busy_us = 1e3 * sum(r["device_ms"] for r in rows)
        rows.sort(key=lambda r: -r["device_ms"])
        steps = args.frames - 1
        w = {"wall_ms_per_frame": 1e3 * wall / args.frames,
             "device_busy_ms_per_frame": busy_us / 1e3 / args.frames,
             "device_busy_share": busy_us / 1e6 / wall,
             "keyframes": int(outs.is_keyframe.sum()),
             "ba_calls": int(outs.ba_ran.sum()),
             "top_kernels": rows[:25]}
        report["workloads"][name] = w
        print(f"== {name}: {w['wall_ms_per_frame']:.2f} ms/frame wall, "
              f"device busy {w['device_busy_ms_per_frame']:.2f} ms/frame "
              f"({100 * w['device_busy_share']:.1f} %), keyframes "
              f"{w['keyframes']} / {steps} steps, BA calls {w['ba_calls']} "
              f"[{smi}]")
        for r in rows[:15]:
            print(f"   {r['device_ms']:9.3f} ms  x{r['count']:<6d} {r['name']}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_slam.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
