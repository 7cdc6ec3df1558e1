#!/usr/bin/env python
"""The host's share of the eager ``finalize``, on one CUDA card.

Usage (repository root, one card):
    python tools/eager_host_torch.py [--repo PATH] [--json-out FILE]

Runs the bench orbit (64 frames, fr1 widths) eagerly twice from one
``slam_init`` state, then times warm eager ``finalize`` calls of its final
state (``graph=False``: each Gauss-Newton stop read on the host), 8 each:
as they come, after ``gc.collect()`` + ``torch.cuda.empty_cache()``, and
with the collector off. Each call's wall ms (``torch.cuda.synchronize()``
before and after) and the process's CPU ms (``time.process_time``, whose
tick may be 10 ms). Beside them: the host µs of one tiny launch (20,000
``add_`` on a 16-float tensor) at start, after the run and at the end;
the device allocations made by the first 8 calls; and one call under
torch.profiler (CPU and CUDA): its host ops and the 25 with the most self
CPU time. ``--repo`` imports ``putslam_tpu_torch`` from another checkout
(a parent commit unpacked with ``git archive``); alternate the two in one
call, one process each. One JSON line.
"""

import argparse
import gc
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--json-out", help="append the JSON line there too")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import torch

    if not torch.cuda.is_available():
        sys.exit("eager_host_torch: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.models import slam

    dev = torch.device("cuda:0")

    def launch_us(n=20000):
        """(wall, CPU) µs a tiny launch."""
        x = torch.zeros(16, device=dev)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
        return (1e6 * (time.perf_counter() - t0) / n,
                1e6 * (time.process_time() - c0) / n)

    out = dict(repo=repo, launch_us_start=launch_us())
    cfg = tum_fr1_config()
    poses = synthetic.orbit_trajectory(64, radius=0.10, yaw_amp=0.1,
                                       device=dev)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    st0 = slam.slam_init(cfg, grays[0], depths[0], poses[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = [slam.frame_draws(cfg, gen, dev) for _ in range(63)]
    for _ in range(2):
        st, _ = slam.slam_sequence(cfg, st0, grays[1:], depths[1:],
                                   draws=draws, graph=False)
    torch.cuda.synchronize()
    out["launch_us_after_run"] = launch_us()

    def finalize_ms(k=8):
        """(wall ms, CPU ms) of k warm eager calls."""
        walls, cpus = [], []
        for _ in range(k):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            slam.finalize(cfg, st, graph=False)
            torch.cuda.synchronize()
            walls.append(round(1e3 * (time.perf_counter() - t0), 2))
            cpus.append(round(1e3 * (time.process_time() - c0), 2))
        return walls, cpus

    slam.finalize(cfg, st, graph=False)
    allocs0 = torch.cuda.memory_stats().get("num_device_alloc", -1)
    out["finalize_as_is"] = finalize_ms()
    out["device_allocs"] = (torch.cuda.memory_stats().get(
        "num_device_alloc", -1) - allocs0)
    out["gc_objects"] = len(gc.get_objects())
    gc.collect()
    torch.cuda.empty_cache()
    slam.finalize(cfg, st, graph=False)
    out["finalize_after_gc_empty_cache"] = finalize_ms()
    gc.disable()
    out["finalize_gc_off"] = finalize_ms()
    gc.enable()
    out["launch_us_end"] = launch_us()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        slam.finalize(cfg, st, graph=False)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    top = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:25]
    out["top_self_cpu_ms"] = [(e.key, e.count,
                               round(e.self_cpu_time_total / 1e3, 3))
                              for e in top]
    out["host_ops"] = sum(e.count for e in ka)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
