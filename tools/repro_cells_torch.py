#!/usr/bin/env python
"""Speed and run-to-run spread of the SLAM cells whose bundle adjustment
runs, on the graph path (or eagerly), on one CUDA card.

Usage (repository root, one card):
    python tools/repro_cells_torch.py [--repo PATH] [--runs 3] [--eager]
                                      [--json-out FILE]

The cells are ``chip_smoke.py`` phase 7b's, at the fr1 widths: ``bench``
(the 64-frame orbit, no keyframe), ``keyframe_dense`` (every tracked frame
a keyframe, the in-loop BA every 5 keyframes) and ``revisit_lc`` (the
64-frame leave-and-return with loop closure, keyframe-dense). Each cell
runs ``slam_sequence`` from one ``slam_init`` state with the same
per-frame draws, replayed from CUDA graphs: once to capture, then
``--runs`` times timed (frames/s of each run, wall clock between
synchronisations), then ``finalize`` of the final state from its graph:
once to capture, then ``--runs`` warm calls (ms each). The spread is the
largest pose difference of a timed run (or a warm ``finalize``) from the
first: 0.0 where the runs repeat themselves bit for bit. Frames 1 to
``PROFILED`` replayed once more under torch.profiler (CUPTI) give the
kernels a frame (copies and fills not counted) and the device ms a
frame, as ``chip_smoke.py`` phase 7b counts them. ``--eager`` runs the
same cells and ``finalize`` with ``graph=False`` (phase 7b's and 18's
eager path): the first run and call are a warm-up, not a capture.

``--repo`` imports ``putslam_tpu_torch`` from another checkout (a parent
commit, unpacked with ``git archive``), so that two versions are compared
on one card in one call, in turns. One JSON line a cell, then the card's
``nvidia-smi`` name and power limit.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

FRAMES = 64
PROFILED = 4    # frames replayed under the profiler (as smoke 7b's)


def device_kernels(torch, fn):
    """(kernels, their summed device ms) of one call of ``fn`` as
    torch.profiler records them, CUDA-graph replays included; copies and
    fills count in the time, not as kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    n = sum(not e.name.startswith(("Memcpy", "Memset")) for e in evs)
    return n, sum(e.time_range.elapsed_us() for e in evs) / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--eager", action="store_true",
                    help="run eagerly instead of from CUDA graphs")
    ap.add_argument("--json-out", help="append the JSON lines there too")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    if not torch.cuda.is_available():
        sys.exit("repro_cells_torch: needs a CUDA card")
    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.models import slam

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg = tum_fr1_config()
    dense = dataclasses.replace(cfg.map, min_keyframe_matches=10_000)
    kf_cfg = cfg.replace(map=dense)
    lc_cfg = cfg.replace(
        map=dataclasses.replace(dense, max_keyframes=64,
                                add_features_when_measurements_less_than=10),
        loop_closure=dataclasses.replace(cfg.loop_closure, enabled=True,
                                         tail_skip=10))
    orbit = synthetic.orbit_trajectory(FRAMES, radius=0.10, yaw_amp=0.1,
                                       device=dev)
    revisit = synthetic.revisit_trajectory(FRAMES, sweep=1.2, device=dev)
    cells = {"bench": (cfg, orbit), "keyframe_dense": (kf_cfg, orbit),
             "revisit_lc": (lc_cfg, revisit)}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    graph = not args.eager
    lines = []
    for tag, (c, poses) in cells.items():
        grays, depths = synthetic.render_sequence(c.camera, poses)
        truth = poses.cpu().numpy()
        n = FRAMES - 1
        state0 = slam.slam_init(c, grays[0], depths[0], poses[0])
        gen = torch.Generator(device=dev).manual_seed(0)
        draws = [slam.frame_draws(c, gen, dev) for _ in range(n)]

        def run(k=n):
            return slam.slam_sequence(c, state0, grays[1:k + 1],
                                      depths[1:k + 1], draws=draws[:k],
                                      graph=graph)

        (_, _), capture_s = wall(run)
        fps, spread = [], 0.0
        for i in range(args.runs):
            (st, outs), dt = wall(run)
            fps.append(n / dt)
            if i == 0:
                first_st, first = st, outs.pose.clone()
            spread = max(spread, float((outs.pose - first).abs().max()))
        kernels, dev_ms = device_kernels(torch, lambda: run(PROFILED))
        kv = first_st.map.kf_valid
        fin0, fin_capture_s = wall(lambda: slam.finalize(c, first_st,
                                                         graph=graph))
        fin_pose = fin0.map.kf_pose[kv].clone()
        fin_ms, fin_spread = [], 0.0
        for _ in range(args.runs):
            fin, dt = wall(lambda: slam.finalize(c, first_st, graph=graph))
            fin_ms.append(1e3 * dt)
            fin_spread = max(fin_spread, float(
                (fin.map.kf_pose[kv] - fin_pose).abs().max()))
        est = torch.cat([poses[:1], first]).cpu().numpy()
        line = dict(
            cell=tag, path="eager" if args.eager else "graph",
            repo=os.path.abspath(args.repo), frames_per_s=fps,
            capture_run_s=capture_s, pose_spread_m=spread,
            kernels_per_frame=kernels / PROFILED,
            device_ms_per_frame=dev_ms / PROFILED,
            keyframes=int(outs.is_keyframe.sum()),
            ba_calls=int(outs.ba_ran.sum()),
            ate_m=ate_mod.ate_rmse_aligned_frames(truth, est),
            finalize_first_ms=1e3 * fin_capture_s, finalize_warm_ms=fin_ms,
            finalize_pose_spread_m=fin_spread, device=smi)
        lines.append(line)
        print(json.dumps(line), flush=True)
        del st, outs, first_st, fin0, fin
        from putslam_tpu_torch.models import compiled
        compiled.clear_cache()
    if args.json_out:
        with open(args.json_out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    print(smi)


if __name__ == "__main__":
    main()
