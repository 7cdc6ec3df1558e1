"""Command-line SLAM runner of the PyTorch port.

Usage:
    python -m putslam_tpu_torch.run --synthetic 64 --out results/
    python -m putslam_tpu_torch.run --synthetic 30 --loop-closure
    python -m putslam_tpu_torch.run --synthetic 30 --only-vo --vo-version 1

Same CLI names and output files as ``putslam_tpu/run.py``
(``VO_trajectory.res``, ``graph_trajectory.res``, ``fps.res``,
``times.txt`` and, for a SLAM run, ``statistics.txt``) for
``--synthetic N``, ``--only-vo``, ``--vo-version`` (0 = matching, 1 = KLT
tracking), ``--loop-closure``, ``--out``, ``--seed``, ``--chunk`` and
``--max-frames``, plus ``--device`` (default ``cuda``; asking for CUDA where
there is none is an error). Prints one JSON report line with the frame
count, fps and, against the synthetic ground truth, ATE and RPE.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

_NOT_PORTED = ("dataset", "global_ba", "reference_resources",
               "reference_eval", "plots")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="render N synthetic frames")
    ap.add_argument("--out", default="results", help="output directory")
    ap.add_argument("--only-vo", action="store_true", help="VO only")
    ap.add_argument("--vo-version", type=int, default=0,
                    help="0=matching, 1=KLT tracking (VOVersion)")
    ap.add_argument("--loop-closure", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=64,
                    help="move the sequence to the device in blocks of this "
                         "many frames (0 = all at once)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    # flags of putslam_tpu.run that this port does not support yet
    ap.add_argument("--dataset")
    ap.add_argument("--global-ba", action="store_true")
    ap.add_argument("--reference-resources")
    ap.add_argument("--reference-eval", action="store_true")
    ap.add_argument("--plots", action="store_true")
    args = ap.parse_args(argv)

    unported = [f"--{name.replace('_', '-')}" for name in _NOT_PORTED
                if getattr(args, name)]
    if args.vo_version not in (0, 1):
        unported.append(f"--vo-version {args.vo_version}")
    if unported:
        ap.error(f"not yet ported to putslam_tpu_torch: {', '.join(unported)}")
    if not args.synthetic:
        ap.error("need --synthetic N")

    import torch

    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.eval import ate as ate_mod, rpe as rpe_mod
    from putslam_tpu_torch.io import synthetic, tum
    from putslam_tpu_torch.models import slam, vo
    from putslam_tpu_torch.utils import timing
    from putslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = tum_fr1_config(only_vo=args.only_vo, vo_version=args.vo_version)
    if args.loop_closure:
        cfg = cfg.replace(loop_closure=dataclasses.replace(
            cfg.loop_closure, enabled=True))
    os.makedirs(args.out, exist_ok=True)
    timer = timing.StageTimer()

    n = args.synthetic if not args.max_frames else min(args.synthetic,
                                                       args.max_frames)
    with timer.stage("dataset"):
        poses = synthetic.orbit_trajectory(n, radius=0.12, yaw_amp=0.12,
                                           device=dev)
        grays, depths = synthetic.render_sequence(cfg.camera, poses)
        gt_poses = poses.cpu().numpy()
    timestamps = np.arange(n) / 30.0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    outs = None
    if args.only_vo:
        with timer.stage("vo_total"):
            est, _ = vo.run_vo(cfg, grays, depths, seed=args.seed,
                               init_pose=gt_poses[0], device=dev)
            sync()
    else:
        with timer.stage("slam_total"):
            est_vo_anchored, est, outs, _ = slam.run_slam_final(
                cfg, grays, depths, init_pose=gt_poses[0], seed=args.seed,
                chunk_size=args.chunk, device=dev)
            sync()
    total = time.perf_counter() - t0

    traj_name = "VO_trajectory.res" if args.only_vo else "graph_trajectory.res"
    tum.save_trajectory(os.path.join(args.out, traj_name), timestamps, est)
    if not args.only_vo:
        tum.save_trajectory(os.path.join(args.out, "VO_trajectory.res"),
                            timestamps, est_vo_anchored)
    timing.write_fps(os.path.join(args.out, "fps.res"), n, total)
    timer.write_times_txt(os.path.join(args.out, "times.txt"))
    if outs is not None:
        timing.write_run_statistics(os.path.join(args.out, "statistics.txt"),
                                    outs)

    report = {"frames": n, "fps": round(n / total, 2), "device": str(dev),
              "ate_rmse_m": round(ate_mod.ate_rmse_aligned_frames(gt_poses,
                                                                  est), 5)}
    if not args.only_vo:
        report["ate_before_final_m"] = round(
            ate_mod.ate_rmse_aligned_frames(gt_poses, est_vo_anchored), 5)
    tr, rot = rpe_mod.rpe(gt_poses, est)
    report["rpe_trans_m"] = round(tr, 5)
    report["rpe_rot_rad"] = round(rot, 5)
    print(json.dumps(report))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
