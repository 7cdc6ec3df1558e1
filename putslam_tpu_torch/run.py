"""Command-line SLAM runner of the PyTorch port.

Usage:
    python -m putslam_tpu_torch.run --dataset /path/to/tum_sequence --out results/
    python -m putslam_tpu_torch.run --dataset /path/to/tum_sequence --global-ba
    python -m putslam_tpu_torch.run --synthetic 64 --out results/
    python -m putslam_tpu_torch.run --synthetic 30 --loop-closure
    python -m putslam_tpu_torch.run --synthetic 30 --only-vo --vo-version 1
    python -m putslam_tpu_torch.run --synthetic 30 --device cpu --plots

Same CLI names and output files as ``putslam_tpu/run.py``
(``VO_trajectory.res``, ``graph_trajectory.res``, ``fps.res``,
``times.txt`` and, for a SLAM run, ``statistics.txt``) for ``--dataset DIR``
(a TUM-layout directory, read through ``io/tum.py``; its ``camera.json``,
where there is one, overrides the camera), ``--synthetic N``, ``--only-vo``,
``--vo-version`` (1 = KLT tracking, any other value matching), ``--loop-closure``,
``--global-ba`` (host map archive and the offline global bundle adjustment),
``--reference-resources RES`` / ``--dataset-name NAME`` (the operating point
from the reference's XML files), ``--plots`` (trajectory.png, map.png and
stats.png through ``utils/viz.py``; needs matplotlib), ``--reference-eval``
(scores the written trajectories with the reference's own
``evaluate_ate.py`` / ``evaluate_rpe.py`` through
``tools/run_reference_eval.py``, as ``putslam_tpu/run.py:200-231`` does;
needs those scripts, and a ``--dataset`` with a ``groundtruth.txt``),
``--out``, ``--seed``, ``--chunk`` and ``--max-frames``, plus ``--device``
(default ``cuda``; asking for CUDA where there is none is an error). Prints
one JSON report line with the frame count, fps, for a dataset the decoder
that read it (``"loader"``: ``"native"`` or ``"python"``) and, where there
is ground truth, ATE and RPE.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", help="TUM-format sequence directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="render N synthetic frames instead of a dataset")
    ap.add_argument("--out", default="results", help="output directory")
    ap.add_argument("--only-vo", action="store_true", help="VO only")
    ap.add_argument("--vo-version", type=int, default=0,
                    help="1=KLT tracking, any other value matching "
                         "(VOVersion)")
    ap.add_argument("--loop-closure", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=64,
                    help="move the sequence to the device in blocks of this "
                         "many frames (0 = all at once)")
    ap.add_argument("--global-ba", action="store_true",
                    help="archive the full graph across ring evictions and "
                         "polish it with the offline global bundle "
                         "adjustment (overlapping windowed sweeps) instead "
                         "of the ring-bounded final optimization")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference-resources", default=None,
                    help="load the operating point from a reference-style "
                         "resources/ directory of XML configs "
                         "(putslamconfigGlobal.xml chain)")
    ap.add_argument("--dataset-name", default=None,
                    help="datasetConfig/<name>.xml to use with "
                         "--reference-resources")
    ap.add_argument("--reference-eval", action="store_true",
                    help="additionally score the trajectories with the "
                         "REFERENCE's own evaluate_ate/evaluate_rpe scripts "
                         "(writes VOAte.res/g2oAte.res/VORpe.res/g2oRpe.res "
                         "like scripts/runPUTSLAM.py)")
    ap.add_argument("--plots", action="store_true",
                    help="write trajectory/map/stats PNGs (offline "
                         "visualizer; needs matplotlib)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    if not args.synthetic and not args.dataset:
        ap.error("need --dataset or --synthetic N")

    import torch

    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.eval import ate as ate_mod, rpe as rpe_mod
    from putslam_tpu_torch.io import synthetic, tum
    from putslam_tpu_torch.models import slam, vo
    from putslam_tpu_torch.utils import timing
    from putslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.reference_resources:
        from putslam_tpu_torch.io import xml_config

        cfg = xml_config.load_reference_config(args.reference_resources,
                                               args.dataset_name)
        cfg = cfg.replace(only_vo=args.only_vo, vo_version=args.vo_version)
    else:
        cfg = tum_fr1_config(only_vo=args.only_vo, vo_version=args.vo_version)
    if args.loop_closure:
        cfg = cfg.replace(loop_closure=dataclasses.replace(
            cfg.loop_closure, enabled=True))
    os.makedirs(args.out, exist_ok=True)
    timer = timing.StageTimer()

    gt_poses = gt_track = None
    loader = None
    if args.synthetic:
        n = args.synthetic if not args.max_frames else min(args.synthetic,
                                                           args.max_frames)
        with timer.stage("dataset"):
            poses = synthetic.orbit_trajectory(n, radius=0.12, yaw_amp=0.12,
                                               device=dev)
            grays, depths = synthetic.render_sequence(cfg.camera, poses)
            gt_poses = poses.cpu().numpy()
        timestamps = np.arange(n) / 30.0
        init_pose = gt_poses[0]
    else:
        # a dataset's own camera.json (written by
        # tools/make_disk_dataset_torch.py) overrides the config camera: the
        # engine must not undistort pixels of a sequence rendered without
        # distortion
        cam_json = os.path.join(args.dataset, "camera.json")
        if os.path.exists(cam_json):
            with open(cam_json) as f:
                cfg = cfg.replace(camera=dataclasses.replace(
                    cfg.camera, **json.load(f)))
        with timer.stage("dataset"):
            ds = tum.TumDataset(args.dataset,
                                depth_scale=cfg.camera.depth_image_scale)
            n = len(ds) if not args.max_frames else min(len(ds),
                                                        args.max_frames)
            # the wire format (uint8 gray / uint16 depth, the PNG payloads)
            # is kept on the host; the cast to float happens on the device,
            # chunk by chunk
            grays = np.empty((n, cfg.camera.height, cfg.camera.width),
                             np.uint8)
            depths = np.empty_like(grays, dtype=np.uint16)
            timestamps = np.empty((n,), np.float64)
            scale = cfg.camera.depth_image_scale
            for i, f in enumerate(ds):
                if i >= n:
                    break
                grays[i] = np.clip(f.gray * 255.0 + 0.5, 0, 255)
                depths[i] = np.clip(f.depth * scale + 0.5, 0, 65535)
                timestamps[i] = f.timestamp
            loader = ds.loader
            if ds.groundtruth is not None:
                gt_track = ds.groundtruth
                gt_ts, gt_all = gt_track
                # per-frame ground truth where the timestamps line up
                # exactly (sequences written by write_tum_dataset): the
                # frame-aligned report
                if (len(gt_ts) >= n and
                        np.allclose(gt_ts[:n], timestamps, atol=1e-6)):
                    gt_poses = gt_all[:n]
        init_pose = gt_poses[0] if gt_poses is not None else \
            ds.starting_pose()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    outs = state = None
    if args.only_vo:
        if not torch.is_tensor(grays) and grays.dtype == np.uint8:
            grays = grays.astype(np.float32) / 255.0
            depths = depths.astype(np.float32) / cfg.camera.depth_image_scale
        with timer.stage("vo_total"):
            est, _ = vo.run_vo(cfg, grays, depths, seed=args.seed,
                               init_pose=init_pose, device=dev)
            sync()
    elif args.global_ba:
        with timer.stage("slam_total"):
            est_vo_anchored, est, outs, state, _ = slam.run_slam_global(
                cfg, grays, depths, init_pose=init_pose, seed=args.seed,
                chunk_size=args.chunk or 64, device=dev)
            sync()
    else:
        with timer.stage("slam_total"):
            est_vo_anchored, est, outs, state = slam.run_slam_final(
                cfg, grays, depths, init_pose=init_pose, seed=args.seed,
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

    if args.plots:
        from putslam_tpu_torch.utils import viz

        viz.plot_trajectory(os.path.join(args.out, "trajectory.png"), est,
                            gt_poses)
        if outs is not None:
            viz.plot_map(os.path.join(args.out, "map.png"), state.map, est)
            viz.plot_run_stats(os.path.join(args.out, "stats.png"), outs)

    report = {"frames": n, "fps": round(n / total, 2), "device": str(dev)}
    if loader is not None:
        report["loader"] = loader
    if gt_poses is not None:
        report["ate_rmse_m"] = round(
            ate_mod.ate_rmse_aligned_frames(gt_poses, est), 5)
        if not args.only_vo:
            report["ate_before_final_m"] = round(
                ate_mod.ate_rmse_aligned_frames(gt_poses, est_vo_anchored), 5)
        tr, rot = rpe_mod.rpe(gt_poses, est)
        report["rpe_trans_m"] = round(tr, 5)
        report["rpe_rot_rad"] = round(rot, 5)
    elif gt_track is not None:
        report["ate_rmse_m"] = round(
            ate_mod.ate_rmse(gt_track[0], gt_track[1], timestamps, est), 5)
    if args.reference_eval:
        report.update(reference_eval(args.dataset, args.out, args.only_vo))
    print(json.dumps(report))
    sys.stdout.flush()
    return 0


def reference_eval(dataset, out, only_vo) -> dict:
    """Score the trajectories written to ``out`` with the reference's own
    evaluation scripts (``tools/run_reference_eval.py``; the acceptance loop
    of the reference's runPUTSLAM.py), as ``putslam_tpu/run.py:200-231``
    does: writes ``{tag}Ate.res`` / ``{tag}Rpe.res`` for the tags ``g2o``
    (``graph_trajectory.res``) and ``VO`` (``VO_trajectory.res``; the only
    one with ``only_vo``) and returns the report's ``ref_ate_rmse_{tag}_m``
    and ``ref_rpe_trans_{tag}_m``. Nothing without a dataset whose
    directory holds a ``groundtruth.txt``."""
    gt_file = os.path.join(dataset, "groundtruth.txt") if dataset else None
    if not gt_file or not os.path.exists(gt_file):
        return {}
    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import run_reference_eval as ref_eval

    if only_vo:
        pairs = [("VO", os.path.join(out, "VO_trajectory.res"))]
    else:
        pairs = [("g2o", os.path.join(out, "graph_trajectory.res")),
                 ("VO", os.path.join(out, "VO_trajectory.res"))]
    report = {}
    for tag, traj in pairs:
        if not os.path.exists(traj):
            continue
        ate_out = ref_eval.evaluate("ate", gt_file, traj)
        rpe_out = ref_eval.evaluate(
            "rpe", gt_file, traj,
            extra=["--fixed_delta", "--delta", "1", "--delta_unit", "s"])
        with open(os.path.join(out, f"{tag}Ate.res"), "w") as f:
            f.write(ate_out)
        with open(os.path.join(out, f"{tag}Rpe.res"), "w") as f:
            f.write(rpe_out)
        report[f"ref_ate_rmse_{tag}_m"] = round(float(
            ate_out.strip().splitlines()[0]), 5)
        report[f"ref_rpe_trans_{tag}_m"] = round(float(
            rpe_out.strip().splitlines()[0]), 5)
    return report


if __name__ == "__main__":
    raise SystemExit(main())
