#!/usr/bin/env python
"""End-to-end SLAM throughput benchmark of the PyTorch port on one CUDA card.

What ``bench.py`` does, on ``putslam_tpu_torch``: the FULL SLAM step —
FAST detect (the hand-written kernel, one launch a frame) → steered-BRIEF
describe → Hamming VO matching → 1024-hypothesis RANSAC → guided map
matching with the retry ladder → absolute-pose RANSAC → keyframe / landmark
bookkeeping → graph append → bundle adjustment every 5 keyframes
(``dense_schur_mm``) — at the reference's fr1_desk operating point
(``tum_fr1_config()``: 640×480, ≤ 512 features, 8192-landmark map) over a
64-frame synthetic orbit (radius 0.10 m, yaw 0.1) rendered on the card:
``slam_init`` on frame 0, ``slam_sequence`` on frames 1–63; then the
VO-only front end, ``vo_sequence`` on all 64 frames.

On a CUDA device both replay every frame from CUDA graphs
(``models/compiled.py``; the detail's ``"step"`` says which ran), captured
in the warm run. Timing: one warm run of each, then ``trials`` trials of
``reps`` runs back to back, each trial between two
``torch.cuda.synchronize()``; the best trial counts.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}. The
detail (VO-only frames/s, ms a frame, keyframes and BA calls this run made,
landmarks, ATE of the SLAM trajectory, the card's name and power limit from
``nvidia-smi``) goes to stderr and to ``chiprun_out/BENCH_DETAIL_torch.json``.

vs_baseline: ``REFERENCE_FPS`` = 2.04 frames/s is the reference C++ binary
measured end to end on the CPU of the host it was built on, on a 640-frame
disk sequence at its own default operating point (``BASELINE.md``). It is
neither a card number nor an accelerator number; it is the same
denominator ``bench.py`` uses.

    python3 bench_torch.py        # on the card; no flags

``main(reps=, trials=, n_frames=, device=, detail_path=, cfg=)`` takes the
same settings as keyword arguments (a CPU test runs the tiny config at 4
frames with ``device="cpu"``). Without a card ``device="cuda"`` raises.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE_FPS = 2.04       # the reference binary on its host's CPU (BASELINE.md)
DESIGN_POINT_FPS = 30.0    # the reference's published real-time design point
N_FRAMES = 64
N_TIMED_REPS = 4
N_TRIALS = 3
DETAIL_PATH = os.path.join(ROOT, "chiprun_out", "BENCH_DETAIL_torch.json")


def card_info():
    """(name, power limit) of the first card as ``nvidia-smi`` reports
    them, or (None, None) where it cannot be asked."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None, None
    if out.returncode != 0 or not out.stdout.strip():
        return None, None
    name, _, limit = out.stdout.strip().splitlines()[0].partition(",")
    return name.strip(), limit.strip()


def best_seconds(fn, reps, trials, sync):
    """One warm call, then ``trials`` trials of ``reps`` calls back to back
    between two synchronisations: (best seconds a call, last result)."""
    out = fn()
    sync()
    best = float("inf")
    for _ in range(trials):
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best, out


def main(reps=N_TIMED_REPS, trials=N_TRIALS, n_frames=N_FRAMES,
         device="cuda", detail_path=DETAIL_PATH, cfg=None):
    """Run the bench; prints the JSON line and returns it as a dict (the
    detail under the key ``"detail"`` of the returned dict only)."""
    import numpy as np
    import torch

    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.eval import ate
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.models import slam, vo
    from putslam_tpu_torch.utils.device import resolve_device, use_graphs

    dev = resolve_device(device)
    cfg = tum_fr1_config() if cfg is None else cfg

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def generator():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return gen

    poses = synthetic.orbit_trajectory(n_frames, radius=0.10, yaw_amp=0.1,
                                       device=dev)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    gt = poses.cpu().numpy()

    # ---- full SLAM (flagship) ------------------------------------------
    state = slam.slam_init(cfg, grays[0], depths[0], poses[0])
    slam_best, (st, outs) = best_seconds(
        lambda: slam.slam_sequence(cfg, state, grays[1:], depths[1:],
                                   generator=generator()),
        reps, trials, sync)
    slam_fps = (n_frames - 1) / slam_best
    est = np.concatenate([gt[:1], outs.pose.cpu().numpy()], axis=0)
    ate_m = ate.ate_rmse_aligned_frames(gt, est)

    # ---- VO-only (the front end's ceiling) -------------------------------
    vo_best, _ = best_seconds(
        lambda: vo.vo_sequence(cfg, grays, depths, generator=generator()),
        reps, trials, sync)
    vo_fps = (n_frames - 1) / vo_best

    n_kf = int(st.map.n_kf)
    n_ba = int(outs.ba_ran.sum())
    name, limit = card_info() if dev.type == "cuda" else (None, None)
    detail = {
        "slam_fps": round(slam_fps, 2),
        "slam_ms_per_frame": round(1000.0 * slam_best / (n_frames - 1), 3),
        "vo_fps": round(vo_fps, 2),
        "n_keyframes": n_kf,
        "n_ba_calls": n_ba,
        "n_landmarks": int(st.map.lm_valid.sum()),
        "ate_rmse_m": round(float(ate_m), 5),
        "frames": n_frames,
        "reps": reps,
        "trials": trials,
        "vs_measured_reference": round(slam_fps / REFERENCE_FPS, 2),
        "vs_design_point_30fps": round(slam_fps / DESIGN_POINT_FPS, 2),
        "solver": cfg.backend.solver,
        "step": "cuda_graphs" if use_graphs(None, dev) else "eager",
        "device": name if name is not None else str(dev),
        "power_limit": limit,
        "note": f"synthetic {cfg.camera.width}x{cfg.camera.height} orbit "
                f"(radius 0.10 m, yaw 0.1); keyframes by the covisibility "
                f"rule in this run: {n_kf}, BA calls: {n_ba}",
    }
    print(json.dumps(detail), file=sys.stderr)
    if detail_path:
        os.makedirs(os.path.dirname(os.path.abspath(detail_path)),
                    exist_ok=True)
        with open(detail_path, "w") as f:
            json.dump(detail, f, indent=1)
    line = {
        "metric": "slam_frames_per_sec_640x480_1chip",
        "value": round(slam_fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(slam_fps / REFERENCE_FPS, 2),
    }
    print(json.dumps(line), flush=True)
    return dict(line, detail=detail)


if __name__ == "__main__":
    main()
