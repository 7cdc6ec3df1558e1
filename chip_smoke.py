#!/usr/bin/env python
"""Smoke test of the PyTorch port (putslam_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):
  1. the card: torch.cuda must be available; prints its name and the
     ``nvidia-smi`` name / power limit line.
  2. build the FAST-9 + NMS kernel from csrc/ with nvcc (timed).
  3. the kernel against its plain PyTorch version on the card, at the four
     fr1 pyramid shapes, on a rendered frame's levels and on uniform noise:
     raw and NMS maps must be bit-identical; median times of 50 launches.
  4. detect_and_describe at fr1 on the card against the CPU on one frame.
  5. the bench workload — fr1 config, 64-frame synthetic orbit rendered on
     the card, run_slam_final — once to warm up, then timed with the kernel
     launch counter reset: 4 launches per frame, final ATE under the gate.
 5b. the same frames with every tracked frame a keyframe, so keyframe
     bookkeeping and the windowed, landmark-blocked BA run in the loop.
  6. the CLI: putslam_tpu_torch.run --synthetic 30 writes its four files
     and reports an ATE under 0.05 m.
Then one JSON line describing the kernel, the nvidia-smi line, and the
final status line.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

N_FRAMES = 64
# Gate on the bench workload's ATE: max(0.03 m, 2 × the JAX package's ATE
# on the same workload). The JAX package's number is BENCH_DETAIL.json's
# "ate_rmse_m" (0.01337 m, fr1 config, 64-frame orbit radius 0.10 / yaw
# 0.1, trajectory of the SLAM loop); ATE does not depend on the hardware.
JAX_BENCH_ATE_M = 0.01337
ATE_GATE_M = max(0.03, 2.0 * JAX_BENCH_ATE_M)
CLI_ATE_GATE_M = 0.05
TIMING_RUNS = 50
SPIN_CYCLES = 20_000_000   # ~10 ms of the card's clock


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs=TIMING_RUNS):
    """Median device time of one call of ``fn`` (CUDA events), after a
    warm-up. A spin kernel queued first keeps the card busy while the host
    enqueues the events and the call, so the host's launch overhead does not
    show as idle time between the events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA "
              "card", file=sys.stderr)
        return 1
    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.frontend import detector
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.models import slam
    from putslam_tpu_torch.ops import fast, fast_cuda
    from putslam_tpu_torch import run as run_mod

    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[1] device: {name} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = fast_cuda.build()
    print(f"[2] built {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernel vs plain at the fr1 shapes ------------------------------
    cfg = tum_fr1_config()
    det = cfg.detector
    shapes = detector._pyramid_shapes(cfg)
    frame_pose = synthetic.orbit_trajectory(N_FRAMES, radius=0.10,
                                            yaw_amp=0.1, device=dev)[0]
    gray0, depth0 = synthetic.render_frame(cfg.camera, frame_pose)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    max_err = 0.0
    ms_kernel = ms_plain = 0.0
    for lvl, shape in enumerate(shapes):
        level = gray0 if lvl == 0 else detector.resize(gray0, shape).contiguous()
        noise = torch.rand(shape, generator=gen, device=dev)
        for tag, img in (("frame", level), ("uniform", noise)):
            raw_k, nms_k = fast_cuda.fast_score_nms(img, det.fast_threshold,
                                                    det.nms_radius)
            raw_p = fast.fast_score_map(img, det.fast_threshold)
            nms_p = fast.nms(raw_p, det.nms_radius)
            torch.cuda.synchronize()
            check(torch.equal(raw_k, raw_p), f"raw differs at {shape} {tag}")
            check(torch.equal(nms_k, nms_p), f"nms differs at {shape} {tag}")
            err = max(float((raw_k - raw_p).abs().max()),
                      float((nms_k - nms_p).abs().max()))
            max_err = max(max_err, err)
            if tag == "frame":
                tk = median_ms(lambda: fast_cuda.fast_score_nms(
                    level, det.fast_threshold, det.nms_radius))
                tp = median_ms(lambda: fast.nms(fast.fast_score_map(
                    level, det.fast_threshold), det.nms_radius))
                ms_kernel += tk
                ms_plain += tp
                print(f"[3] {shape[0]}x{shape[1]}: bit-exact (frame, uniform;"
                      f" {int((nms_k > 0).sum())} maxima on the frame); "
                      f"kernel {tk:.4f} ms, plain {tp:.4f} ms", flush=True)

    # ---- 4. detect_and_describe: card vs CPU -------------------------------
    f_gpu = detector.detect_and_describe(cfg, gray0, depth0)
    f_cpu = detector.detect_and_describe(cfg, gray0.cpu(), depth0.cpu())

    def keyset(f):
        v = f.valid.cpu()
        uv = torch.round(f.uv.cpu()[v] * 4).to(torch.int64)
        return {(int(o), int(a), int(b)) for o, (a, b) in
                zip(f.octave.cpu()[v], uv)}

    kg, kc = keyset(f_gpu), keyset(f_cpu)
    lvl0_g = {k for k in kg if k[0] == 0}
    lvl0_c = {k for k in kc if k[0] == 0}
    check(lvl0_g == lvl0_c, "level-0 keypoints differ between card and CPU")
    same = len(kg & kc) / max(len(kg | kc), 1)
    check(same >= 0.99, f"keypoint sets differ: {same:.4f} identical")
    both = (f_gpu.valid & f_cpu.valid.to(dev)
            & (torch.abs(f_gpu.uv - f_cpu.uv.to(dev)).amax(-1) < 1e-3))
    bits = (f_gpu.desc[both] == f_cpu.desc.to(dev)[both]).float().mean()
    check(float(bits) >= 0.995, f"descriptor bits {float(bits):.4f} < 0.995")
    print(f"[4] detect_and_describe card vs CPU: {len(kg)} / {len(kc)} "
          f"keypoints, {same:.4f} of the keypoint set identical (level 0: "
          f"all {len(lvl0_g)}), descriptor bits {float(bits):.5f} equal on "
          f"{int(both.sum())} shared keypoints", flush=True)

    # ---- 5. the bench workload through run_slam_final ----------------------
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=0.10, yaw_amp=0.1,
                                       device=dev)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    gt = poses.cpu().numpy()
    slam.run_slam_final(cfg, grays, depths, init_pose=gt[0], device=dev)
    torch.cuda.synchronize()
    fast_cuda.fast_score_nms.launches = 0
    t0 = time.perf_counter()
    pb, pa, outs, state = slam.run_slam_final(cfg, grays, depths,
                                              init_pose=gt[0], device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fast_cuda.fast_score_nms.launches
    check(launches == det.n_pyramid_levels * N_FRAMES,
          f"kernel launches {launches} != {det.n_pyramid_levels * N_FRAMES}")
    ate_before = ate_mod.ate_rmse_aligned_frames(gt, pb)
    ate_final = ate_mod.ate_rmse_aligned_frames(gt, pa)
    check(pa.shape == (N_FRAMES, 7) and bool(torch.isfinite(
        torch.as_tensor(pa)).all()), "trajectory not finite / wrong shape")
    check(ate_before < ATE_GATE_M and ate_final < ATE_GATE_M,
          f"ATE {ate_before:.5f} / {ate_final:.5f} m over the gate "
          f"{ATE_GATE_M} m")
    print(f"[5] fr1 {N_FRAMES}-frame orbit, run_slam_final: {dt:.3f} s, "
          f"{N_FRAMES / dt:.2f} SLAM frames/s, {1e3 * dt / N_FRAMES:.2f} "
          f"ms/frame (incl. finalize); kernel launches {launches}; "
          f"keyframes {int(outs.is_keyframe.sum())}, BA calls "
          f"{int(outs.ba_ran.sum())}, landmarks {int(outs.n_landmarks[-1])}; "
          f"ATE before final {ate_before:.5f} m, final {ate_final:.5f} m "
          f"(gate {ATE_GATE_M} m; JAX package {JAX_BENCH_ATE_M} m)",
          flush=True)

    # ---- 5b. keyframe-dense variant: every tracked frame a keyframe -------
    # (min_keyframe_matches above the feature count), so the keyframe
    # bookkeeping and the windowed, landmark-blocked BA run in the loop at
    # fr1 capacities
    kf_cfg = cfg.replace(map=dataclasses.replace(cfg.map,
                                                 min_keyframe_matches=10_000))
    fast_cuda.fast_score_nms.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pb2, pa2, outs2, _ = slam.run_slam_final(kf_cfg, grays, depths,
                                             init_pose=gt[0], device=dev)
    torch.cuda.synchronize()
    dt2 = time.perf_counter() - t0
    check(fast_cuda.fast_score_nms.launches == launches,
          "keyframe-dense run: wrong kernel launch count")
    n_ba = int(outs2.ba_ran.sum())
    check(n_ba >= 2, f"keyframe-dense run ran {n_ba} BA calls")
    ate2_b = ate_mod.ate_rmse_aligned_frames(gt, pb2)
    ate2_f = ate_mod.ate_rmse_aligned_frames(gt, pa2)
    check(ate2_b < ATE_GATE_M and ate2_f < ATE_GATE_M,
          f"keyframe-dense ATE {ate2_b:.5f} / {ate2_f:.5f} m over the gate")
    print(f"[5b] keyframe-dense: {dt2:.3f} s, {N_FRAMES / dt2:.2f} SLAM "
          f"frames/s; keyframes {int(outs2.is_keyframe.sum())}, BA calls "
          f"{n_ba}, landmarks {int(outs2.n_landmarks[-1])}; ATE before final "
          f"{ate2_b:.5f} m, final {ate2_f:.5f} m", flush=True)

    # ---- 6. the CLI ---------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_mod.main(["--synthetic", "30", "--out", tmp])
        check(rc == 0, f"run.main returned {rc}")
        for fname in ("VO_trajectory.res", "graph_trajectory.res", "fps.res",
                      "times.txt"):
            path = os.path.join(tmp, fname)
            check(os.path.exists(path) and os.path.getsize(path) > 0,
                  f"run did not write {fname}")
        report = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(report["ate_rmse_m"] < CLI_ATE_GATE_M,
              f"CLI ATE {report['ate_rmse_m']} >= {CLI_ATE_GATE_M}")
        print(f"[6] run --synthetic 30: {report}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fast_score_nms",
        "route": "cuda",
        "source": "putslam_tpu_torch/csrc/fast_score_nms.cu",
        "replaces": "putslam_tpu/ops/fast_pallas.py:82",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
