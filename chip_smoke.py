#!/usr/bin/env python
"""Smoke test of the PyTorch port (putslam_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py [--dump-map NPZ]

Phases (any failed check raises and the script exits non-zero):
  1. the card: torch.cuda must be available; prints its name and the
     ``nvidia-smi`` name / power limit line.
  2. build the FAST-9 + NMS kernel from csrc/ with nvcc (timed), and its
     build-time variants beside it, all nvcc runs started together; prints
     what ``ptxas -v`` said of each kernel (registers, shared memory, spills).
  3. the kernel against its plain PyTorch version on the card: the four fr1
     pyramid levels in ONE launch, on a rendered frame's levels, on uniform
     noise and on a uint8-quantised (tie-heavy) image, each level alone, two
     ragged shapes, and nms_radius 0 and 5 through the generic instantiation:
     raw and NMS maps must be bit-identical. Timed after the plain version
     (twice): median of 50 calls each, CUDA events behind a spin kernel;
     then per level alone, 20 calls back to back, once after a flush of the
     L2, the floor of this way of timing (a one-element fill), the kernel's
     own duration as torch.profiler records it, and the build-time tile
     variants on the frame and on noise. The bound is computed from the
     bytes and the operations of this input.
  4. detect_and_describe at fr1 on the card against the CPU on one frame.
  5. the bench workload — fr1 config, 64-frame synthetic orbit rendered on
     the card, run_slam_final — once to warm up, then timed with the
     kernels' launch counters reset: 1 FAST launch per frame, segment sums
     launched (the bench makes no keyframe, so finalize's), final ATE under
     the gate.
 5b. the same frames with every tracked frame a keyframe, so keyframe
     bookkeeping and the windowed, landmark-blocked BA run in the loop.
 5c. the segment-sum kernel (csrc/segment_sum.cu, the solvers' sums in a
     fixed order), on the sums of one Gauss-Newton iteration of three real
     solves (finalize of phase 5's state, the main path's; finalize of
     5b's map; 5b's in-loop BA), recorded: each against its plain version
     (index_add_ on a CPU copy) bit for bit and twice the same; timed over
     all sums of a solve (kernel twice, the plain version, index_add_ with
     atomics, the plans' stable sorts), the kernel's own duration, the
     bound from the bytes and adds of these inputs.
  6. the CLI: putslam_tpu_torch.run --synthetic 30 writes its five files
     (statistics.txt included) and reports an ATE under 0.05 m; with
     --loop-closure the same; --only-vo --vo-version 1 (KLT tracking)
     writes its three files and reports an ATE under 0.15 m.
  7. loop closure: fr1 config, a 64-frame leave-and-return trajectory
     rendered on the card, run_slam_final with loop closure off and on
     (the JAX LC test's settings: tail_skip 10, 64 keyframes; every
     tracked frame a keyframe, as in 5b): 1 launch per frame in each, no
     edge off, at least one accepted edge on, final ATE under 0.05 m with
     it; each run made twice, the two trajectories bit-identical; host
     syncs per frame of each run (CUDA sync-debug warnings counted over
     run_slam).
 7b. the compiled frame: on bench (phase 5's frames), keyframe_dense (5b's)
     and revisit_lc (7's, loop closure on), ``slam_sequence`` from one
     ``slam_init`` state replayed from CUDA graphs (models/compiled.py: one
     graph a frame, every branch of the JAX frame a conditional node, the
     keyframe bookkeeping and the BA inside) and run eagerly, with the same
     per-frame draws: frames/s, ms a frame, host syncs a frame (sync-debug
     count over the whole ``slam_sequence`` call), kernels a frame and
     device ms a frame (torch.profiler over frames 1-COMPILED_PROFILED),
     busy share (device ms over wall ms), capture seconds, graph pool MiB,
     the frame graph's IF nodes, keyframes and BA calls, segment sums a
     frame. Checks: one FAST launch a frame in both modes (a replay counts
     its launch); no host sync on the graph path on any cell; every cell's
     poses bit-equal eager against graph and each mode run twice (the
     solvers' sums in a fixed order, ROADMAP 3p); segment sums launched
     in both modes where a BA ran; bench ATE under the gate, the finalized
     ATE under each phase's gate. Then the bench without the
     retry ladder (``matcher.retries 0``, the yardstick of the skipped
     passes) and the 15 kernels with the most device time in a replayed
     bench frame (torch.profiler, not checked). Every other phase runs the
     graph path, the default on a CUDA device.
  8. the three BA solvers (dense_schur, dense_schur_mm, pcg) on the final
     map of phase 5b, 6 iterations, no robust kernel, no window, the same
     fixed mask (the in-loop BA's, 16 free keyframes): poses within 2e-4
     of dense_schur, final chi² within 2 %; CUDA-event ms per call of
     each; and, unchecked, how far they part with every keyframe but the
     gauge free.
  9. the bench workload with the EKF motion model on: 1 launch per
     frame, ATE under the gate.
 10. tracking VO (vo_version 1) on the bench orbit through vo.run_vo, each
     step replayed from one CUDA graph (KLT, RANSAC, the masked refill with
     its level-0 FAST launch): one launch per frame, RANSAC accepted on
     more than half the steps, ATE under 0.15 m. 10b: the same eagerly
     (graph=False): bit-equal poses and per-step results, frames/s of
     both.
 11. the uncertainty path, keyframe-dense as 5b: map.use_uncertainty with
     the normal-shaped sensor model, backend.use_obs_info (the BA whitens
     with the stored 3x3 information matrices), the Mahalanobis RANSAC
     (error_version 3, gate 16 squared sigmas): 1 launch per frame, a non-zero symmetric obs_info on
     every valid observation, final ATE under the gate; frames/s beside
     5b's, host syncs per frame, the same run at the config's default gate
     (printed, not checked), the ms of one pose_covariances call on the
     final map (CUDA events) and its count of non-finite blocks. Then one
     BA call with the reprojection factor (error_type 1) on that map: chi²
     falls, dense_schur_mm and dense_schur agree, and the poses stay within
     3e-2 of the Euclidean solve's (the 2D factor leaves depth free); one
     with the whitening: chi² falls, poses within 2e-3.
 12. the front-end options on the bench workload: the exact grid cap with
     the LDB descriptor and ratio acceptance, and multi-mate guided
     matching (max_mates 3): 1 launch per frame, ATE under the gate,
     frames/s beside phase 5's; LDB descriptor bits on one frame, card
     against CPU.
 13. the file player: a 128-frame handheld sequence (fr1_desk's dynamics,
     ``handheld_trajectory(128, seed=3)``) rendered on the card, written to
     disk in TUM layout with ``tum.write_tum_dataset`` and a camera.json
     (under data/, removed at the end), read back (frame count, the
     first frame equal to the rendered one to the PNG quantisation, 1/255
     and 1/5000 m), then played through the CLI, ``run --dataset``: the five
     files, 1 launch per frame, final ATE under the gate; frames/s with and
     without the read, the decoder that ran (native or python), keyframes
     and BA calls the covisibility rule made by itself.
 14. the host map archive and the global BA: ``run --dataset --global-ba``
     on that sequence at the defaults of ``global_bundle_adjust``: every
     keyframe archived, every archived edge on an archived vertex, the
     polished trajectory finite and its ATE no worse than 1.2 x the
     unpolished + 1e-4; then 64 of its frames keyframe-dense on a 32-slot
     keyframe ring that wraps (``run_slam_global``, chunks of 16): more than
     32 keyframes archived, all that were made. Per absorb its ms and host
     syncs, per window the ms of host assembly and of the solve, and the
     count of windows whose solve moved no keyframe. The window solves are
     replays of one CUDA graph (``compiled.WindowGraphs``, captured on the
     first window); the first run's archive is polished again eagerly and
     twice replayed: per window the assembly ms and the solve ms of both
     (the replay's includes the copy of the window into its buffers, the
     eager's follows its upload), the polished keyframes of the two within
     FINALIZE_DIST_TOL.
 15. the state tools: the bench run stopped after frame 32, written with
     ``checkpoint.save_state`` (the generator's state beside it), loaded
     into a fresh ``slam_init`` state and continued: equal to the
     uninterrupted run; ``run_playback`` on the bench orbit with the true
     poses, keyframe-dense: keyframes and landmarks grow, the emitted poses
     stay on the given ones (median under 15 mm, worst under 80 mm: the map
     RANSAC's correction and the BA's re-anchoring move them), and with
     every correction refused and no BA they equal the given ones to 1e-5;
     phase 5b's final graph through ``g2o.export_graph`` and
     ``import_graph``: the same vertices and edges.
 16. the distributed path (parallel/), in a process group of one rank on
     NCCL joined by this process: (a) ``dist_gauss_newton`` on phase 5b's
     map under phase 8's mask against ``gauss_newton_mm`` (poses within
     the solver tolerance; ms a call of both, CUDA events; all-reduce
     bytes and ms an iteration); (c) ``finalize_dist`` on phase 13's
     handheld state (the sequence read back from disk, run through
     ``run_slam``) against ``finalize`` (5e-3) with the final ATE under
     the gate; (b) the same graph on two spawned ranks sharing the card
     over gloo (``tools/multihost_dryrun_torch.py``, a ``file://``
     rendezvous): the ranks equal, and equal to (a) within the solver
     tolerance, ms a call (two ranks on one card: not a scaling number),
     and their ``global_bundle_adjust(mesh=)`` of the handheld archive
     within 5e-3 of the single sweep; (d) ``vo_sessions_sharded`` on two
     handheld sessions of 32 frames (seeds 3 and 4): one kernel launch a
     frame, each session's ATE under the golden VO gate; (e) two sessions
     with loop closure, frames 40-79 of phase 13's sequence walked forward
     and backward (two traversals of one place), merged, cross-session
     closures found and
     ``joint_optimize``d: at least one edge accepted, the overflow count,
     chi2 not above 1.05 x its first value. A spawned rank that fails
     fails the script.
 17. the last modules: (a) ``bench_torch.main`` with one trial of one rep:
     its JSON line's four keys, its value beside phase 5's frames/s, the
     SLAM ATE under the gate, its kernel launches counted (255: slam_init,
     two runs of 63 frames, two of 64 for the VO); (b)
     ``tools/profile_vo_torch.py`` at fr1 over 64 frames: the five stage
     times a frame; (c) ``io/synthetic2.py``: 64 handheld frames rendered
     on the card (ms a frame), frame 0 against the port's CPU render
     (depth 1e-6 m, gray 1e-5 on 99.9 % of pixels), the sequence written
     by ``tools/make_disk_dataset_torch.py --renderer planes --device cuda``
     and played through ``run --dataset`` (ATE reported, not gated; one
     launch a frame); (d) the acceptance operating point's engine half
     (``tools/run_acceptance_torch.py::run_engine``) on phase 13's
     sequence: ATE before and after the polish, keyframes, archived
     observations, wall time (the reference's scoring needs its scripts);
     (e) ``se2.optimize_pose_graph`` on the card (the square loop within
     1e-3 of the truth, a 256-pose ring within 1e-4 of the port's CPU
     result and bit-equal to itself run again) and ``refine_patch_alignment_affine`` polishing the KLT
     tracks of 512 keypoints of phase 5's frames 0 -> 1 (98 % of the points
     within 1e-3 px of the CPU result), ms a call each.
 18. the compiled end of the run: ``finalize`` eager (``graph=False``, each
     Gauss-Newton iteration's stop read on the host) and replayed from its
     CUDA graph (``compiled.FinalizeGraphs``, both solves' iterations IF
     nodes, the chi² prune and ``check_trajectory`` inside) on 7b's
     keyframe_dense and revisit_lc final states and on 16c's handheld
     state: ms of the first call (the capture included) and of a warm one,
     host syncs of a warm call (0 on the graph path), kernels and device
     ms (torch.profiler), IF nodes, capture s, both pools' MiB, the
     Gauss-Newton iterations the stop skipped, segment sums a call; graph
     against eager bit for bit (poses, landmarks, pruned observations) on
     every state; the finalized ATE of each under its gate. Then
     ``check_trajectory`` on the card against the CPU on keyframe_dense's
     polished map with odometry edges and three
     keyframes moved by 0.5 m: the same repairs, poses within
     CHECK_TRAJECTORY_TOL; ms a call.
Then one JSON line describing the two kernels, the nvidia-smi line, and
the final status line.
"""

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import torch

N_FRAMES = 64
# Gate on the bench workload's ATE: max(0.03 m, 2 × the JAX package's ATE
# on the same workload). The JAX package's number is BENCH_DETAIL.json's
# "ate_rmse_m" (0.01337 m, fr1 config, 64-frame orbit radius 0.10 / yaw
# 0.1, trajectory of the SLAM loop); ATE does not depend on the hardware.
JAX_BENCH_ATE_M = 0.01337
ATE_GATE_M = max(0.03, 2.0 * JAX_BENCH_ATE_M)
CLI_ATE_GATE_M = 0.05
# the JAX package's own gates: loop closure tests/test_loop_closure.py:58,
# KLT tracking VO tests/test_klt.py:79-80, solver agreement
# tests/test_round3.py:259-264
LC_FRAMES = 64
LC_ATE_GATE_M = 0.05
KLT_ATE_GATE_M = 0.15
SOLVER_POSE_TOL = 2e-4
# the Mahalanobis gate of the uncertainty path: squared sigmas, the JAX
# package's own test value (tests/test_uncertainty_parity.py:95). The
# config's default, 2e-4, is a squared distance in metres for the RANSAC
# calls that get no information matrices, and 0.014 sigma for the map's,
# which then accepts no pose
MAHALANOBIS_GATE = 16.0
# how far the reprojection BA may move the poses from the Euclidean solve's:
# the 2D factor leaves depth free, and on the phase-11 map its optimum lies
# 1.3e-2 away (in the JAX package as in the port, all three solvers)
REPROJ_POSE_TOL = 3e-2
SOLVER_CHI2_RTOL = 0.02
# free keyframes in phase 8 (the in-loop BA's window mask)
SOLVER_WINDOW = 16
# the file-played handheld sequence (phase 13) and the ring that wraps (14)
FILE_FRAMES = 128
WRAP_FRAMES, WRAP_RING, WRAP_CHUNK = 64, 32, 16
# the reference test's bound on the globally polished trajectory
# (tests/test_round4.py:250)
GBA_ATE_FACTOR, GBA_ATE_SLACK = 1.2, 1e-4
# playback: the emitted pose is the given one moved by the map RANSAC's
# accepted correction and by the BA's re-anchoring of its keyframe. On this
# orbit (radius 0.10 m) the emitted poses were 6.3-6.8 mm from the given ones
# at the median and 22.9-47.5 mm at most in four calls: the median's gate is
# twice the measured one, the worst frame's is the engine's own bound on an
# accepted correction (max_map_correction, 0.08 m). The plain run of phase
# 5b, on its own VO, lies as close to the truth on this orbit (6.7 mm at the
# median), so these gates alone would pass a playback that ignored the given
# poses: the second playback refuses every map correction
# (max_map_correction 0) and runs no BA, so that nothing moves the
# prediction, and must emit the given poses to float32 rounding
PLAYBACK_MEDIAN_TOL_M = 0.015
PLAYBACK_MAX_TOL_M = 0.08
PLAYBACK_EXACT_TOL = 1e-5
CHECKPOINT_FRAME = 32
# phase 16: the VO sessions (handheld_trajectory seeds, frames of each); the
# SLAM sessions merged: one window of phase 13's sequence walked forward and
# backward (two traversals of one place; the window keeps the merged problem
# under ~29 free keyframes, where the bf16-rounded reduced system stays
# definite, ROADMAP 3ac); the golden table's
# VO gate (tests/golden_ate.json orbit30_vo); finalize_dist and the global
# BA over two ranks against their single-device counterparts
# (tests/test_round5.py:44,64); the joint BA's chi2 gate
# (tests/test_multi_session.py:56); the spawned ranks' time limit
DIST_SESSION_SEEDS = (3, 4)
DIST_VO_FRAMES = 32
DIST_SESSION_WINDOW = (40, 80)
# (e): the generator seeds of the two sessions. On these 40 frames the
# covisibility rule makes one keyframe a session for most draws, and then no
# cross-session closure exists. Over the session seed pairs (0, 1) ... (14,
# 15) on the card, the port's stream before the RANSAC uniforms were drawn
# on every frame closed a loop only at (0, 1) (keyframes 1 + 3), the stream
# since then at (6, 7) (1 + 3) and (14, 15) (1 + 10); the others make 1 + 1
DIST_LC_SEEDS = (6, 7)
# (e2): keyframe-dense sessions (start, stop, step) of the same sequence
# that overlap in frames 47-53, 14 keyframes each; the chi2 gate holds up
# to this many free keyframes (3ac: from 34 the bf16-rounded system is
# often indefinite)
DIST_DENSE_WALKS = ((40, 54, 1), (60, 46, -1))
DEFINITE_FREE_MAX = 29
VO_ATE_GATE_M = 0.08
FINALIZE_DIST_TOL = 5e-3
JOINT_CHI2_FACTOR = 1.05
RANK_TIMEOUT_S = 300
# phase 17: the VO stage profile's timed runs; the plane-scene walk's seed
# and its card-against-CPU criteria (depth 1e-6 m; gray within 1e-5 on
# 99.9 % of the pixels: `dirs @ n` may sum in another order on the card and
# flip a speckle cell whose floor(a * speckle_scale) sits on a boundary;
# measured: depth equal, gray within 2.98e-8, 0 of 307,200 pixels over);
# the SE(2) ring and the affine alignment, card against the port's CPU
# (the ring measured within 4.77e-7, the square within 1.26e-7 of the
# truth). The affine alignment polishes the pyramidal KLT's tracks with the
# tracker's refine window (11); its freeze test (the translation step under
# eps) flips on last-bit differences and sends a few points elsewhere (on
# the CPU alone: tests/test_torch_klt_affine.py::
# test_affine_polish_last_bit_sensitivity); card against CPU 2 of 394
# points over 1e-3 px (0.9949 within, 8.33e-3 px at most). So 98 % of the
# points kept by both must agree within 1e-3 px
PROFILE_VO_RUNS = 2
PLANES_SEED = 5
PLANES_DEPTH_TOL, PLANES_GRAY_TOL, PLANES_GRAY_SHARE = 1e-6, 1e-5, 0.999
SE2_RING, SE2_ITERS, SE2_CARD_TOL = 256, 10, 1e-4
AFFINE_POINTS, AFFINE_CARD_TOL, AFFINE_OK_SHARE = 512, 1e-3, 0.99
AFFINE_AGREE_SHARE = 0.98
TIMING_RUNS = 50
SPIN_CYCLES = 20_000_000   # ~10 ms of the card's clock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # the same sheet, float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20  # five times the 50 MB L2
RAGGED_SHAPES = ((33, 35), (65, 97))
# phase 7b: frames under the profiler (of 63). Every cell's poses must be
# bit-equal eager against graph and each mode against itself run twice:
# every floating-point segment sum of the solvers runs in a fixed order
# (ops/segment.py, csrc/segment_sum.cu). Before that, index_add_'s atomics
# summed in another order on every run (ROADMAP 3p), and from 34 free
# keyframes on the bf16-rounded reduced system turned that into another
# Gauss-Newton step (3ac): eager against graph 1.59e-2-4.35e-2 m, and the
# same mode run twice 1.97e-2-4.60e-2 (eager) and 1.64e-2-3.61e-2 (graph)
COMPILED_PROFILED = 4
# phase 18: check_trajectory on the card against the CPU, the CPU test's
# tolerance against the JAX package (tests/test_torch_finalize.py)
CHECK_TRAJECTORY_TOL = 1e-5
# build-time variants of csrc/fast_score_nms.cu, timed beside the default
# (32x24 tiles, 128 threads, plain vector loads, sums only behind an arc)
VARIANTS = {
    "tile 32x32, 256 threads": ("FAST_TILE_H=32", "FAST_THREADS=256"),
    "tile 64x32, 256 threads": ("FAST_TILE_W=64", "FAST_TILE_H=32",
                                "FAST_THREADS=256"),
    "tile 64x32, 1024 threads": ("FAST_TILE_W=64", "FAST_TILE_H=32",
                                 "FAST_THREADS=1024"),
    "tile 32x16, 128 threads": ("FAST_TILE_H=16",),
}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs=TIMING_RUNS, reps=1, before=None):
    """Median device time of one call of ``fn`` (CUDA events), after a
    warm-up. A spin kernel queued first keeps the card busy while the host
    enqueues the events and the call, so the host's launch overhead does not
    show as idle time between the events. ``reps`` calls back to back share
    one pair of events (their time is divided by ``reps``); ``before`` is
    queued ahead of the spin kernel, outside the events (an L2 flush)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def profiler_us(fn, match, calls=20):
    """Mean device time in µs of the kernels whose name holds ``match``
    over ``calls`` calls of ``fn``, as torch.profiler (CUPTI) records each
    kernel's own duration: no event and no launch gap in it. None where the
    profiler recorded no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if match in e.key)
    return total / calls if total > 0 else None


def count_syncs(fn):
    """(fn(), number of synchronising CUDA calls it made), read from
    torch's sync-debug warnings."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = sum("synchronizing" in str(w.message) for w in caught)
    return out, n


def timed(fn, launches):
    """(fn(), wall seconds, FAST kernel launches) of one call, between two
    synchronisations, with the launch counter set to 0 just before."""
    torch.cuda.synchronize()
    launches.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, launches.launches


def frames_processed(n, chunk):
    """Frames that ``run_slam`` detects on for an ``n``-frame sequence moved
    in chunks of ``chunk``: the tail chunk is padded with copies of its last
    frame (trimmed from the outputs), and each is one kernel launch."""
    if not chunk or n - 1 <= chunk:
        return n
    return 1 + -(-(n - 1) // chunk) * chunk


def run_cli(run_mod, args, files, extras=None):
    """run.main(args + --out tmp) → its JSON report; checks the files.
    ``extras``: a dict that receives ``stages`` (times.txt: stage → total
    seconds) and ``stats`` (statistics.txt: key → value)."""
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_mod.main(args + ["--out", tmp])
        check(rc == 0, f"run.main {args} returned {rc}")
        for fname in files:
            path = os.path.join(tmp, fname)
            check(os.path.exists(path) and os.path.getsize(path) > 0,
                  f"run {args} did not write {fname}")
        if "statistics.txt" in files:
            with open(os.path.join(tmp, "statistics.txt")) as f:
                keys = [line.split()[0] for line in f]
            check(keys == ["frames", "vo_ok_fraction", "map_ok_fraction",
                           "keyframes", "ba_runs", "map_inliers_median",
                           "map_matches_median", "landmarks_final"],
                  f"statistics.txt keys {keys}")
        if extras is not None:
            with open(os.path.join(tmp, "times.txt")) as f:
                extras["stages"] = {
                    line.split(":")[0]: float(line.split("(total ")[1].split()[0])
                    for line in f}
            with open(os.path.join(tmp, "statistics.txt")) as f:
                extras["stats"] = {k: float(v) for k, v in
                                   (line.split() for line in f)}
        return json.loads(buf.getvalue().strip().splitlines()[-1])


def uncertainty_config(cfg):
    """``cfg`` keyframe-dense (as phase 5b) with the uncertainty path on:
    information matrices of the sensor model shaped by the surface normals,
    the BA whitening with them, the Mahalanobis RANSAC at a gate of
    ``MAHALANOBIS_GATE`` squared sigmas."""
    return cfg.replace(
        map=dataclasses.replace(cfg.map, min_keyframe_matches=10_000,
                                use_uncertainty=True,
                                uncertainty_model="normal"),
        backend=dataclasses.replace(cfg.backend, use_obs_info=True),
        ransac=dataclasses.replace(
            cfg.ransac, error_version=3,
            inlier_threshold_mahalanobis=MAHALANOBIS_GATE))


def phase_uncertainty(cfg, grays, depths, gt, dev, ref_s, dump_map=None):
    """Phase 11. ``ref_s``: the seconds phase 5b took in this call;
    ``dump_map``: a path to write the final map and graph to (npz)."""
    from putslam_tpu_torch.backend import optimize as opt_mod
    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.models import slam
    from putslam_tpu_torch.ops import fast_cuda
    from putslam_tpu_torch.slam_map import features_map as fm

    n_frames = grays.shape[0]
    ucfg = uncertainty_config(cfg)
    (pb, pa, outs, state), dt, n_launch = timed(
        lambda: slam.run_slam_final(ucfg, grays, depths, init_pose=gt[0],
                                    device=dev), fast_cuda.fast_score_nms)
    check(n_launch == n_frames,
          f"uncertainty run: kernel launches {n_launch} != {n_frames}")
    n_ba = int(outs.ba_ran.sum())
    check(n_ba >= 2, f"uncertainty run ran {n_ba} BA calls")
    g = state.graph
    info = g.obs_info[g.obs_valid]
    check(info.shape[0] > 0, "uncertainty run stored no observation")
    peak = info.abs().amax(dim=(-1, -2))
    check(bool((peak > 0).all()) and bool(torch.isfinite(info).all()),
          "a valid observation has a zero or non-finite obs_info")
    asym = float(((info - info.transpose(-1, -2)).abs().amax(dim=(-1, -2))
                  / peak).max())
    check(asym < 1e-4, f"obs_info asymmetric by {asym:.2e} of its peak")
    ate_b = ate_mod.ate_rmse_aligned_frames(gt, pb)
    ate_f = ate_mod.ate_rmse_aligned_frames(gt, pa)
    check(bool(torch.isfinite(torch.as_tensor(pa)).all()),
          "uncertainty run: trajectory not finite")
    check(ate_f < ATE_GATE_M, f"uncertainty final ATE {ate_f:.5f} m over "
          f"the gate {ATE_GATE_M} m")
    _, n_sync = count_syncs(lambda: slam.run_slam(
        ucfg, grays, depths, init_pose=gt[0], device=dev))
    print(f"[11] uncertainty path (normal model, use_obs_info, Mahalanobis "
          f"RANSAC), keyframe-dense: {dt:.3f} s, {n_frames / dt:.2f} SLAM "
          f"frames/s, {1e3 * dt / n_frames:.2f} ms/frame (5b in this call: "
          f"{n_frames / ref_s:.2f} frames/s, {1e3 * ref_s / n_frames:.2f} "
          f"ms/frame); launches {n_launch}; keyframes "
          f"{int(outs.is_keyframe.sum())}, BA calls {n_ba}, map ok on "
          f"{int(outs.map_ok.sum())} of {n_frames - 1} frames, median map "
          f"inliers {float(torch.as_tensor(outs.n_map_inliers).float().median()):.0f}; "
          f"{info.shape[0]} observations with obs_info (asymmetry "
          f"{asym:.1e}); ATE before final {ate_b:.5f} m, final {ate_f:.5f} "
          f"m; host syncs per frame in run_slam "
          f"{n_sync / (n_frames - 1):.2f}", flush=True)

    # the same run at the config's default gate (2e-4), printed and not
    # checked: the map RANSAC then accepts next to no pose
    dcfg = ucfg.replace(ransac=dataclasses.replace(
        ucfg.ransac, inlier_threshold_mahalanobis=cfg.ransac
        .inlier_threshold_mahalanobis))
    _, pa_d, outs_d, _ = slam.run_slam_final(dcfg, grays, depths,
                                             init_pose=gt[0], device=dev)
    print(f"[11] at the default Mahalanobis gate "
          f"{cfg.ransac.inlier_threshold_mahalanobis:g} (not checked): map "
          f"ok on {int(outs_d.map_ok.sum())} of {n_frames - 1} frames, VO ok "
          f"on {int(outs_d.vo_ok.sum())}, final ATE "
          f"{ate_mod.ate_rmse_aligned_frames(gt, pa_d):.5f} m; at "
          f"{MAHALANOBIS_GATE:g} above: VO ok on {int(outs.vo_ok.sum())}",
          flush=True)

    m = state.map
    seqs = torch.where(m.kf_valid, m.kf_seq,
                       torch.full_like(m.kf_seq, 2 ** 31 - 1))
    gauge = torch.zeros_like(m.kf_valid)
    gauge[torch.argmin(seqs)] = True
    window_fixed = fm.active_window_fixed(m, SOLVER_WINDOW) | gauge
    if dump_map:
        import numpy as np

        os.makedirs(os.path.dirname(dump_map) or ".", exist_ok=True)
        np.savez_compressed(
            dump_map, gauge=gauge.cpu().numpy(),
            window_fixed=window_fixed.cpu().numpy(),
            **{f"map_{k}": v.cpu().numpy() for k, v in m._asdict().items()
               if torch.is_tensor(v)},
            **{f"graph_{k}": v.cpu().numpy() for k, v in g._asdict().items()
               if torch.is_tensor(v)})
        print(f"[11] wrote the final map and graph to {dump_map}", flush=True)

    def covariances(fixed):
        return opt_mod.pose_covariances(
            ucfg.backend, m.kf_pose, m.kf_valid, m.lm_pos, m.lm_valid, g,
            fixed, lm_gen=m.lm_gen, kf_gen=m.kf_gen, cam=cfg.camera)

    for label, fixed in (("every keyframe but the gauge free", gauge),
                         (f"the newest {SOLVER_WINDOW} free", window_fixed)):
        cov = covariances(fixed)
        free = m.kf_valid & ~fixed
        bad = int((~torch.isfinite(cov[free]).all(dim=-1).all(dim=-1)).sum())
        check(cov.shape == (m.kf_pose.shape[0], 6, 6)
              and bool((cov[~free] == 0).all()),
              "pose_covariances: wrong shape or a frozen block not zero")
        ms = median_ms(lambda fixed=fixed: covariances(fixed), runs=5)
        sig = float(cov[free][:, :3, :3].diagonal(dim1=-1, dim2=-2)
                    .clamp(min=0).sqrt().nanmedian()) if bad < int(
                        free.sum()) else float("nan")
        print(f"[11] pose_covariances, {label} ({int(free.sum())} blocks of "
              f"K={m.kf_pose.shape[0]}, a {6 * m.kf_pose.shape[0]}-square "
              f"solve): {ms:.3f} ms a call, {bad} non-finite blocks, median "
              f"translation sigma {1e3 * sig:.3f} mm", flush=True)

    def solve(**over):
        bcfg = dataclasses.replace(cfg.backend, gn_iterations=6,
                                   robust_kernel="none", ba_window=0, **over)
        return opt_mod.optimize_graph(
            bcfg, m.kf_pose, m.kf_valid, m.lm_pos, m.lm_valid, g,
            window_fixed, lm_gen=m.lm_gen, kf_gen=m.kf_gen, cam=cfg.camera)

    eucl = solve()
    whit = solve(use_obs_info=True)
    repr_ = solve(error_type=1)
    repr_ds = solve(error_type=1, solver="dense_schur")
    chi = [float(x) for x in repr_.chi2]
    check(all(x == x for x in chi) and chi[-1] < chi[0],
          f"reprojection BA: chi2 did not fall: {chi}")
    dsolver = float((repr_.kf_pose - repr_ds.kf_pose)[m.kf_valid].abs().max())
    check(dsolver < SOLVER_POSE_TOL
          and abs(chi[-1] - float(repr_ds.chi2[-1])) < SOLVER_CHI2_RTOL * chi[-1],
          f"reprojection BA: dense_schur_mm {dsolver:.2e} from dense_schur, "
          f"chi2 {chi[-1]} vs {float(repr_ds.chi2[-1])}")
    dpose = float((repr_.kf_pose - eucl.kf_pose)[m.kf_valid].abs().max())
    check(dpose < REPROJ_POSE_TOL, f"reprojection BA poses {dpose:.2e} from "
          "the Euclidean solve's")
    dwhit = float((whit.kf_pose - eucl.kf_pose)[m.kf_valid].abs().max())
    check(float(whit.chi2[-1]) < float(whit.chi2[0]) and dwhit < 2e-3,
          f"whitened BA: chi2 {whit.chi2.tolist()}, poses {dwhit:.2e} from "
          "the Euclidean solve's")
    print(f"[11] one BA call on that map ({cfg.backend.solver}, 6 iterations, "
          f"{int((m.kf_valid & ~window_fixed).sum())} keyframes free): "
          f"reprojection factor chi2 {chi[0]:.6g} -> {chi[-1]:.6g} (px/sigma)"
          f"^2, poses within {dpose:.2e} of the Euclidean solve's (its chi2 "
          f"{float(eucl.chi2[0]):.6g} -> {float(eucl.chi2[-1]):.6g}) and "
          f"{dsolver:.2e} of dense_schur's; whitened with obs_info chi2 "
          f"{float(whit.chi2[0]):.6g} -> {float(whit.chi2[-1]):.6g}, poses "
          f"within {dwhit:.2e}", flush=True)


def phase_frontend_options(cfg, grays, depths, gt, dev, ref_s):
    """Phase 12. ``ref_s``: the seconds phase 5 took in this call."""
    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.frontend import detector
    from putslam_tpu_torch.models import slam
    from putslam_tpu_torch.ops import fast_cuda

    n_frames = grays.shape[0]
    variants = {
        "exact grid cap + LDB + ratio acceptance": cfg.replace(
            detector=dataclasses.replace(cfg.detector, grid_policy="exact",
                                         descriptor="ldb"),
            matcher=dataclasses.replace(cfg.matcher, acceptance="ratio")),
        "max_mates 3": cfg.replace(
            matcher=dataclasses.replace(cfg.matcher, max_mates=3)),
    }
    for label, vcfg in variants.items():
        # the first run builds the LDB bank and warms the new code paths
        slam.run_slam(vcfg, grays[:4], depths[:4], init_pose=gt[0],
                      device=dev)
        (pb, pa, outs, _), dt, n_launch = timed(
            lambda vcfg=vcfg: slam.run_slam_final(
                vcfg, grays, depths, init_pose=gt[0], device=dev),
            fast_cuda.fast_score_nms)
        check(n_launch == n_frames,
              f"{label}: kernel launches {n_launch} != {n_frames}")
        ate_b = ate_mod.ate_rmse_aligned_frames(gt, pb)
        ate_f = ate_mod.ate_rmse_aligned_frames(gt, pa)
        check(bool(torch.isfinite(torch.as_tensor(pa)).all()),
              f"{label}: trajectory not finite")
        check(ate_b < ATE_GATE_M and ate_f < ATE_GATE_M,
              f"{label}: ATE {ate_b:.5f} / {ate_f:.5f} m over the gate")
        print(f"[12] bench with {label}: {dt:.3f} s, {n_frames / dt:.2f} "
              f"SLAM frames/s, {1e3 * dt / n_frames:.2f} ms/frame (phase 5 "
              f"in this call: {n_frames / ref_s:.2f} frames/s); launches "
              f"{n_launch}; VO ok {int(outs.vo_ok.sum())}, map ok "
              f"{int(outs.map_ok.sum())} of {n_frames - 1}, median map "
              f"inliers {float(torch.as_tensor(outs.n_map_inliers).float().median()):.0f}; "
              f"ATE before final {ate_b:.5f} m, final {ate_f:.5f} m",
              flush=True)

    ldb_cfg = variants["exact grid cap + LDB + ratio acceptance"]
    f_gpu = detector.detect_and_describe(ldb_cfg, grays[0], depths[0])
    f_cpu = detector.detect_and_describe(ldb_cfg, grays[0].cpu(),
                                         depths[0].cpu())
    both = (f_gpu.valid & f_cpu.valid.to(dev)
            & (torch.abs(f_gpu.uv - f_cpu.uv.to(dev)).amax(-1) < 1e-3))
    share = int(both.sum()) / max(int(f_cpu.valid.sum()), 1)
    check(share >= 0.99, f"exact grid cap: {share:.4f} of the CPU's "
          "keypoints found on the card")
    bits = float((f_gpu.desc[both] == f_cpu.desc.to(dev)[both]).float().mean())
    check(bits >= 0.995, f"LDB descriptor bits {bits:.4f} < 0.995")
    print(f"[12] LDB descriptors, exact grid cap, card vs CPU on one frame: "
          f"{int(both.sum())} of {int(f_cpu.valid.sum())} keypoints shared, "
          f"descriptor bits {bits:.5f} equal", flush=True)


FIVE_FILES = ("VO_trajectory.res", "graph_trajectory.res", "fps.res",
              "times.txt", "statistics.txt")


def phase_file_player(cfg, dev, root, ref_s):
    """Phase 13. Writes the handheld sequence under ``root`` and plays it
    through the CLI. ``ref_s``: the seconds phase 5 took in this call for
    its 64 frames. Returns (rendered grays, depths, ground truth, launches,
    the CLI report)."""
    import numpy as np

    from putslam_tpu_torch import run as run_mod
    from putslam_tpu_torch.io import native_loader, synthetic, tum
    from putslam_tpu_torch.ops import fast_cuda

    n = FILE_FRAMES
    t0 = time.perf_counter()
    poses = synthetic.handheld_trajectory(n, seed=3, device=dev)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    gt = poses.cpu().numpy()
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    step_t = float(np.median(np.linalg.norm(np.diff(gt[:, :3], axis=0),
                                            axis=1)))
    t0 = time.perf_counter()
    tum.write_tum_dataset(root, grays.cpu().numpy(), depths.cpu().numpy(), gt,
                          depth_scale=cfg.camera.depth_image_scale)
    with open(os.path.join(root, "camera.json"), "w") as f:
        json.dump({"fu": cfg.camera.fu, "fv": cfg.camera.fv,
                   "cu": cfg.camera.cu, "cv": cfg.camera.cv,
                   "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
                   "width": cfg.camera.width, "height": cfg.camera.height,
                   "depth_image_scale": cfg.camera.depth_image_scale}, f)
    t_write = time.perf_counter() - t0
    size_mb = sum(os.path.getsize(os.path.join(d, x))
                  for d, _, xs in os.walk(root) for x in xs) / 1e6

    ds = tum.TumDataset(root, depth_scale=cfg.camera.depth_image_scale)
    check(len(ds) == n, f"file player: {len(ds)} associated frames of {n}")
    frames = iter(ds)
    first = next(frames)
    frames.close()
    for probe, loader in ((first, ds.loader), (ds[0], "python")):
        dg = float(np.abs(probe.gray - grays[0].cpu().numpy()).max())
        dd = float(np.abs(probe.depth - depths[0].cpu().numpy()).max())
        check(dg <= 1 / 255 and dd <= 1 / cfg.camera.depth_image_scale,
              f"first frame read back ({loader}) off by {dg:.2e} gray, "
              f"{dd:.2e} m depth")
    t0 = time.perf_counter()
    for _ in ds:
        pass
    t_read = time.perf_counter() - t0
    native = ds.loader
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    t_read_py = time.perf_counter() - t0
    try:
        ctypes.CDLL(native_loader._SO_PATH)
        why = "its library loads"
    except OSError as e:
        why = f"its library does not load: {e}"
    print(f"[13] handheld sequence, {n} frames at {cfg.camera.width}x"
          f"{cfg.camera.height} (median step {1e3 * step_t:.2f} mm a frame): "
          f"rendered in {t_render:.2f} s, written in {t_write:.2f} s "
          f"({1e3 * t_write / n:.1f} ms a frame, {size_mb:.1f} MB); read "
          f"back: iterating ({native} loader; the native loader: {why}) "
          f"{1e3 * t_read / n:.2f} ms a frame, indexing (python decoder) "
          f"{1e3 * t_read_py / n:.2f} ms a frame; first frame within "
          f"1/255 and 1/{cfg.camera.depth_image_scale:g} m of the rendered "
          f"one", flush=True)

    # warm-up on a few frames, then the timed run through the CLI
    run_cli(run_mod, ["--dataset", root, "--max-frames", "4"], FIVE_FILES)
    extras = {}
    torch.cuda.synchronize()
    fast_cuda.fast_score_nms.launches = 0
    report = run_cli(run_mod, ["--dataset", root], FIVE_FILES, extras)
    launches = fast_cuda.fast_score_nms.launches
    check(report["frames"] == n, f"file player ran {report['frames']} frames")
    n_det = frames_processed(n, 64)      # the CLI's default --chunk
    check(launches == n_det,
          f"file player: kernel launches {launches} != {n_det}")
    check(report["loader"] in ("native", "python"), "no loader reported")
    stats, stages = extras["stats"], extras["stages"]
    slam_s, read_s = stages["slam_total"], stages["dataset"]
    ate = report["ate_rmse_m"]
    check(ate == ate and report["ate_before_final_m"] == report[
        "ate_before_final_m"], "file player: ATE not finite")
    check(ate < ATE_GATE_M, f"file player final ATE {ate:.5f} m over the "
          f"gate {ATE_GATE_M} m (map ok on {stats['map_ok_fraction']:.3f} of "
          f"the frames)")
    print(f"[13] run --dataset (loader {report['loader']}): {report}; "
          f"{n / slam_s:.2f} SLAM frames/s without the read "
          f"({1e3 * slam_s / n:.2f} ms/frame), {n / (slam_s + read_s):.2f} "
          f"with it (read and decode {1e3 * read_s / n:.2f} ms a frame); "
          f"phase 5 in this call {N_FRAMES / ref_s:.2f} frames/s; launches "
          f"{launches} ({n} frames and {n_det - n} padded copies of the last "
          f"in the tail chunk); keyframes {int(stats['keyframes'])} (n_kf "
          f"{int(stats['keyframes']) + 1} of a {cfg.map.max_keyframes}-slot "
          f"ring), BA calls {int(stats['ba_runs'])}, VO ok "
          f"{stats['vo_ok_fraction']:.3f}, map ok "
          f"{stats['map_ok_fraction']:.3f}, median map inliers "
          f"{stats['map_inliers_median']:.0f}, landmarks "
          f"{int(stats['landmarks_final'])}", flush=True)
    return grays, depths, gt, launches, report


@contextlib.contextmanager
def recorded_archive():
    """Wraps ``MapArchive.absorb`` and ``global_bundle_adjust`` for the
    ``with`` block: every absorb is timed (between two synchronisations) and
    its host syncs counted, and the archive and the last absorbed state's
    ``n_kf`` are remembered. Inside ``global_bundle_adjust`` every windowed
    solve is recorded, replayed (``compiled.WindowGraphs.solve``: the copy
    of the window's arrays into the runner's buffers, the replay, the copy
    out; on the first window the capture too) or eager (``gauss_newton_mm``
    with its stop read on the host, after the window's upload): its path,
    free keyframes and observations, the ms of host work since the solve
    before it (the window's assembly, and the upload on the eager path)
    and of the solve to its last kernel, and whether any free keyframe
    moved."""
    from putslam_tpu_torch.backend import optimize as opt_mod
    from putslam_tpu_torch.models import compiled
    from putslam_tpu_torch.slam_map import archive as archive_mod
    from putslam_tpu_torch.utils import control

    rec = {"absorbs": [], "windows": [], "archive": None, "n_kf": None,
           "gba_s": 0.0}
    real_absorb = archive_mod.MapArchive.absorb
    real_gba = archive_mod.global_bundle_adjust
    real_solve = opt_mod.gauss_newton_mm
    real_window = compiled.WindowGraphs.solve
    mark = [0.0]

    def record(path, call, kf_of, kf_sub, kf_valid, g, frozen,
               capture=False):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        free = (kf_valid & ~frozen).cpu()
        rec["windows"].append(dict(
            path=path, capture=capture, n_free=int(free.sum()),
            n_obs=int(g.n_obs), assemble_ms=1e3 * (t1 - mark[0]),
            solve_ms=1e3 * (t2 - t1),
            moved=not torch.equal(kf_of(res).cpu()[free],
                                  kf_sub.cpu()[free])))
        mark[0] = time.perf_counter()
        return res

    def solve(bcfg, kf_pose, kf_valid, lm_pos, lm_valid, g, fixed, *rest,
              **kw):
        def call():
            return real_solve(bcfg, kf_pose, kf_valid, lm_pos, lm_valid, g,
                              fixed, *rest, **kw)
        if control.mode() != "host":       # a runner's warm-up or capture
            return call()
        return record("eager", call, lambda r: r.kf_pose, kf_pose, kf_valid,
                      g, fixed)

    def window(self, kf_sub, kf_valid, lm_sub, lm_valid, g, frozen):
        return record("graph", lambda: real_window(
            self, kf_sub, kf_valid, lm_sub, lm_valid, g, frozen),
            lambda r: r[0], kf_sub, kf_valid, g, frozen,
            capture=self.segment.graph is None)

    def absorb(self, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n_sync = count_syncs(lambda: real_absorb(self, state))
        rec["absorbs"].append((1e3 * (time.perf_counter() - t0), n_sync))
        rec["archive"], rec["n_kf"] = self, int(state.map.n_kf)

    def gba(cfg, archive, **kw):
        t0 = mark[0] = time.perf_counter()
        opt_mod.gauss_newton_mm = solve
        compiled.WindowGraphs.solve = window
        try:
            out = real_gba(cfg, archive, **kw)
        finally:
            opt_mod.gauss_newton_mm = real_solve
            compiled.WindowGraphs.solve = real_window
            rec["gba_s"] += time.perf_counter() - t0
        return out

    archive_mod.MapArchive.absorb = absorb
    archive_mod.global_bundle_adjust = gba
    try:
        yield rec
    finally:
        archive_mod.MapArchive.absorb = real_absorb
        archive_mod.global_bundle_adjust = real_gba


def check_archive(rec, what):
    """Every keyframe made is archived and every archived edge points at an
    archived vertex. Returns the dense arrays."""
    archive = rec["archive"]
    check(archive is not None and rec["absorbs"], f"{what}: no absorb ran")
    check(archive.n_keyframes() == rec["n_kf"],
          f"{what}: {archive.n_keyframes()} keyframes archived, n_kf "
          f"{rec['n_kf']}")
    kf, lm, (obs_kf, obs_lm, *_), (pp_i, pp_j, *_) = archive.dense()
    check(len(obs_kf) > 0 and obs_kf.min() >= 0 and obs_kf.max() < len(kf)
          and obs_lm.min() >= 0 and obs_lm.max() < len(lm),
          f"{what}: an archived observation points outside the archive")
    check(len(pp_i) == 0 or (min(pp_i.min(), pp_j.min()) >= 0
                             and max(pp_i.max(), pp_j.max()) < len(kf)),
          f"{what}: an archived pose-pose edge points outside the archive")
    return kf, lm, obs_kf, pp_i


def print_archive(tag, rec, dense):
    kf, lm, obs_kf, pp_i = dense
    ms = sorted(a[0] for a in rec["absorbs"])
    syncs = sorted({a[1] for a in rec["absorbs"]})
    win = rec["windows"]
    stalled = sum(not w["moved"] and w["n_free"] > 0 for w in win)
    print(f"[14] {tag}: archive {len(kf)} keyframes, {len(lm)} landmarks, "
          f"{len(obs_kf)} observations, {len(pp_i)} pose-pose edges; "
          f"{len(ms)} absorbs, {ms[0]:.2f} / {ms[len(ms) // 2]:.2f} / "
          f"{ms[-1]:.2f} ms (min / median / max), host syncs per absorb "
          f"{syncs}; global BA {rec['gba_s']:.3f} s, {len(win)} windows: "
          + "; ".join(f"window {i}: {w['n_free']} free, {w['n_obs']} "
                      f"observations, assembly {w['assemble_ms']:.1f} ms, "
                      f"{w['path']} solve {w['solve_ms']:.1f} ms"
                      f"{' (capture included)' if w['capture'] else ''}, "
                      f"{'moved' if w['moved'] else 'moved no keyframe'}"
                      for i, w in enumerate(win))
          + f"; windows with free keyframes that moved none: {stalled} of "
          f"{len(win)}",
          flush=True)


def compare_window_solves(cfg, dev, archive):
    """The global BA of ``archive`` at the defaults eagerly and replayed
    (the runner already captured), per window the assembly ms and both
    solves' ms. Returns the largest difference of the polished keyframes."""
    import numpy as np

    from putslam_tpu_torch.models import compiled
    from putslam_tpu_torch.slam_map import archive as archive_mod

    out = {}
    with recorded_archive() as rec:
        for mode in ("eager", "graph", "graph again"):
            t0 = time.perf_counter()
            out[mode] = archive_mod.global_bundle_adjust(
                cfg, archive, device=dev, graph=mode != "eager")
            out[mode + " s"] = time.perf_counter() - t0
    n = len(rec["windows"]) // 3
    eager, graph = rec["windows"][:n], rec["windows"][2 * n:]
    check(n > 0 and all(w["path"] == "eager" for w in eager)
          and all(w["path"] == "graph" and not w["capture"] for w in graph),
          "global BA: windows not recorded as eager, then replayed")
    d = float(np.abs(out["graph"] - out["eager"]).max())
    d2 = float(np.abs(out["graph again"] - out["graph"]).max())
    runner = [r for k, r in compiled._END_RUNNERS.items()
              if k[0] == "window"][-1]
    print(f"[14] the global BA's window solves, eager against replayed "
          f"(capture {runner.capture_s:.3f} s, graph pools "
          f"{runner.pool_mib():.1f} MiB): eager {out['eager s']:.3f} s, "
          f"graph {out['graph s']:.3f} s, again {out['graph again s']:.3f} s;"
          f" polished keyframes graph against eager {d:.2e}, graph twice "
          f"{d2:.2e}; " + "; ".join(
              f"window {i}: {e['n_free']} free, assembly "
              f"{g['assemble_ms']:.1f} ms, solve eager {e['solve_ms']:.1f} "
              f"ms (after {e['assemble_ms']:.1f} ms of assembly and upload),"
              f" graph {g['solve_ms']:.1f} ms"
              for i, (e, g) in enumerate(zip(eager, graph))), flush=True)
    check(d < FINALIZE_DIST_TOL, f"global BA: replayed window solves {d:.2e} "
          f"from eager")
    return d


def phase_archive(cfg, dev, root, grays, depths, gt, ref_report):
    """Phase 14. ``root``: phase 13's sequence on disk; ``grays``,
    ``depths``, ``gt``: the same frames as rendered; ``ref_report``: phase
    13's CLI report. Returns the kernel launches of the two runs."""
    from putslam_tpu_torch import run as run_mod
    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.models import slam
    from putslam_tpu_torch.ops import fast_cuda

    n = FILE_FRAMES
    with recorded_archive() as rec:
        extras = {}
        torch.cuda.synchronize()
        fast_cuda.fast_score_nms.launches = 0
        report = run_cli(run_mod, ["--dataset", root, "--global-ba"],
                         FIVE_FILES, extras)
        launches = fast_cuda.fast_score_nms.launches
    n_det = frames_processed(n, 64)
    check(launches == n_det,
          f"--global-ba: kernel launches {launches} != {n_det}")
    dense = check_archive(rec, "--global-ba")
    before, after = report["ate_before_final_m"], report["ate_rmse_m"]
    check(after == after and before == before, "--global-ba: ATE not finite")
    check(after <= GBA_ATE_FACTOR * before + GBA_ATE_SLACK,
          f"--global-ba: polished ATE {after} against {before} unpolished")
    check(after < ATE_GATE_M, f"--global-ba final ATE {after} over the gate")
    slam_s = extras["stages"]["slam_total"]
    print(f"[14] run --dataset --global-ba: {report}; {n / slam_s:.2f} SLAM "
          f"frames/s with the absorbs and the global BA (phase 13's "
          f"run_slam_final: {ref_report['fps']}); launches {launches}; ATE "
          f"unpolished {before:.5f} m, polished {after:.5f} m (phase 13's "
          f"ring-bounded final optimisation: "
          f"{ref_report['ate_rmse_m']:.5f} m)", flush=True)
    print_archive(f"{n} frames, chunks of 64, the covisibility rule's own "
                  "keyframes", rec, dense)
    compare_window_solves(cfg, dev, rec["archive"])

    # a keyframe ring that wraps: every tracked frame a keyframe, 32 slots,
    # chunks short enough that no chunk appends more than the ring holds
    wcfg = cfg.replace(map=dataclasses.replace(
        cfg.map, max_keyframes=WRAP_RING, min_keyframe_matches=10_000))
    w = WRAP_FRAMES
    with recorded_archive() as rec:
        (pb, pa, outs, state, _), dt, n_launch = timed(
            lambda: slam.run_slam_global(
                wcfg, grays[:w], depths[:w], init_pose=gt[0],
                chunk_size=WRAP_CHUNK, device=dev), fast_cuda.fast_score_nms)
    w_det = frames_processed(w, WRAP_CHUNK)
    check(n_launch == w_det,
          f"wrapped ring: kernel launches {n_launch} != {w_det}")
    dense = check_archive(rec, "wrapped ring")
    n_kf = int(state.map.n_kf)
    check(n_kf > WRAP_RING and len(dense[0]) == n_kf,
          f"wrapped ring: n_kf {n_kf}, archived {len(dense[0])}, ring "
          f"{WRAP_RING}")
    check(int(state.map.kf_valid.sum()) <= WRAP_RING, "ring over capacity")
    check(bool(torch.isfinite(torch.as_tensor(pa)).all()),
          "wrapped ring: polished trajectory not finite")
    ate_b = ate_mod.ate_rmse_aligned_frames(gt[:w], pb)
    ate_a = ate_mod.ate_rmse_aligned_frames(gt[:w], pa)
    check(ate_a <= GBA_ATE_FACTOR * ate_b + GBA_ATE_SLACK,
          f"wrapped ring: polished ATE {ate_a} against {ate_b} unpolished")
    print(f"[14] {w} frames keyframe-dense on a {WRAP_RING}-slot ring, "
          f"chunks of {WRAP_CHUNK}: {dt:.3f} s, {w / dt:.2f} frames/s with "
          f"absorbs and global BA; launches {n_launch}; n_kf {n_kf}, "
          f"{int(state.map.kf_valid.sum())} in the ring, "
          f"{len(dense[0])} archived; BA calls {int(outs.ba_ran.sum())}; ATE "
          f"unpolished {ate_b:.5f} m, polished {ate_a:.5f} m", flush=True)
    print_archive("wrapped ring", rec, dense)
    return launches, n_launch


def phase_state_tools(cfg, dev, grays, depths, gt, dense_state, dense_poses,
                      tmp):
    """Phase 15. ``grays``, ``depths``, ``gt``: the bench orbit;
    ``dense_state``, ``dense_poses``: phase 5b's final state and its
    trajectory as the loop emitted it; ``tmp``: a directory for the
    files. Returns the kernel launches of the checkpointed run and of the
    playback."""
    import numpy as np

    from putslam_tpu_torch.io import g2o
    from putslam_tpu_torch.models import slam
    from putslam_tpu_torch.ops import fast_cuda
    from putslam_tpu_torch.utils import checkpoint
    from putslam_tpu_torch.utils.checkpoint import _leaves

    n, k = grays.shape[0], CHECKPOINT_FRAME
    counter = fast_cuda.fast_score_nms

    # ---- checkpoint and resume. The RANSAC draws come from a
    # torch.Generator that lives outside the state: its get_state() is
    # carried beside the checkpoint and set on the resuming generator
    def start():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return slam.slam_init(cfg, grays[0], depths[0],
                              torch.as_tensor(gt[0], device=dev),
                              device=dev), gen

    torch.cuda.synchronize()
    counter.launches = 0
    state, gen = start()
    state, _ = slam.slam_sequence(cfg, state, grays[1:k + 1], depths[1:k + 1],
                                  generator=gen)
    path = os.path.join(tmp, "frame32.npz")
    t0 = time.perf_counter()
    checkpoint.save_state(path, state)
    t_save = time.perf_counter() - t0
    gen_state = gen.get_state()
    full_state, full_outs = slam.slam_sequence(
        cfg, state, grays[k + 1:], depths[k + 1:], generator=gen)
    n_ckpt = counter.launches
    check(n_ckpt == n, f"checkpointed run: kernel launches {n_ckpt} != {n}")
    fresh, gen2 = start()
    t0 = time.perf_counter()
    resumed = checkpoint.load_state(path, fresh)
    t_load = time.perf_counter() - t0
    check(all(v.device == fresh.pose.device for _, v in _leaves(resumed)),
          "loaded state not on the card")
    gen2.set_state(gen_state)
    res_state, res_outs = slam.slam_sequence(
        cfg, resumed, grays[k + 1:], depths[k + 1:], generator=gen2)
    for (name, a), (_, b) in zip(
            list(_leaves(res_outs)) + list(_leaves(res_state)),
            list(_leaves(full_outs)) + list(_leaves(full_state))):
        check(torch.equal(a, b), f"resumed run differs from the "
              f"uninterrupted one in {name} by "
              f"{float((a.double() - b.double()).abs().max()):.3e}")
    print(f"[15] checkpoint after frame {k} ({os.path.getsize(path) / 1e6:.2f}"
          f" MB, saved in {1e3 * t_save:.0f} ms, loaded in "
          f"{1e3 * t_load:.0f} ms), resumed into a fresh slam_init state with "
          f"the generator's state set: frames {k + 1}..{n - 1} and the final "
          f"state equal the uninterrupted run's exactly ({len(list(_leaves(res_state)))} "
          f"state leaves, {len(list(_leaves(res_outs)))} outputs); launches "
          f"{n_ckpt}", flush=True)

    # ---- playback with the true poses. At fr1 the orbit makes no keyframe
    # by the covisibility rule, so every tracked frame is made one: the map
    # and the keyframe ring then grow under the given trajectory
    pcfg = cfg.replace(map=dataclasses.replace(cfg.map,
                                               min_keyframe_matches=10_000))
    (est, outs, pstate), dt, n_play = timed(
        lambda: slam.run_playback(pcfg, grays, depths, gt, device=dev),
        counter)
    check(n_play == n, f"playback: kernel launches {n_play} != {n}")
    check(est.shape == (n, 7) and np.isfinite(est).all(),
          "playback: trajectory not finite / wrong shape")
    check(np.array_equal(est[0], gt[0]), "playback: first pose not the given")
    off_all = np.linalg.norm(est[:, :3] - gt[:, :3], axis=1)
    off, off_med = float(off_all.max()), float(np.median(off_all))
    plain_all = np.linalg.norm(dense_poses[:, :3] - gt[:, :3], axis=1)
    check(off_med < PLAYBACK_MEDIAN_TOL_M and off < PLAYBACK_MAX_TOL_M,
          f"playback poses {off_med:.4f} m (median) and {off:.4f} m (max) "
          f"from the given ones, over {PLAYBACK_MEDIAN_TOL_M} / "
          f"{PLAYBACK_MAX_TOL_M} m")
    check(bool(outs.vo_ok.all()), "playback reported a VO failure")
    n_kf, lm0, lm1 = int(pstate.map.n_kf), int(outs.n_landmarks[0]), int(
        outs.n_landmarks[-1])
    check(n_kf > n // 2 and lm1 > lm0 > 0,
          f"playback: n_kf {n_kf}, landmarks {lm0} -> {lm1}")
    print(f"[15] run_playback, {n}-frame orbit, keyframe-dense: {dt:.3f} s, "
          f"{n / dt:.2f} frames/s; launches {n_play}; n_kf {n_kf}, BA calls "
          f"{int(outs.ba_ran.sum())}, landmarks {lm0} -> {lm1}, map ok on "
          f"{int(outs.map_ok.sum())} of {n - 1}; emitted poses within "
          f"{1e3 * off:.2f} mm of the given ones (median "
          f"{1e3 * off_med:.2f} mm: the map RANSAC's correction and the BA's "
          f"re-anchoring; the plain run of phase 5b: median "
          f"{1e3 * float(np.median(plain_all)):.2f} mm, max "
          f"{1e3 * float(plain_all.max()):.2f} mm)", flush=True)

    # the same with every map correction refused and no BA: the prediction
    # is the given pose and nothing moves it
    xcfg = pcfg.replace(
        max_map_correction=0.0, map_correction_growth=0.0,
        backend=dataclasses.replace(pcfg.backend,
                                    optimize_every_n_frames=10_000))
    (est_x, outs_x, xstate), dt_x, n_play_x = timed(
        lambda: slam.run_playback(xcfg, grays, depths, gt, device=dev),
        counter)
    check(n_play_x == n, f"playback: kernel launches {n_play_x} != {n}")
    err_x = float(np.abs(est_x - gt).max())
    check(est_x.shape == (n, 7) and err_x < PLAYBACK_EXACT_TOL,
          f"playback without corrections: emitted poses differ from the "
          f"given ones by {err_x:.3e}")
    check(not outs_x.map_ok.any() and not outs_x.ba_ran.any(),
          "playback without corrections: a correction or a BA ran")
    n_kf_x, lmx0, lmx1 = int(xstate.map.n_kf), int(outs_x.n_landmarks[0]), \
        int(outs_x.n_landmarks[-1])
    check(n_kf_x == n and lmx1 > lmx0 > 0,
          f"playback without corrections: n_kf {n_kf_x}, landmarks {lmx0} "
          f"-> {lmx1}")
    print(f"[15] run_playback with every map correction refused and no BA: "
          f"{n / dt_x:.2f} frames/s; launches {n_play_x}; n_kf {n_kf_x}, "
          f"landmarks {lmx0} -> {lmx1}; emitted poses equal the given ones "
          f"to {err_x:.1e} (all seven components; tolerance "
          f"{PLAYBACK_EXACT_TOL})", flush=True)

    # ---- g2o export -> import of the keyframe-dense final graph
    m, g = dense_state.map, dense_state.graph
    path = os.path.join(tmp, "graph.g2o")
    t0 = time.perf_counter()
    g2o.export_graph(path, m.kf_pose, m.kf_valid, m.lm_pos, m.lm_valid, g,
                     lm_gen=m.lm_gen)
    t_exp = time.perf_counter() - t0
    t0 = time.perf_counter()
    kf2, kfv2, lm2, lmv2, g2, fixed2 = g2o.import_graph(
        path, m.kf_pose.shape[0], m.lm_pos.shape[0], g.obs_capacity,
        g.pp_capacity, device=dev)
    torch.cuda.synchronize()
    t_imp = time.perf_counter() - t0
    check(torch.equal(kfv2, m.kf_valid) and torch.equal(lmv2, m.lm_valid),
          "g2o: vertex masks differ")
    check(torch.equal(kf2[m.kf_valid], m.kf_pose[m.kf_valid])
          and torch.equal(lm2[m.lm_valid], m.lm_pos[m.lm_valid]),
          "g2o: a vertex did not come back as written")
    live = (g.obs_valid & (g.obs_gen == m.lm_gen[g.obs_lm.long()])
            & m.kf_valid[g.obs_kf.long()] & m.lm_valid[g.obs_lm.long()])
    n_obs, n_pp = int(live.sum()), int(g.pp_valid.sum())
    check(int(g2.n_obs) == n_obs and int(g2.n_pp) == n_pp and n_obs > 0,
          f"g2o: {int(g2.n_obs)} observations and {int(g2.n_pp)} pose-pose "
          f"edges read, {n_obs} and {n_pp} written")
    check(torch.equal(g2.obs_kf[:n_obs], g.obs_kf[live])
          and torch.equal(g2.obs_lm[:n_obs], g.obs_lm[live])
          and torch.equal(g2.obs_xyz[:n_obs], g.obs_xyz[live])
          and torch.equal(g2.pp_i[:n_pp], g.pp_i[g.pp_valid])
          and torch.equal(g2.pp_j[:n_pp], g.pp_j[g.pp_valid])
          and torch.equal(g2.pp_rel[:n_pp], g.pp_rel[g.pp_valid]),
          "g2o: an edge did not come back as written")
    # information values are written with 6 significant digits
    w_err = float(((g2.obs_w[:n_obs] - g.obs_w[live]).abs()
                   / g.obs_w[live]).max())
    check(w_err < 1e-5 and torch.allclose(g2.pp_w[:n_pp], g.pp_w[g.pp_valid],
                                          rtol=1e-5),
          f"g2o: weights off by {w_err:.2e} relative")
    check(bool(fixed2[int(torch.nonzero(m.kf_valid)[0])]),
          "g2o: the first keyframe is not fixed")
    print(f"[15] g2o export -> import of phase 5b's final graph: "
          f"{int(m.kf_valid.sum())} keyframes, {int(m.lm_valid.sum())} "
          f"landmarks, {n_obs} observations, {n_pp} pose-pose edges "
          f"({os.path.getsize(path) / 1e6:.2f} MB; written in {t_exp:.2f} s, "
          f"read in {t_imp:.2f} s): vertices, edges and measurements equal, "
          f"weights within {w_err:.1e} relative (6 significant digits)",
          flush=True)
    return n_ckpt, n_play


def spawn_ranks(world, extra, work, device):
    """``world`` ranks of tools/multihost_dryrun_torch.py on ``device``
    over gloo (a ``file://`` rendezvous under ``work``), each under
    ``RANK_TIMEOUT_S``: their JSON lines. A rank that fails or outlives the
    limit fails the phase; every process is gone when this returns."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "multihost_dryrun_torch.py")
    rdv = os.path.join(work, f"rdv_gloo{world}")
    cmd = [sys.executable, tool, "--coordinator", f"file://{rdv}",
           "--num-processes", str(world), "--device", device, "--backend",
           "gloo", "--timeout", str(RANK_TIMEOUT_S // 2), *extra]
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            check(p.returncode == 0, f"rank {r} of {world} failed "
                  f"(exit {p.returncode}):\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@contextlib.contextmanager
def counting_indefinite(opt_mod, sink):
    """Inside the block every reduced solve appends to ``sink`` whether the
    gauge-fixed, damped system failed its float32 Cholesky (indefinite: the
    step is zero, ROADMAP 3ac). One factorisation and one sync a solve."""
    real = opt_mod._solve_reduced

    def solve(S, b_red, dead, lam):
        _, info = torch.linalg.cholesky_ex(opt_mod._gauge_fixed(S, dead, lam))
        sink.append(int(info) != 0)
        return real(S, b_red, dead, lam)

    opt_mod._solve_reduced = solve
    try:
        yield
    finally:
        opt_mod._solve_reduced = real


def multi_session_case(tag, what, cfg, walks, h_grays, h_depths, h_gt, mesh,
                       counter, seeds=(0, 1)):
    """Phase 16 (e): one SLAM session per walk (indices into phase 13's
    sequence), merged, cross-session closures found, ``joint_optimize``d
    over ``mesh``. At least one closure and a finite solve are required;
    the chi2 gate holds up to ``DEFINITE_FREE_MAX`` free keyframes, beyond
    which the bf16-rounded system may be indefinite (3ac): then it is
    printed with its count of indefinite iterations and not gated. Returns
    the kernel launches of the sessions."""
    import numpy as np

    from putslam_tpu_torch.backend import optimize as opt_mod
    from putslam_tpu_torch.models import slam
    from putslam_tpu_torch.parallel import dist_ba, multi_session

    dev = h_grays.device
    states, n_multi, t_sessions = [], 0, 0.0
    for b, idx in enumerate(walks):
        (_, _, st), dt_b, n_b = timed(
            lambda: slam.run_slam(cfg, h_grays[idx.to(dev)],
                                  h_depths[idx.to(dev)],
                                  init_pose=h_gt[int(idx[0])],
                                  seed=seeds[b],
                                  device=dev), counter)
        check(n_b == len(idx), f"({tag}) session {b}: kernel launches {n_b} "
              f"!= {len(idx)}")
        states.append(st)
        n_multi += n_b
        t_sessions += dt_b
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    merged = multi_session.merge_sessions(cfg, states)
    g_j, n_edges = multi_session.find_cross_session_closures(
        cfg, merged, states, generator=gen)
    torch.cuda.synchronize()
    t_lc = time.perf_counter() - t0
    overflow = dist_ba.partition_overflow(g_j, mesh.size,
                                          merged.lm_pos.shape[0])
    indefinite = []
    t0 = time.perf_counter()
    with counting_indefinite(opt_mod, indefinite):
        kf_j, _, chi_j = multi_session.joint_optimize(cfg, mesh, merged, g_j,
                                                      n_edges)
    torch.cuda.synchronize()
    t_joint = time.perf_counter() - t0
    chi = chi_j.cpu().numpy()
    n_free = int((merged.kf_valid
                  & ~multi_session.joint_fixed(merged, n_edges)).sum())
    gated = n_free <= DEFINITE_FREE_MAX
    print(f"[16{tag}] 2 sessions of phase 13's handheld sequence, {what}, "
          f"with loop closure ({t_sessions:.2f} s, launches {n_multi}; "
          f"keyframes "
          + " + ".join(str(int(s.map.kf_valid.sum())) for s in states)
          + f"): merged and {n_edges} cross-session closures accepted in "
          f"{t_lc:.3f} s; joint_optimize over world 1 ({n_free} free "
          f"keyframes, K={merged.kf_pose.shape[0]}, "
          f"L={merged.lm_pos.shape[0]}): {t_joint:.3f} s with the count's "
          f"syncs, indefinite in {sum(indefinite)} of {len(indefinite)} "
          f"iterations, owner-partition overflow {overflow}, chi2 "
          + " -> ".join(f"{x:.6g}" for x in chi)
          + (f" (gate: not above {JOINT_CHI2_FACTOR} x the first)" if gated
             else f" (not gated: more than {DEFINITE_FREE_MAX} free)"),
          flush=True)
    check(n_edges >= 1, f"({tag}) no cross-session closure accepted")
    check(np.isfinite(chi).all() and bool(torch.isfinite(kf_j).all()),
          f"({tag}) joint BA not finite")
    check(not gated or chi[-1] <= JOINT_CHI2_FACTOR * chi[0],
          f"({tag}) joint BA chi2 {chi[0]:.6g} -> {chi[-1]:.6g}")
    return n_multi


def phase_distributed(cfg, dev, dense_state, window_fixed, root, h_gt, work):
    """Phase 16. ``dense_state``: phase 5b's final state and
    ``window_fixed`` phase 8's mask (16 free keyframes); ``root``: phase
    13's handheld sequence on disk, read back as ``run --dataset`` reads it
    (PNG-quantised: the covisibility rule makes its keyframes on these
    frames, 18 in 128, and 6 on the float frames as rendered), ``h_gt`` its
    poses; ``work``: a directory for files. Returns the kernel launches of
    the session VO and of the multi-session SLAM runs, and (c)'s handheld
    state with the outputs of its run."""
    import numpy as np

    from putslam_tpu_torch.backend import optimize as opt_mod
    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.io import synthetic, tum
    from putslam_tpu_torch.models import slam
    from putslam_tpu_torch.ops import fast_cuda
    from putslam_tpu_torch.parallel import dist_ba, mesh as mesh_mod
    from putslam_tpu_torch.parallel import multihost
    from putslam_tpu_torch.slam_map.archive import (MapArchive,
                                                    global_bundle_adjust)

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import multihost_dryrun_torch as dryrun

    counter = fast_cuda.fast_score_nms
    t_phase = time.perf_counter()
    played = list(tum.TumDataset(root, depth_scale=cfg.camera.depth_image_scale))
    h_grays = torch.as_tensor(np.stack([f.gray for f in played]), device=dev)
    h_depths = torch.as_tensor(np.stack([f.depth for f in played]),
                               device=dev)
    del played
    # one process, one rank: the NCCL group of world size 1 (NCCL refuses
    # two ranks on one card; initialize_distributed is a no-op for one
    # process, as in the JAX package, so the group is joined here)
    backend = multihost.join_group(
        "file://" + os.path.join(work, "rdv_world1"), 1, 0, device=dev)
    try:
        mesh = multihost.global_mesh(axis_name="lm", device=dev)
        check(mesh.size == 1 and mesh.group is not None,
              f"world-1 mesh: {mesh}")

        # ---- (a) dist_gauss_newton against gauss_newton_mm, world 1 ------
        m2, g2 = dense_state.map, dense_state.graph
        bcfg = dataclasses.replace(cfg.backend, gn_iterations=6,
                                   robust_kernel="none", ba_window=0,
                                   chi2_ratio_termination=0.0)
        args = (m2.kf_pose, m2.kf_valid, m2.lm_pos, m2.lm_valid, g2,
                window_fixed)

        def dist_call():
            return dist_ba.dist_gauss_newton(bcfg, mesh, *args, m2.lm_gen,
                                             m2.kf_gen, cam=cfg.camera)

        def mm_call():
            return opt_mod.gauss_newton_mm(bcfg, *args, lm_gen=m2.lm_gen,
                                           kf_gen=m2.kf_gen, cam=cfg.camera)

        kf_d, lm_d, chi_d, ovf = dist_call()
        ref = mm_call()
        n_free = int((m2.kf_valid & ~window_fixed).sum())
        d_pose = float((kf_d - ref.kf_pose)[m2.kf_valid].abs().max())
        d_lm = float((lm_d - ref.lm_pos)[m2.lm_valid].abs().max())
        check(int(ovf) == 0, f"(a) owner partition dropped {int(ovf)}")
        check(bool(torch.isfinite(chi_d).all()), "(a) chi2 not finite")
        check(d_pose < SOLVER_POSE_TOL, f"(a) dist BA poses {d_pose:.2e} "
              f"from gauss_newton_mm's ({n_free} free keyframes)")
        ms_dist = median_ms(dist_call, runs=5)
        ms_mm = median_ms(mm_call, runs=5)
        n0, b0 = mesh.n_all_reduce, mesh.all_reduce_bytes
        mesh.timed = True
        dist_call()
        mesh.timed = False
        it = bcfg.gn_iterations
        ar_bytes = (mesh.all_reduce_bytes - b0 - 4 * lm_d.numel()) / it
        ar_ms = 1e3 * mesh.all_reduce_s / (mesh.n_all_reduce - n0)
        K = m2.kf_pose.shape[0]
        check(ar_bytes == 4 * (36 * K * K + 6 * K + 1),
              f"(a) {ar_bytes} bytes all-reduced an iteration")
        print(f"[16a] dist_gauss_newton, world 1 on {backend} ({mesh}), "
              f"phase 5b's map under phase 8's mask ({n_free} free of "
              f"{int(m2.kf_valid.sum())} keyframes, K={K}, "
              f"L={m2.lm_pos.shape[0]}), {it} iterations: poses within "
              f"{d_pose:.2e} and landmarks {d_lm:.2e} of gauss_newton_mm "
              f"(tolerance {SOLVER_POSE_TOL}); chi2 {chi_d[0]:.6g} -> "
              f"{chi_d[-1]:.6g} (mm {ref.chi2[-1]:.6g}); {ms_dist:.3f} ms a "
              f"call against gauss_newton_mm's {ms_mm:.3f} ms (CUDA events); "
              f"all-reduce {ar_bytes:.0f} bytes an iteration, "
              f"{ar_ms:.4f} ms each ({mesh.n_all_reduce - n0} a call, "
              f"synchronised)", flush=True)

        # ---- (c) finalize_dist on phase 13's handheld state ---------------
        arch = MapArchive()
        (_, outs_h, st_h), _, n_h_launch = timed(
            lambda: slam.run_slam(cfg, h_grays, h_depths, init_pose=h_gt[0],
                                  chunk_size=64, device=dev, archive=arch),
            counter)
        check(n_h_launch == frames_processed(len(h_gt), 64),
              f"(c) handheld run: kernel launches {n_h_launch}")
        fin = slam.finalize(cfg, st_h)
        t0 = time.perf_counter()
        fin_d = slam.finalize_dist(cfg, st_h, mesh)
        torch.cuda.synchronize()
        t_fd = time.perf_counter() - t0
        kv = st_h.map.kf_valid
        d_fin = float((fin_d.map.kf_pose - fin.map.kf_pose)[kv].abs().max())
        pose_d = slam.reanchor_trajectory(fin_d, outs_h).cpu().numpy()
        n_h = len(h_gt)
        ate_d = ate_mod.ate_rmse_aligned_frames(h_gt[1:], pose_d[:n_h - 1])
        check(ate_d < ATE_GATE_M, f"(c) finalize_dist ATE {ate_d:.5f} m")
        check(d_fin < FINALIZE_DIST_TOL, f"(c) finalize_dist poses {d_fin:.2e}"
              f" from finalize's")
        print(f"[16c] finalize_dist, world 1 on {backend}, phase 13's handheld "
              f"state ({int(kv.sum())} keyframes in the ring, n_kf "
              f"{int(st_h.map.n_kf)}; launches {n_h_launch}): {t_fd:.3f} s; "
              f"poses within "
              f"{d_fin:.2e} of finalize's (tolerance {FINALIZE_DIST_TOL}); "
              f"final ATE {ate_d:.5f} m (gate {ATE_GATE_M} m)", flush=True)

        # ---- (b) two ranks sharing the card over gloo, and (c) their
        # global BA; the same graph and archive as above ------------------
        problem = os.path.join(work, "dist_problem.npz")
        dryrun.save_problem(problem, bcfg, cfg.camera, *args, m2.lm_gen,
                            m2.kf_gen)
        archive = os.path.join(work, "dist_archive.npz")
        dryrun.save_archive(archive, cfg, arch, {})
        t0 = time.perf_counter()
        ranks = spawn_ranks(2, ["--problem", problem, "--archive", archive,
                                "--repeat", "3", "--out",
                                os.path.join(work, "rank{rank}.npz")], work,
                            str(dev))
        t_spawn = time.perf_counter() - t0
        res = []
        for r in range(2):
            with np.load(os.path.join(work, f"rank{r}.npz")) as f:
                res.append({k: f[k] for k in f.files})
        kv2 = m2.kf_valid.cpu().numpy()
        d_ranks = float(np.abs(res[0]["kf_pose"] - res[1]["kf_pose"]).max())
        d_world1 = float(np.abs(res[0]["kf_pose"]
                                - kf_d.cpu().numpy())[kv2].max())
        check(all(x["global_ranks"] == 2 and x["backend"] == "gloo"
                  for x in ranks), f"(b) ranks: {ranks}")
        check(abs(ranks[0]["chi2_final"] - ranks[1]["chi2_final"])
              <= 1e-6 * abs(ranks[0]["chi2_final"]) and d_ranks <= 1e-6,
              f"(b) the two ranks differ: {d_ranks:.2e}")
        check(d_world1 < SOLVER_POSE_TOL, f"(b) two ranks {d_world1:.2e} from "
              f"world 1")
        gba_single = global_bundle_adjust(cfg, arch, device=dev)
        d_gba = float(np.abs(res[0]["kf_polished"] - gba_single).max())
        d_gba_r = float(np.abs(res[0]["kf_polished"]
                               - res[1]["kf_polished"]).max())
        check(d_gba < FINALIZE_DIST_TOL and d_gba_r <= 1e-6,
              f"(c) global BA over 2 ranks {d_gba:.2e} from the single sweep,"
              f" ranks {d_gba_r:.2e} apart")
        print(f"[16b] dist_gauss_newton on 2 ranks, one card, gloo (not "
              f"scaling; spawned, {t_spawn:.1f} s with start-up): ranks "
              f"{d_ranks:.1e} apart, {d_world1:.2e} from world 1; "
              f"{ranks[0]['ms_per_call']:.3f} / {ranks[1]['ms_per_call']:.3f}"
              f" ms a call (host clock, median of 3); all-reduce "
              f"{ranks[0]['all_reduce_bytes_per_iteration']:.0f} bytes an "
              f"iteration, {ranks[0]['all_reduce_ms_per_call']:.2f} ms a "
              f"call on rank 0 (synchronised)", flush=True)
        print(f"[16c] global_bundle_adjust(mesh=) on the 2 ranks: "
              f"{res[0]['kf_polished'].shape[0]} keyframes, "
              f"{ranks[0]['gba_s']:.3f} s, within {d_gba:.2e} of the single "
              f"sweep (tolerance {FINALIZE_DIST_TOL}), ranks {d_gba_r:.1e} "
              f"apart", flush=True)

        # ---- (d) session-parallel VO --------------------------------------
        tv = DIST_VO_FRAMES
        sess = [synthetic.handheld_trajectory(tv, seed=s, device=dev)
                for s in DIST_SESSION_SEEDS]
        frames = [synthetic.render_sequence(cfg.camera, p) for p in sess]
        smesh = mesh_mod.make_mesh(axis="session", device=dev)
        grays = torch.stack([f[0] for f in frames])
        depths = torch.stack([f[1] for f in frames])
        poses_vo, dt_vo, n_vo = timed(
            lambda: mesh_mod.vo_sessions_sharded(cfg, smesh, grays, depths),
            counter)
        n_sess = len(sess)
        check(tuple(poses_vo.shape) == (n_sess, tv, 7), "(d) poses shape")
        check(n_vo == n_sess * tv // smesh.size,
              f"(d) kernel launches {n_vo} != {n_sess * tv} frames")
        ates_vo = [ate_mod.ate_rmse_aligned_frames(
            sess[b].cpu().numpy(), poses_vo[b].cpu().numpy())
            for b in range(n_sess)]
        check(max(ates_vo) < VO_ATE_GATE_M, f"(d) session VO ATE {ates_vo}")
        print(f"[16d] vo_sessions_sharded, {n_sess} sessions x {tv} frames of "
              f"handheld_trajectory(seed {DIST_SESSION_SEEDS}), world 1: "
              f"{dt_vo:.3f} s, {n_sess * tv / dt_vo:.2f} frames/s; launches "
              f"{n_vo}; ATE " + ", ".join(f"{a:.5f}" for a in ates_vo)
              + f" m (gate {VO_ATE_GATE_M} m)", flush=True)

        # ---- (e) two sessions of one place merged and optimised jointly:
        # the rule's keyframes, then keyframe-dense (e2) ------------------
        lc_cfg = cfg.replace(loop_closure=dataclasses.replace(
            cfg.loop_closure, enabled=True))
        dense_lc = lc_cfg.replace(map=dataclasses.replace(
            lc_cfg.map, min_keyframe_matches=10_000))
        lo, hi = DIST_SESSION_WINDOW
        n_multi = 0
        for tag, c, walks, what, seeds in (
                ("e", lc_cfg, [torch.arange(lo, hi),
                               torch.arange(hi - 1, lo - 1, -1)],
                 f"frames {lo}-{hi - 1} forward and backward, session seeds "
                 f"{DIST_LC_SEEDS}", DIST_LC_SEEDS),
                ("e2", dense_lc, [torch.arange(*w[:2], w[2])
                                  for w in DIST_DENSE_WALKS],
                 "keyframe-dense, frames " + " and ".join(
                     f"{w[0]}-{w[1] - w[2]}" for w in DIST_DENSE_WALKS),
                 (0, 1))):
            n_multi += multi_session_case(tag, what, c, walks, h_grays,
                                          h_depths, h_gt, mesh, counter,
                                          seeds)
    finally:
        multihost.shutdown()
    print(f"[16] wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return n_vo, n_multi, (st_h, outs_h)


def tools_module(name):
    """Import ``tools/<name>.py`` (the directory beside this script)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return __import__(name)


def phase_bench(dev, work, ref_s):
    """Phase 17a: ``bench_torch.main`` with one trial of one rep. ``ref_s``:
    the seconds phase 5 took in this call for its 64 frames. Returns the
    kernel launches of the bench."""
    import bench_torch
    from putslam_tpu_torch.ops import fast_cuda

    torch.cuda.synchronize()
    fast_cuda.fast_score_nms.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        bench_torch.main(reps=1, trials=1, device=dev,
                         detail_path=os.path.join(work, "bench_detail.json"))
    wall = time.perf_counter() - t0
    launches = fast_cuda.fast_score_nms.launches
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(set(line) == {"metric", "value", "unit", "vs_baseline"},
          f"bench line keys {sorted(line)}")
    check(line["metric"] == "slam_frames_per_sec_640x480_1chip"
          and line["unit"] == "frames/s" and line["value"] > 0,
          f"bench line {line}")
    with open(os.path.join(work, "bench_detail.json")) as f:
        detail = json.load(f)
    check(detail["ate_rmse_m"] < ATE_GATE_M,
          f"bench ATE {detail['ate_rmse_m']} m over the gate {ATE_GATE_M} m")
    # slam_init, the warm run and one rep of slam_sequence on frames 1-63,
    # the warm run and one rep of vo_sequence on all 64
    want = 1 + 2 * (N_FRAMES - 1) + 2 * N_FRAMES
    check(launches == want, f"bench launches {launches} != {want}")
    print(f"[17a] bench_torch.main(reps=1, trials=1): {json.dumps(line)}; "
          f"phase 5 in this call {N_FRAMES / ref_s:.2f} frames/s "
          f"(run_slam_final with finalize); detail: slam "
          f"{detail['slam_ms_per_frame']} ms/frame, VO {detail['vo_fps']} "
          f"frames/s, keyframes {detail['n_keyframes']}, BA calls "
          f"{detail['n_ba_calls']}, landmarks {detail['n_landmarks']}, ATE "
          f"{detail['ate_rmse_m']} m (gate {ATE_GATE_M} m), device "
          f"{detail['device']} at {detail['power_limit']}; launches "
          f"{launches}; wall {wall:.1f} s", flush=True)
    return launches


def phase_profile_vo(work):
    """Phase 17b: ``tools/profile_vo_torch.py`` at fr1 over 64 frames.
    Returns (the kernel launches it made, its stages)."""
    from putslam_tpu_torch.ops import fast_cuda

    tool = tools_module("profile_vo_torch")
    out = os.path.join(work, "profile_vo.json")
    torch.cuda.synchronize()
    fast_cuda.fast_score_nms.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(["--frames", str(N_FRAMES), "--device", "cuda",
                        "--runs", str(PROFILE_VO_RUNS), "--json-out", out])
    wall = time.perf_counter() - t0
    launches = fast_cuda.fast_score_nms.launches
    check(rc == 0, f"profile_vo_torch returned {rc}")
    with open(out) as f:
        stages = json.load(f)["stages"]
    check(len(stages) == 5 and all(v["ms_per_call"] > 0
                                   for v in stages.values()),
          f"profile_vo stages {stages}")
    # the detection before the stages, then one warm-up and the timed runs
    # of the three stages that detect (64 frames each)
    want = N_FRAMES * (1 + 3 * (1 + PROFILE_VO_RUNS))
    check(launches == want, f"profile_vo launches {launches} != {want}")
    print("[17b] VO stages at fr1, 64 frames (CUDA events behind a spin "
          f"kernel, median of {PROFILE_VO_RUNS}): " + "; ".join(
              f"{k} {v['ms_per_call']:.2f} ms/call, "
              f"{v['ms_per_frame']:.3f} ms/frame"
              for k, v in stages.items())
          + f"; launches {launches}; wall {wall:.1f} s", flush=True)
    return launches, stages


def phase_planes(cfg, dev, work):
    """Phase 17c: the plane-scene renderer on the card against the port's
    own CPU render, then its sequence written by the disk tool on the card
    and played through ``run --dataset``. Returns the kernel launches of
    the played run."""
    import numpy as np

    from putslam_tpu_torch import run as run_mod
    from putslam_tpu_torch.io import synthetic, synthetic2
    from putslam_tpu_torch.ops import fast_cuda

    poses = synthetic.handheld_trajectory(N_FRAMES, seed=PLANES_SEED,
                                          device=dev)
    synthetic2.render_sequence(cfg.camera, poses[:1])        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grays, depths = synthetic2.render_sequence(cfg.camera, poses)
    torch.cuda.synchronize()
    ms_frame = 1e3 * (time.perf_counter() - t0) / N_FRAMES
    check(grays.shape == (N_FRAMES, cfg.camera.height, cfg.camera.width)
          and grays.device == poses.device, "planes render: shape / device")
    g_cpu, d_cpu = synthetic2.render_frame(cfg.camera, poses[0].cpu())
    dd = float((depths[0].cpu() - d_cpu).abs().max())
    dg = (grays[0].cpu() - g_cpu).abs()
    off = int((dg > PLANES_GRAY_TOL).sum())
    share = 1.0 - off / dg.numel()
    check(dd <= PLANES_DEPTH_TOL, f"planes depth card vs CPU {dd:.2e} m")
    check(share >= PLANES_GRAY_SHARE,
          f"planes gray card vs CPU: {off} pixels over {PLANES_GRAY_TOL}")
    hit = float((depths > 0).float().mean())
    del grays, depths
    tool = tools_module("make_disk_dataset_torch")
    root = os.path.join(work, "planes")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = tool.main(["--frames", str(N_FRAMES), "--seed", str(PLANES_SEED),
                        "--renderer", "planes", "--device", "cuda", "--out",
                        root])
    t_write = time.perf_counter() - t0
    check(rc == 0, f"make_disk_dataset_torch --renderer planes returned {rc}")
    extras = {}
    torch.cuda.synchronize()
    fast_cuda.fast_score_nms.launches = 0
    report = run_cli(run_mod, ["--dataset", root], FIVE_FILES, extras)
    launches = fast_cuda.fast_score_nms.launches
    n_det = frames_processed(N_FRAMES, 64)
    check(launches == n_det, f"planes run launches {launches} != {n_det}")
    ate = report["ate_rmse_m"]
    check(np.isfinite(ate) and np.isfinite(report["ate_before_final_m"]),
          "planes run: ATE not finite")
    stats = extras["stats"]
    print(f"[17c] planes renderer on the card: {ms_frame:.2f} ms a frame "
          f"({N_FRAMES} handheld frames, seed {PLANES_SEED}, float64; "
          f"{100 * hit:.2f} % of the pixels hit a plane); frame 0 against "
          f"the CPU render: depth within {dd:.2e} m, gray within "
          f"{float(dg.max()):.2e} ({off} of {dg.numel()} pixels over "
          f"{PLANES_GRAY_TOL}); written by make_disk_dataset_torch "
          f"--renderer planes --device cuda in {t_write:.1f} s; run "
          f"--dataset: ATE {ate} m (before the final BA "
          f"{report['ate_before_final_m']} m; not gated), keyframes "
          f"{int(stats['keyframes'])}, BA calls {int(stats['ba_runs'])}, "
          f"map ok {stats['map_ok_fraction']:.3f}, {report['fps']} frames/s;"
          f" launches {launches}", flush=True)
    return launches


def phase_acceptance(dev, root, h_gt):
    """Phase 17d: the acceptance operating point's engine half
    (``tools/run_acceptance_torch.py::run_engine``) on phase 13's sequence.
    Returns the kernel launches."""
    import numpy as np

    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.ops import fast_cuda

    tool = tools_module("run_acceptance_torch")
    rev = tools_module("run_reference_eval")
    torch.cuda.synchronize()
    fast_cuda.fast_score_nms.launches = 0
    r = tool.run_engine(root, device=dev)
    launches = fast_cuda.fast_score_nms.launches
    n = FILE_FRAMES
    n_det = frames_processed(n, 64)
    check(r["frames"] == n and launches == n_det,
          f"acceptance engine: {r['frames']} frames, {launches} launches")
    check(np.abs(r["gt"] - h_gt).max() < 1e-5,
          "acceptance engine: ground truth read back differs")
    before = ate_mod.ate_rmse_aligned_frames(r["gt"], r["poses_before"])
    after = ate_mod.ate_rmse_aligned_frames(r["gt"], r["poses_after"])
    check(np.isfinite(r["poses_after"]).all(), "acceptance: not finite")
    check(after < ATE_GATE_M, f"acceptance polished ATE {after:.5f} m over "
          f"the gate {ATE_GATE_M} m")
    check(after <= GBA_ATE_FACTOR * before + GBA_ATE_SLACK,
          f"acceptance polish made it worse: {before:.5f} -> {after:.5f} m")
    scripts = ("present" if os.path.isdir(rev.REF_SCRIPTS)
               else "absent: the reference scoring waits for them")
    print(f"[17d] acceptance operating point (BA every 2 keyframes x 3, "
          f"global BA {tool.GBA}) on phase 13's {n} frames: ATE "
          f"{before:.5f} m before the polish, {after:.5f} m after; keyframes "
          f"{r['archive'].n_keyframes()}, archived observations "
          f"{len(r['archive'].obs)}; engine wall {r['wall_s']:.2f} s "
          f"({r['loader']} loader for the read, not in the wall); launches "
          f"{launches}; the reference's scripts at {rev.REF_SCRIPTS}: "
          f"{scripts}", flush=True)
    return launches


def phase_se2_affine(cfg, dev, grays, feats):
    """Phase 17e: ``se2.optimize_pose_graph`` and
    ``klt.refine_patch_alignment_affine`` on the card against the port's
    CPU results. ``grays``: phase 5's frames; ``feats``: phase 4's
    features of frame 0."""
    import numpy as np

    from putslam_tpu_torch.geometry import se2
    from putslam_tpu_torch.ops import klt

    # the JAX test's noisy square loop (tests/test_round5.py:263-280)
    gt = torch.tensor([[0, 0, 0], [1, 0, np.pi / 2], [1, 1, np.pi],
                       [0, 1, -np.pi / 2]], dtype=torch.float32, device=dev)
    rng = np.random.default_rng(3)
    noise = np.zeros((4, 3), np.float32)
    noise[1:] = rng.normal(0, 0.08, (3, 3)).astype(np.float32)
    ei = torch.tensor([0, 1, 2, 3], device=dev)
    ej = torch.tensor([1, 2, 3, 0], device=dev)
    edges = (ei, ej, se2.relative(gt[ei], gt[ej]),
             torch.full((4,), 100.0, device=dev))
    fixed = torch.tensor([True, False, False, False], device=dev)
    out, chi2 = se2.optimize_pose_graph(gt + torch.as_tensor(noise,
                                                             device=dev),
                                        edges, fixed, iterations=15)
    sq_err = float((out[:, :2] - gt[:, :2]).abs().max())
    check(float(chi2[-1]) < 1e-4 * max(float(chi2[0]), 1e-9) + 1e-8
          and sq_err < 1e-3, f"se2 square: chi2 {chi2.tolist()}, "
          f"positions off by {sq_err:.2e}")
    # a ring of SE2_RING poses, odometry and closures across it
    k = SE2_RING
    ang = torch.linspace(0.0, 2 * np.pi, k + 1, dtype=torch.float64)[:k]
    ring = torch.stack([torch.cos(ang), torch.sin(ang),
                        torch.atan2(torch.cos(ang), -torch.sin(ang))],
                       dim=-1).float()
    ri = torch.cat([torch.arange(k), torch.arange(0, k, 6)])
    rj = torch.cat([(torch.arange(k) + 1) % k,
                    (torch.arange(0, k, 6) + k // 2) % k])
    g = torch.Generator().manual_seed(5)
    init = ring + 0.05 * torch.randn(ring.shape, generator=g)
    init[0] = ring[0]
    rfix = torch.zeros(k, dtype=torch.bool)
    rfix[0] = True
    redges = (ri, rj, se2.relative(ring[ri], ring[rj]),
              torch.full((len(ri),), 50.0))

    def ring_on(d):
        return se2.optimize_pose_graph(
            init.to(d), tuple(e.to(d) for e in redges), rfix.to(d),
            iterations=SE2_ITERS)

    r_cpu, c_cpu = ring_on("cpu")
    r_gpu, c_gpu = ring_on(dev)
    d_ring = float((r_gpu.cpu() - r_cpu).abs().max())
    check(d_ring < SE2_CARD_TOL, f"se2 ring card vs CPU {d_ring:.2e}")
    # its scatters are index_put_(accumulate=True), sort-based on the card
    r_gpu2, c_gpu2 = ring_on(dev)
    check(torch.equal(r_gpu, r_gpu2) and torch.equal(c_gpu, c_gpu2),
          "se2 ring: two runs on the card differ")
    ms_ring = median_ms(lambda: ring_on(dev), runs=5)

    # the affine polish of frame 0's keypoints tracked into frame 1 (the
    # pyramidal KLT's tracks on the card are the initial guesses of both)
    tc = dataclasses.replace(cfg.tracker, win_size=cfg.tracker.patch_refine_win)
    pts = feats.uv[:AFFINE_POINTS]
    tracks = klt.track(cfg.tracker, grays[0], grays[1], pts,
                       feats.valid[:AFFINE_POINTS])

    def affine_on(d):
        return klt.refine_patch_alignment_affine(
            tc, grays[0].to(d), grays[1].to(d), pts.to(d), tracks.pts.to(d),
            tracks.valid.to(d))

    a_cpu = affine_on("cpu")
    a_gpu = affine_on(dev)
    both = (a_gpu.valid.cpu() & a_cpu.valid)
    same_ok = float((a_gpu.valid.cpu() == a_cpu.valid).float().mean())
    dev_pts = (a_gpu.pts.cpu() - a_cpu.pts)[both].abs().amax(-1)
    n_both = int(both.sum())
    agree = float((dev_pts <= AFFINE_CARD_TOL).float().mean()) \
        if n_both else 0.0
    d_pts = float(dev_pts.max()) if n_both else 0.0
    check(n_both >= AFFINE_POINTS // 2,
          f"affine: {n_both} points kept on both devices")
    check(agree >= AFFINE_AGREE_SHARE, f"affine card vs CPU: {agree:.4f} of "
          f"the points within {AFFINE_CARD_TOL} px (max {d_pts:.2e})")
    check(same_ok >= AFFINE_OK_SHARE, f"affine ok flags agree on {same_ok}")
    ms_aff = median_ms(lambda: affine_on(dev), runs=5)
    print(f"[17e] se2 square loop on the card: chi2 {float(chi2[0]):.4g} -> "
          f"{float(chi2[-1]):.3g}, positions within {sq_err:.2e} of the "
          f"truth; {k}-pose ring with {len(ri) - k} closures, "
          f"{SE2_ITERS} iterations: card vs CPU {d_ring:.2e}, two runs "
          f"on the card bit-equal, chi2 "
          f"{float(c_gpu[0]):.4g} -> {float(c_gpu[-1]):.3g}, "
          f"{ms_ring:.2f} ms a call; refine_patch_alignment_affine on "
          f"{len(pts)} keypoints of phase 5's frame 0 tracked into frame 1 "
          f"({int(tracks.valid.sum())} tracks; win {tc.win_size}, "
          f"{tc.max_iter} iterations): {n_both} kept on both devices, "
          f"{agree:.4f} of them within {AFFINE_CARD_TOL} px of the CPU "
          f"(max {d_pts:.2e} px, {int((dev_pts > AFFINE_CARD_TOL).sum())} "
          f"over), ok flags equal on {same_ok:.4f}, {ms_aff:.2f} ms a call",
          flush=True)


def recorded_sums(fn):
    """(plan, rows) of every segment sum that ``fn()`` makes
    (``ops/segment.py::SegmentPlan.sum``), the rows cloned."""
    from putslam_tpu_torch.ops import segment

    rec = []
    real = segment.SegmentPlan.sum

    def sum_(plan, x):
        rec.append((plan, x.detach().clone()))
        return real(plan, x)

    segment.SegmentPlan.sum = sum_
    try:
        fn()
    finally:
        segment.SegmentPlan.sum = real
    return rec


def phase_segment_sum(cases, dev):
    """Phase 5c, the segment-sum kernel (``csrc/segment_sum.cu``): ``cases``
    maps a name to a function whose segment sums are recorded (one
    Gauss-Newton iteration of a real solve). Each recorded sum: the kernel
    against the plain version on a CPU copy of the same inputs, bit for
    bit, and run twice; then, over all sums of a case, the kernel's time
    (CUDA events behind a spin kernel, and its own duration in
    torch.profiler), the plain version's on the card, ``index_add_``'s
    (one call a sum into a zeroed buffer: the library's atomics), the
    plans' build time, and the bound from this input's bytes (each live
    row and its index read once, the offsets read once, the sums written
    once) and adds. Returns by case (launches, max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by, plan_ms, own µs a launch)."""
    from putslam_tpu_torch.ops import segment

    out = {}
    for tag, fn in cases.items():
        rec = recorded_sums(fn)
        check(len(rec) > 0, f"segment sums of {tag}: none recorded")
        max_err, nbytes, adds = 0.0, 0, 0
        for plan, x in rec:
            got = plan.sum(x)
            again = plan.sum(x)
            ref = segment.plain_segment_sum(
                x.cpu(), segment.SegmentPlan(plan.idx.cpu(), plan.n))
            torch.cuda.synchronize()
            check(torch.equal(got.cpu(), ref), f"{tag}: segment sum "
                  f"({plan.rows} rows, n {plan.n}, {tuple(x.shape[1:])}) "
                  f"differs from its plain version")
            check(torch.equal(got, again), f"{tag}: segment sum differs "
                  f"between two launches")
            max_err = max(max_err, float((got.cpu() - ref).abs().max())
                          if ref.numel() else 0.0)
            live = int(plan.offsets[plan.n])
            cols = x[0].numel() if x.shape[0] else 1
            nbytes += (4 * cols + 8) * live + 8 * (plan.n + 1) \
                + 4 * plan.n * cols
            adds += live * cols
        bufs = [torch.zeros((plan.n + 1,) + tuple(x.shape[1:]), device=dev)
                for plan, x in rec]
        plans = list({id(p): p for p, _ in rec}.values())

        def kernel():
            for plan, x in rec:
                plan.sum(x)

        def plain():
            for plan, x in rec:
                segment.plain_segment_sum(x, plan)

        def library():
            for buf, (plan, x) in zip(bufs, rec):
                buf.index_add_(0, plan.idx, x)

        def build_plans():
            for plan in plans:
                segment.SegmentPlan(plan.idx, plan.n)

        ms_plain = median_ms(plain, runs=20)
        ms = [median_ms(kernel, runs=20), median_ms(kernel, runs=20)]
        ms_lib = median_ms(library, runs=20)
        ms_plans = median_ms(build_plans, runs=20)
        us_own = profiler_us(kernel, "segment_sum_kernel")
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * adds / FP32_OPS_PER_S
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        ms_k = 0.5 * (ms[0] + ms[1])
        own = None if us_own is None else us_own / len(rec)
        print(f"[5c] segment sums of {tag}: {len(rec)} launches over "
              f"{len(plans)} plans, bit-equal to the plain version (CPU) "
              f"and twice; {nbytes} bytes = {bytes_ms:.5f} ms at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s, {adds} adds = {ops_ms:.5f} "
              f"ms: bound {bound_ms:.5f} ms by {bound_by}; kernel "
              f"{ms[0]:.5f} / {ms[1]:.5f} ms ({100 * bound_ms / ms_k:.1f} % "
              f"of the bound; own "
              f"{'not measured' if own is None else f'{own:.2f} us'} a "
              f"launch, torch.profiler); plain (zeros + index_add_) "
              f"{ms_plain:.5f} ms; index_add_ alone {ms_lib:.5f} ms; the "
              f"plans (stable sort + searchsorted) {ms_plans:.5f} ms",
              flush=True)
        out[tag] = dict(launches=len(rec), max_abs_err=max_err, ms=ms_k,
                        plain_ms=ms_plain, library_ms=ms_lib,
                        bound_ms=bound_ms, bound_by=bound_by,
                        plan_ms=ms_plans, own_us=own)
    return out


def device_kernels(fn):
    """(kernels, their summed device ms) of one call of ``fn`` as
    torch.profiler (CUPTI) records them, CUDA-graph replays included;
    (None, None) where it recorded none. Copies and fills are not counted
    as kernels; their time is in the sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return None, None
    n = sum(not e.name.startswith(("Memcpy", "Memset")) for e in evs)
    return n, sum(e.time_range.elapsed_us() for e in evs) / 1e3


def top_kernels(fn, k=15):
    """The ``k`` kernels with the most device time in one call of ``fn``
    as torch.profiler (CUPTI) records them: (rows of (name, device ms,
    calls), the device ms of every kernel of the call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    rows = sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                  key=lambda r: -r[1])
    return rows[:k], sum(ms for _, ms, _ in rows)


def phase_compiled(cells, dev):
    """Phase 7b, the compiled step: ``cells`` maps a name to (config,
    grays, depths, truth (T, 7) numpy, ATE gate of the unpolished
    trajectory or None, ATE gate of the finalized one). Each cell runs
    ``slam_sequence`` from one ``slam_init`` state from CUDA graphs and
    eagerly with the same per-frame draws, each mode twice: the four runs
    must end bit-equal. Returns the FAST launches of the graph runs, by
    cell, each cell's (config, final state, outputs, truth, gate) of its
    graph run, and its segment-sum launches a frame by mode."""
    import numpy as np

    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.models import compiled, slam
    from putslam_tpu_torch.ops import fast_cuda, segment
    from putslam_tpu_torch.utils import graph_cond

    def fmt(x, spec):
        return "not measured" if x is None else format(x, spec)

    launches, finals, seg_rows = {}, {}, {}
    for tag, (c, g, d, truth, gate_before, gate) in cells.items():
        n = g.shape[0] - 1
        state0 = slam.slam_init(c, g[0], d[0],
                                torch.as_tensor(truth[0], device=dev))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        draws = [slam.frame_draws(c, gen, dev) for _ in range(n)]
        compiled.clear_cache()
        rows = {}
        for mode in ("graph", "eager"):
            def run(k=n, graph=mode == "graph"):
                return slam.slam_sequence(c, state0, g[1:k + 1], d[1:k + 1],
                                          draws=draws[:k], graph=graph)
            t0 = time.perf_counter()
            nodes = graph_cond.launches
            if mode == "graph":
                run()                   # captures; the eager mode is warm
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            nodes = graph_cond.launches - nodes
            segment.reset_launch_count()
            (st, outs), dt, n_launch = timed(run, fast_cuda.fast_score_nms)
            n_seg = segment.launch_count()
            (_, outs2), n_sync = count_syncs(run)
            kernels, dev_ms = device_kernels(lambda: run(COMPILED_PROFILED))
            poses = np.concatenate([truth[:1], outs.pose.cpu().numpy()])
            fin = slam.finalize(c, st)
            after = np.concatenate([truth[:1], slam.reanchor_trajectory(
                fin, slam._outputs_to_numpy(outs)).cpu().numpy()])
            rows[mode] = r = dict(
                outs=outs, state=st, s=dt, launches=n_launch,
                syncs=n_sync / n, seg=n_seg / n,
                spread=float((outs.pose - outs2.pose).abs().max()),
                ate_b=ate_mod.ate_rmse_aligned_frames(truth, poses),
                ate_f=ate_mod.ate_rmse_aligned_frames(truth, after))
            per = None if kernels is None else kernels / COMPILED_PROFILED
            dev_f = None if dev_ms is None else dev_ms / COMPILED_PROFILED
            busy = None if dev_f is None else dev_f / (1e3 * dt / n)
            extra = ""
            if mode == "graph":
                runner = compiled.slam_runner(c, state0, g.shape[1:])
                pools = [compiled.graph_pool_bytes(p)
                         for p in (runner.pool, runner.body_pool.id)]
                extra = (f"; capturing run {first_s:.3f} s, capture "
                         f"{runner.capture_s:.3f} s, graph pools "
                         f"{fmt(runner.pool_mib(), '.1f')} MiB (the graph's "
                         f"{fmt(pools[0] and pools[0] / 2 ** 20, '.1f')}, "
                         f"its IF bodies' "
                         f"{fmt(pools[1] and pools[1] / 2 ** 20, '.1f')}), "
                         f"IF nodes in the frame graph {nodes}")
                if tag == "bench":
                    top, top_ms = top_kernels(lambda: run(COMPILED_PROFILED))
            print(f"[7b] {tag} {mode}: {n / dt:.2f} frames/s, "
                  f"{1e3 * dt / n:.2f} ms a frame; host syncs a frame {r['syncs']:.2f}; kernels a frame "
                  f"{fmt(per, '.1f')}, device {fmt(dev_f, '.3f')} ms a "
                  f"frame, busy share {fmt(busy, '.3f')} (profiler, frames "
                  f"1-{COMPILED_PROFILED}); FAST launches {n_launch}, "
                  f"segment sums {n_seg} ({n_seg / n:.2f} a frame); "
                  f"keyframes {int(outs.is_keyframe.sum())}, BA calls "
                  f"{int(outs.ba_ran.sum())}; ATE {r['ate_b']:.5f} m, "
                  f"finalized {r['ate_f']:.5f} m{extra}", flush=True)
            check(n_launch == n,
                  f"{tag} {mode}: FAST launches {n_launch} for {n} frames")
            if mode == "graph":
                check(n_sync == 0, f"{tag}: {n_sync} host syncs in the "
                      f"graph path's slam_sequence")
        eager, graph = rows["eager"], rows["graph"]
        dpose = float((eager["outs"].pose - graph["outs"].pose).abs().max())
        ba = graph["outs"].ba_ran.cpu()
        first_ba = int(torch.nonzero(ba)[0]) if bool(ba.any()) else n
        same_before = torch.equal(eager["outs"].pose[:first_ba],
                                  graph["outs"].pose[:first_ba])
        print(f"[7b] {tag}: graph / eager {eager['s'] / graph['s']:.2f}x; "
              f"poses eager against graph {dpose:.3e} "
              f"({'bit-equal' if dpose == 0.0 else 'not bit-equal'}; "
              f"bit-equal before the first BA (frames 1-{first_ba}): "
              f"{same_before}); the same mode twice: eager "
              f"{eager['spread']:.3e}, graph {graph['spread']:.3e}",
              flush=True)
        check(same_before, f"{tag}: graph poses differ from eager before "
              f"the first BA (frame {first_ba + 1})")
        check(torch.equal(eager["outs"].pose, graph["outs"].pose),
              f"{tag}: graph poses not bit-equal to eager ({dpose})")
        for mode in ("eager", "graph"):
            check(rows[mode]["spread"] == 0.0, f"{tag} {mode}: two runs "
                  f"{rows[mode]['spread']} apart")
        if gate_before is not None:
            check(graph["ate_b"] < gate_before, f"{tag}: graph ATE "
                  f"{graph['ate_b']:.5f} m over {gate_before}")
        check(graph["ate_f"] < gate,
              f"{tag}: graph finalized ATE {graph['ate_f']:.5f} m over {gate}")
        if bool(ba.any()):
            check(graph["seg"] > 0 and eager["seg"] > 0,
                  f"{tag}: {graph['seg']} segment sums a frame replayed, "
                  f"{eager['seg']} eager, with {int(ba.sum())} BA calls")
        launches[tag] = graph["launches"]
        seg_rows[tag] = {m: rows[m]["seg"] for m in rows}
        finals[tag] = (c, graph["state"], graph["outs"], truth, gate)
        compiled.clear_cache()
    # what the retry ladder's two widened passes, run on every frame, cost:
    # the bench cell replayed without them (not checked)
    c, g, d, truth = cells["bench"][:4]
    c = c.replace(matcher=dataclasses.replace(c.matcher, retries=0))
    state0 = slam.slam_init(c, g[0], d[0], torch.as_tensor(truth[0],
                                                           device=dev))

    def run(k=g.shape[0] - 1):
        return slam.slam_sequence(c, state0, g[1:k + 1], d[1:k + 1],
                                  generator=torch.Generator(device=dev))
    run()
    _, dt, _ = timed(run, fast_cuda.fast_score_nms)
    kernels, dev_ms = device_kernels(lambda: run(COMPILED_PROFILED))
    n, k = g.shape[0] - 1, COMPILED_PROFILED
    print(f"[7b] bench without the retry ladder (matcher.retries 0), graph: "
          f"{n / dt:.2f} frames/s, {1e3 * dt / n:.2f} ms a frame; kernels a "
          f"frame {fmt(None if kernels is None else kernels / k, '.1f')}, "
          f"device {fmt(None if dev_ms is None else dev_ms / k, '.3f')} ms "
          f"a frame (not checked)", flush=True)
    print(f"[7b] the {len(top)} kernels with the most device time in "
          f"{COMPILED_PROFILED} replayed bench frames (torch.profiler; of "
          f"{top_ms / COMPILED_PROFILED:.3f} device ms a frame):", flush=True)
    for name, ms, calls in top:
        print(f"[7b]   {ms / COMPILED_PROFILED:8.4f} ms "
              f"{100 * ms / top_ms:5.1f} % {calls / COMPILED_PROFILED:6.1f} "
              f"calls a frame  {name[:110]}", flush=True)
    compiled.clear_cache()
    return launches, finals, seg_rows


def skipped_iterations(chi2, ratio):
    """Gauss-Newton iterations each solve of a finalize skipped: the rows
    of ``chi2`` (2, n) as ``gauss_newton_mm`` reports them, its stop rule
    (an iteration that fails to improve chi² by ``ratio`` is the last)
    applied again on the host in float32."""
    import numpy as np

    r = np.float32(ratio)
    out = []
    for row in chi2.cpu().numpy():
        prev, ran = np.float32(np.inf), 0
        for x in row:
            ran += 1
            if x >= r * prev:
                break
            prev = x
        out.append(len(row) - ran)
    return out


def phase_compiled_end(cells, dev):
    """Phase 18, the compiled end of the run: ``cells`` maps a name to
    (config, final state, its run's outputs (frames 1 on), truth (T, 7),
    ATE gate). On each state
    ``finalize`` runs eagerly (``graph=False``: each Gauss-Newton iteration's
    stop read on the host) and replayed from its CUDA graph
    (``compiled.FinalizeGraphs``, captured on the first call): ms of the
    first call and of a warm one, host syncs of a warm call (sync-debug
    count), kernels and device ms (torch.profiler), IF nodes, capture s,
    pools MiB, Gauss-Newton iterations skipped, segment sums; graph
    against eager: the same poses, landmarks kept and observations pruned,
    bit for bit; the finalized ATE of both over frames 1 on (the graph's
    under the gate). Returns the segment sums of a call by cell and mode.
    Then ``check_trajectory`` on
    the card against the CPU on the first cell's polished map with
    odometry edges added and three keyframes moved by 0.5 m."""
    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.geometry import se3
    from putslam_tpu_torch.models import compiled, slam
    from putslam_tpu_torch.ops import segment
    from putslam_tpu_torch.utils import control, graph_cond

    def fmt(x, spec):
        return "not measured" if x is None else format(x, spec)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    compiled.clear_cache()
    seg_rows = {}
    for tag, (c, st, outs, truth, gate) in cells.items():
        kv = st.map.kf_valid
        n_free = int(kv.sum()) - 1
        fins, rows = {}, {}
        for mode in ("eager", "graph"):
            graph = mode == "graph"
            nodes = graph_cond.launches

            def call():
                return slam.finalize(c, st, graph=graph)
            fin, first_ms = wall(call)
            nodes = graph_cond.launches - nodes
            segment.reset_launch_count()
            _, warm_ms = wall(call)
            n_seg = segment.launch_count()
            _, n_sync = count_syncs(call)
            kernels, dev_ms = device_kernels(call)
            if graph:
                runner = compiled.finalize_runner(c, st)
                chi2 = runner.chi2
                pools = [compiled.graph_pool_bytes(p)
                         for p in (runner.pool, runner.body_pool.id)]
                extra = (f"; capture {runner.capture_s:.3f} s, IF nodes "
                         f"{nodes}, graph pools "
                         f"{fmt(runner.pool_mib(), '.1f')} MiB (the graph's "
                         f"{fmt(pools[0] and pools[0] / 2 ** 20, '.1f')}, "
                         f"its IF bodies' "
                         f"{fmt(pools[1] and pools[1] / 2 ** 20, '.1f')})")
            else:
                with control.branching("host"):
                    chi2 = slam.finalize_map(c, st.map, st.graph)[2]
                extra = ""
            skipped = skipped_iterations(chi2,
                                         c.backend.chi2_ratio_termination)
            after = slam.reanchor_trajectory(fin, outs).cpu().numpy()
            ate_f = ate_mod.ate_rmse_aligned_frames(truth[1:],
                                                    after[:len(truth) - 1])
            fins[mode], rows[mode] = fin, dict(warm_ms=warm_ms, ate=ate_f,
                                               seg=n_seg)
            check(n_seg > 0, f"{tag} finalize {mode}: no segment sum")
            busy = None if dev_ms is None else dev_ms / warm_ms
            print(f"[18] {tag} finalize {mode} ({n_free} free keyframes of "
                  f"K={st.map.kf_pose.shape[0]}, {c.backend.solver}): first "
                  f"call {first_ms:.1f} ms, warm {warm_ms:.1f} ms; host syncs "
                  f"{n_sync}; kernels {fmt(kernels, 'd')}, device "
                  f"{fmt(dev_ms, '.2f')} ms, busy share {fmt(busy, '.3f')} "
                  f"(profiler); Gauss-Newton iterations skipped "
                  f"{skipped[0]} + {skipped[1]} of "
                  f"2 x {c.backend.final_gn_iterations}; segment sums "
                  f"{n_seg}; finalized ATE "
                  f"{ate_f:.5f} m{extra}", flush=True)
            if graph:
                check(n_sync == 0, f"{tag}: {n_sync} host syncs in the "
                      f"replayed finalize")
                check(ate_f < gate, f"{tag}: graph finalized ATE "
                      f"{ate_f:.5f} m over {gate}")
        e, g = fins["eager"], fins["graph"]
        dpose = float((g.map.kf_pose - e.map.kf_pose)[kv].abs().max())
        same_masks = (torch.equal(g.map.lm_valid, e.map.lm_valid),
                      int((g.graph.obs_valid != e.graph.obs_valid).sum()))
        print(f"[18] {tag}: graph / eager {rows['eager']['warm_ms'] / rows['graph']['warm_ms']:.2f}x "
              f"(warm); keyframe poses graph against eager {dpose:.3e}; "
              f"lm_valid equal {same_masks[0]}, observations pruned "
              f"differently {same_masks[1]}", flush=True)
        check(torch.equal(g.map.kf_pose[kv], e.map.kf_pose[kv])
              and same_masks == (True, 0)
              and torch.equal(g.map.lm_pos[g.map.lm_valid],
                              e.map.lm_pos[e.map.lm_valid]),
              f"{tag}: replayed finalize {dpose:.2e} from eager, lm_valid "
              f"equal {same_masks[0]}, {same_masks[1]} observations pruned "
              f"differently")
        seg_rows[tag] = {m: rows[m]["seg"] for m in rows}

    # check_trajectory on the card against the CPU, on a map it must repair
    c, st = next(iter(cells.values()))[:2]
    fin = slam.finalize(c, st)
    m, g = fin.map, fin.graph
    seqs = torch.where(m.kf_valid, m.kf_seq,
                       torch.full_like(m.kf_seq, 2 ** 31 - 1))
    order = torch.sort(seqs, stable=True).indices[:int(m.kf_valid.sum())]
    e = order.numel() - 1
    E = g.pp_i.shape[0]
    check(3 <= e <= E, f"check_trajectory: {e} odometry edges for {E} slots")
    pad = E - e

    def ring(x, fill):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=dev)])
    i, j = order[:-1], order[1:]
    rel = se3.relative(m.kf_pose[i], m.kf_pose[j])
    g = g._replace(pp_i=ring(i.int(), 0), pp_j=ring(j.int(), 0),
                   pp_rel=ring(rel, 0.0), pp_gen_i=ring(m.kf_gen[i], 0),
                   pp_gen_j=ring(m.kf_gen[j], 0),
                   pp_valid=ring(torch.ones_like(i, dtype=torch.bool), False),
                   n_pp=torch.full_like(g.n_pp, e))
    moved = order[torch.tensor([e // 4, e // 2, 3 * e // 4], device=dev)]
    kf_pose = m.kf_pose.clone()
    kf_pose[moved, 0] += 0.5
    m = m._replace(kf_pose=kf_pose)
    card = slam.check_trajectory(c, m, g)
    cpu = slam.check_trajectory(
        c, m._replace(**{k: getattr(m, k).cpu() for k in m._fields}),
        g._replace(**{k: getattr(g, k).cpu() for k in g._fields}))
    d_ct = float((card[0].cpu() - cpu[0]).abs().max())
    ms_ct = median_ms(lambda: slam.check_trajectory(c, m, g), runs=20)
    check(int(card[1]) == int(cpu[1]) >= 2,
          f"check_trajectory: {int(card[1])} repairs on the card, "
          f"{int(cpu[1])} on the CPU")
    check(d_ct <= CHECK_TRAJECTORY_TOL, f"check_trajectory: card {d_ct:.2e} "
          f"from the CPU")
    print(f"[18] check_trajectory on the card, {e + 1} keyframes with "
          f"odometry edges, three moved by 0.5 m: {int(card[1])} repaired "
          f"(CPU {int(cpu[1])}), poses within {d_ct:.2e} of the CPU's "
          f"(tolerance {CHECK_TRAJECTORY_TOL}); {ms_ct:.4f} ms a call (CUDA "
          f"events)", flush=True)
    compiled.clear_cache()
    return seg_rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump-map", metavar="NPZ", help="write the final map "
                    "and graph of phase 11 there, to hold a solver against "
                    "the JAX package on the same state on a CPU")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA "
              "card", file=sys.stderr)
        return 1
    import numpy as np

    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.frontend import detector
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.backend import optimize as opt_mod
    from putslam_tpu_torch.slam_map import features_map as fm
    from putslam_tpu_torch.models import slam, vo
    from putslam_tpu_torch.ops import fast, fast_cuda, segment
    from putslam_tpu_torch import run as run_mod
    from putslam_tpu_torch.utils import control, graph_cond

    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[1] device: {name} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    # ---- 2. build: the library and its variants, all nvcc runs at once -----
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        builds = [pool.submit(fast_cuda.build, d)
                  for d in [(), *VARIANTS.values()]]
        cond_build = pool.submit(graph_cond.build)
        seg_build = pool.submit(segment.build)
        lib = builds[0].result()
        for b in builds[1:]:
            b.result()
        cond_lib = cond_build.result()
        seg_lib = seg_build.result()
    print(f"[2] built {os.path.relpath(lib)} and {len(VARIANTS)} variants, "
          f"the segment-sum kernel {os.path.relpath(seg_lib)} and the "
          f"conditional-node plumbing {os.path.relpath(cond_lib)}, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for log in (fast_cuda.build_log(), segment.build_log()):
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"[2] {line.strip()}", flush=True)

    # ---- 3. kernel vs plain at the fr1 shapes ------------------------------
    cfg = tum_fr1_config()
    det = cfg.detector
    thr, rad = det.fast_threshold, det.nms_radius
    shapes = detector._pyramid_shapes(cfg)
    frame_pose = synthetic.orbit_trajectory(N_FRAMES, radius=0.10,
                                            yaw_amp=0.1, device=dev)[0]
    gray0, depth0 = synthetic.render_frame(cfg.camera, frame_pose)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    frame_lv = [gray0] + [detector.resize(gray0, sh).contiguous()
                          for sh in shapes[1:]]
    noise_lv = [torch.rand(sh, generator=gen, device=dev) for sh in shapes]
    quant_lv = [torch.round(x * 255.0) / 255.0 for x in noise_lv]
    max_err = 0.0

    def plain(levels, r=rad):
        out = []
        for img in levels:
            raw = fast.fast_score_map(img, thr)
            out.append((raw, fast.nms(raw, r)))
        return out

    def same(got, ref, what):
        nonlocal max_err
        torch.cuda.synchronize()
        check(len(got) == len(ref), f"{what}: {len(got)} levels")
        for lvl, ((raw_k, nms_k), (raw_p, nms_p)) in enumerate(zip(got, ref)):
            check(torch.equal(raw_k, raw_p), f"raw differs: {what}, level {lvl}")
            check(torch.equal(nms_k, nms_p), f"nms differs: {what}, level {lvl}")
            max_err = max(max_err, float((raw_k - raw_p).abs().max()),
                          float((nms_k - nms_p).abs().max()))

    for tag, lv in (("frame", frame_lv), ("uniform", noise_lv),
                    ("quantised", quant_lv)):
        ref = plain(lv)
        same(fast_cuda.fast_score_nms_levels(lv, thr, rad), ref,
             f"one launch, {tag}")
        same([fast_cuda.fast_score_nms(x, thr, rad) for x in lv], ref,
             f"level by level, {tag}")
        for vname, defines in VARIANTS.items():
            same(fast_cuda.launch_levels(lv, thr, rad, defines), ref,
                 f"variant {vname}, {tag}")
        print(f"[3] {tag}: one launch, level by level and {len(VARIANTS)} "
              f"variants bit-exact at "
              f"{' '.join(f'{h}x{w}' for h, w in shapes)} "
              f"({sum(int((m > 0).sum()) for _, m in ref)} maxima)",
              flush=True)
    ragged = [torch.round(torch.rand(sh, generator=gen, device=dev) * 255.0)
              / 255.0 for sh in RAGGED_SHAPES]
    for r in (0, rad, 5):
        same(fast_cuda.fast_score_nms_levels(ragged, thr, r), plain(ragged, r),
             f"ragged, radius {r}")
    print(f"[3] ragged {RAGGED_SHAPES}, tie-heavy: bit-exact at nms_radius 0, "
          f"{rad} and 5", flush=True)

    # timing in this one call: plain, then the kernel twice
    def new_frame():
        return fast_cuda.fast_score_nms_levels(frame_lv, thr, rad)

    n_pix = sum(h * w for h, w in shapes)
    bytes_frame = 12 * n_pix          # 4 read, 8 written per pixel, once each
    # fp32 operations a pixel: x255, 16 differences, 32 compares, 32 x
    # (subtract, clamp, add), the sum of the two, (2r+1)^2 - 1 maxima, 2 keeps
    ops_frame = n_pix * (1 + 16 + 32 + 96 + 1 + (2 * rad + 1) ** 2 - 1 + 2)
    bytes_ms = 1e3 * bytes_frame / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops_frame / FP32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    ms_plain = median_ms(lambda: plain(frame_lv))
    turns = [median_ms(new_frame), median_ms(new_frame)]
    ms_kernel = 0.5 * (turns[0] + turns[1])
    print(f"[3] one frame ({n_pix} pixels; {bytes_frame} bytes = "
          f"{bytes_ms:.5f} ms at {HBM_BYTES_PER_S / 1e12} TB/s, {ops_frame} "
          f"fp32 operations = {ops_ms:.5f} ms at {FP32_OPS_PER_S / 1e12} "
          f"TFLOP/s: bound {bound_ms:.5f} ms, by {bound_by}): plain "
          f"{ms_plain:.4f} ms; kernel, 1 launch {turns[0]:.5f} / "
          f"{turns[1]:.5f} ms, at {100 * bound_ms / ms_kernel:.1f} % of the "
          f"bound", flush=True)
    for (h, w), img in zip(shapes, frame_lv):
        b = 1e3 * 12 * h * w / HBM_BYTES_PER_S
        tn = median_ms(lambda: fast_cuda.fast_score_nms(img, thr, rad))
        print(f"[3] {h}x{w} alone ({12 * h * w} bytes, bound {b:.5f} ms): "
              f"{tn:.5f} ms ({100 * b / tn:.1f} %)", flush=True)
    b2b_new = median_ms(new_frame, runs=20, reps=20)
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cold_new = median_ms(new_frame, runs=20, before=flush_buf.zero_)
    del flush_buf
    print(f"[3] one frame, 20 calls back to back: {b2b_new:.5f} ms per "
          f"frame; after an L2 flush: {cold_new:.5f} ms", flush=True)
    one = torch.empty(1, device=dev)
    print(f"[3] floor of this timing (a one-element fill between the "
          f"events): {median_ms(one.zero_):.5f} ms alone, "
          f"{median_ms(one.zero_, runs=20, reps=20):.5f} ms back to back",
          flush=True)
    us_new = profiler_us(new_frame, "fast_score_nms_kernel")
    us_lvl0 = profiler_us(lambda: fast_cuda.fast_score_nms(frame_lv[0], thr,
                                                           rad),
                          "fast_score_nms_kernel")

    def us(x):
        return "not measured" if x is None else f"{x:.2f} us"

    print(f"[3] the kernel's own duration (torch.profiler), one frame: "
          f"{us(us_new)}; 480x640 alone {us(us_lvl0)}", flush=True)
    ms_noise = median_ms(lambda: fast_cuda.fast_score_nms_levels(
        noise_lv, thr, rad), runs=30)
    print(f"[3] default build: frame {median_ms(new_frame, runs=30):.5f} ms, "
          f"uniform noise {ms_noise:.5f} ms", flush=True)
    for vname, defines in VARIANTS.items():
        tf = median_ms(lambda: fast_cuda.launch_levels(
            frame_lv, thr, rad, defines), runs=30)
        tn = median_ms(lambda: fast_cuda.launch_levels(
            noise_lv, thr, rad, defines), runs=30)
        tp = profiler_us(lambda: fast_cuda.launch_levels(
            frame_lv, thr, rad, defines), "fast_score_nms_kernel")
        print(f"[3] variant {vname}: frame {tf:.5f} ms, uniform noise "
              f"{tn:.5f} ms; own duration on the frame {us(tp)}", flush=True)

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
    segment.reset_launch_count()
    t0 = time.perf_counter()
    pb, pa, outs, state = slam.run_slam_final(cfg, grays, depths,
                                              init_pose=gt[0], device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fast_cuda.fast_score_nms.launches
    seg_launches = segment.launch_count()
    check(launches == N_FRAMES,
          f"kernel launches {launches} != {N_FRAMES} (one per frame)")
    # the bench makes no keyframe (ROADMAP 3j): its BA is finalize's
    check(seg_launches > 0, "the main path launched no segment sum")
    ate_before = ate_mod.ate_rmse_aligned_frames(gt, pb)
    ate_final = ate_mod.ate_rmse_aligned_frames(gt, pa)
    check(pa.shape == (N_FRAMES, 7) and bool(torch.isfinite(
        torch.as_tensor(pa)).all()), "trajectory not finite / wrong shape")
    check(ate_before < ATE_GATE_M and ate_final < ATE_GATE_M,
          f"ATE {ate_before:.5f} / {ate_final:.5f} m over the gate "
          f"{ATE_GATE_M} m")
    print(f"[5] fr1 {N_FRAMES}-frame orbit, run_slam_final: {dt:.3f} s, "
          f"{N_FRAMES / dt:.2f} SLAM frames/s, {1e3 * dt / N_FRAMES:.2f} "
          f"ms/frame (incl. finalize); kernel launches {launches}, "
          f"segment sums {seg_launches} (finalize's); "
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
    segment.reset_launch_count()
    t0 = time.perf_counter()
    pb2, pa2, outs2, state2 = slam.run_slam_final(kf_cfg, grays, depths,
                                                  init_pose=gt[0], device=dev)
    torch.cuda.synchronize()
    dt2 = time.perf_counter() - t0
    seg_launches2 = segment.launch_count()
    check(fast_cuda.fast_score_nms.launches == launches,
          "keyframe-dense run: wrong kernel launch count")
    n_ba = int(outs2.ba_ran.sum())
    check(n_ba >= 2, f"keyframe-dense run ran {n_ba} BA calls")
    ate2_b = ate_mod.ate_rmse_aligned_frames(gt, pb2)
    ate2_f = ate_mod.ate_rmse_aligned_frames(gt, pa2)
    check(ate2_b < ATE_GATE_M and ate2_f < ATE_GATE_M,
          f"keyframe-dense ATE {ate2_b:.5f} / {ate2_f:.5f} m over the gate")
    check(seg_launches2 > seg_launches, f"keyframe-dense run: "
          f"{seg_launches2} segment sums, the bench's finalize alone "
          f"{seg_launches}")
    print(f"[5b] keyframe-dense: {dt2:.3f} s, {N_FRAMES / dt2:.2f} SLAM "
          f"frames/s; keyframes {int(outs2.is_keyframe.sum())}, BA calls "
          f"{n_ba}, landmarks {int(outs2.n_landmarks[-1])}; segment sums "
          f"{seg_launches2}; ATE before final {ate2_b:.5f} m, final "
          f"{ate2_f:.5f} m", flush=True)

    # ---- 5c. the segment-sum kernel on the sums of real solves ------------
    def one_iteration(c, fn):
        c = c.replace(backend=dataclasses.replace(
            c.backend, gn_iterations=1, final_gn_iterations=1))

        def run():
            with control.branching("host"):
                fn(c)
        return run

    seg_rows = phase_segment_sum({
        "finalize of phase 5's state (the main path)": one_iteration(
            cfg, lambda c: slam.finalize_map(c, state.map, state.graph)),
        "finalize of phase 5b's map": one_iteration(
            kf_cfg, lambda c: slam.finalize_map(c, state2.map,
                                                state2.graph)),
        "the in-loop BA of phase 5b's map": one_iteration(
            kf_cfg, lambda c: slam.bundle_adjust(c, state2.map,
                                                 state2.graph))}, dev)
    main_seg = next(iter(seg_rows.values()))

    # ---- 6. the CLI ---------------------------------------------------------
    five = FIVE_FILES
    report = run_cli(run_mod, ["--synthetic", "30"], five)
    check(report["ate_rmse_m"] < CLI_ATE_GATE_M,
          f"CLI ATE {report['ate_rmse_m']} >= {CLI_ATE_GATE_M}")
    print(f"[6] run --synthetic 30: {report}", flush=True)
    report = run_cli(run_mod, ["--synthetic", "30", "--loop-closure"], five)
    check(report["ate_rmse_m"] < CLI_ATE_GATE_M,
          f"CLI --loop-closure ATE {report['ate_rmse_m']} >= {CLI_ATE_GATE_M}")
    print(f"[6] run --synthetic 30 --loop-closure: {report}", flush=True)
    report = run_cli(run_mod, ["--synthetic", "30", "--only-vo",
                               "--vo-version", "1"],
                     ("VO_trajectory.res", "fps.res", "times.txt"))
    check(report["ate_rmse_m"] < KLT_ATE_GATE_M,
          f"CLI --vo-version 1 ATE {report['ate_rmse_m']} >= "
          f"{KLT_ATE_GATE_M}")
    print(f"[6] run --synthetic 30 --only-vo --vo-version 1: {report}",
          flush=True)

    # ---- 7. loop closure on a leave-and-return trajectory ------------------
    counter = fast_cuda.fast_score_nms
    poses_r = synthetic.revisit_trajectory(LC_FRAMES, sweep=1.2, device=dev)
    grays_r, depths_r = synthetic.render_sequence(cfg.camera, poses_r)
    gt_r = poses_r.cpu().numpy()
    lc = {}
    for enabled in (False, True):
        # the JAX LC test's map and loop-closure settings; at fr1 widths the
        # first frame's landmarks stay matched over the whole sweep, so no
        # frame becomes a keyframe on its own: every tracked frame is made
        # one (as in phase 5b) so that there are keyframes to close loops on
        lc_cfg = cfg.replace(
            map=dataclasses.replace(
                cfg.map, add_features_when_measurements_less_than=10,
                max_keyframes=64, min_keyframe_matches=10_000),
            loop_closure=dataclasses.replace(cfg.loop_closure,
                                             enabled=enabled, tail_skip=10))
        def lc_run():
            return slam.run_slam_final(lc_cfg, grays_r, depths_r,
                                       init_pose=gt_r[0], device=dev)
        (pb_r, pa_r, outs_r, st_r), dt_r, n_launch = timed(lc_run, counter)
        segment.reset_launch_count()
        # the same run again (its graphs are captured): the same bits
        pb_r2, pa_r2 = lc_run()[:2]
        n_seg = segment.launch_count()
        check(n_launch == LC_FRAMES,
              f"LC {enabled}: kernel launches {n_launch}")
        check(np.array_equal(pa_r, pa_r2) and np.array_equal(pb_r, pb_r2),
              f"LC {enabled}: a second run of the sequence ends elsewhere "
              f"({float(np.abs(pa_r - pa_r2).max()):.3e} m)")
        check(bool(torch.isfinite(torch.as_tensor(pa_r)).all()),
              "LC run: trajectory not finite")
        _, n_sync = count_syncs(lambda: slam.run_slam(
            lc_cfg, grays_r, depths_r, init_pose=gt_r[0], device=dev))
        lc[enabled] = dict(
            s=dt_r, edges=int(st_r.n_lc_edges), kf=int(outs_r.is_keyframe.sum()),
            ba=int(outs_r.ba_ran.sum()),
            ate_b=ate_mod.ate_rmse_aligned_frames(gt_r, pb_r),
            ate_f=ate_mod.ate_rmse_aligned_frames(gt_r, pa_r),
            ate_f2=ate_mod.ate_rmse_aligned_frames(gt_r, pa_r2),
            syncs=n_sync / (LC_FRAMES - 1))
        check(lc[enabled]["ate_f"] == lc[enabled]["ate_f2"],
              f"LC {enabled}: final ATE {lc[enabled]['ate_f']!r} then "
              f"{lc[enabled]['ate_f2']!r}")
        print(f"[7] revisit {LC_FRAMES} frames, loop closure "
              f"{'on' if enabled else 'off'}: {dt_r:.3f} s, "
              f"{LC_FRAMES / dt_r:.2f} SLAM frames/s, "
              f"{1e3 * dt_r / LC_FRAMES:.2f} ms/frame; launches {n_launch}; "
              f"keyframes {lc[enabled]['kf']}, BA calls {lc[enabled]['ba']}, "
              f"LC edges {lc[enabled]['edges']}; ATE before final "
              f"{lc[enabled]['ate_b']:.5f} m, final {lc[enabled]['ate_f']:.5f}"
              f" m (run again: {lc[enabled]['ate_f2']!r} m, bit-identical "
              f"trajectory; {n_seg} segment sums); host syncs per frame in "
              f"run_slam {lc[enabled]['syncs']:.2f}", flush=True)
    check(lc[False]["edges"] == 0, "loop closure off made LC edges")
    check(lc[True]["edges"] >= 1, "loop closure on made no accepted edge")
    check(lc[True]["ate_f"] < LC_ATE_GATE_M,
          f"LC final ATE {lc[True]['ate_f']:.5f} >= {LC_ATE_GATE_M}")

    # ---- 7b. the compiled step: eager against CUDA graphs ------------------
    t7b = time.perf_counter()
    n7b, finals7b, seg7b = phase_compiled({
        "bench": (cfg, grays, depths, gt, ATE_GATE_M, ATE_GATE_M),
        "keyframe_dense": (kf_cfg, grays, depths, gt, None, ATE_GATE_M),
        "revisit_lc": (lc_cfg, grays_r, depths_r, gt_r, None,
                       LC_ATE_GATE_M)}, dev)
    print(f"[7b] wall {time.perf_counter() - t7b:.1f} s", flush=True)

    # ---- 8. the three BA solvers on the keyframe-dense final map ------------
    # the fixed mask is the in-loop BA's: keyframes older than the newest
    # SOLVER_WINDOW, and the oldest (the gauge). With more free keyframes
    # the solvers part ways on this map in the JAX package as in the port
    # (PERF.md): printed below, not checked.
    m2 = state2.map
    seqs = torch.where(m2.kf_valid, m2.kf_seq,
                       torch.full_like(m2.kf_seq, 2 ** 31 - 1))
    gauge = torch.zeros_like(m2.kf_valid)
    gauge[torch.argmin(seqs)] = True
    window_fixed = fm.active_window_fixed(m2, SOLVER_WINDOW) | gauge

    def solve(solver, fixed):
        bcfg = dataclasses.replace(cfg.backend, solver=solver,
                                   gn_iterations=6, robust_kernel="none",
                                   ba_window=0)
        return opt_mod.optimize_graph(
            bcfg, m2.kf_pose, m2.kf_valid, m2.lm_pos, m2.lm_valid,
            state2.graph, fixed, lm_gen=m2.lm_gen, kf_gen=m2.kf_gen,
            cam=cfg.camera)

    def agreement(sols):
        ref = sols["dense_schur"]
        return {s: (float((sols[s].kf_pose - ref.kf_pose)[m2.kf_valid]
                          .abs().max()), float(sols[s].chi2[-1]))
                for s in ("dense_schur_mm", "pcg")}, float(ref.chi2[-1])

    sols = {s: solve(s, window_fixed) for s in opt_mod.SOLVERS}
    sol_ms = {s: median_ms(lambda s=s: solve(s, window_fixed), runs=5)
              for s in opt_mod.SOLVERS}
    agree, chi_ref = agreement(sols)
    for solver, (dpose, chi) in agree.items():
        check(dpose < SOLVER_POSE_TOL, f"{solver} poses differ by {dpose}")
        check(abs(chi - chi_ref) < SOLVER_CHI2_RTOL * max(chi_ref, 1e-6),
              f"{solver} chi2 {chi} vs dense_schur {chi_ref}")
        print(f"[8] {solver} vs dense_schur: poses within {dpose:.2e}, "
              f"final chi2 {chi:.6g} vs {chi_ref:.6g}", flush=True)
    print(f"[8] BA solvers, {int(m2.kf_valid.sum())} keyframes "
          f"({int((m2.kf_valid & ~window_fixed).sum())} free), "
          f"{int(m2.lm_valid.sum())} landmarks (K={m2.kf_pose.shape[0]}, "
          f"L={m2.lm_pos.shape[0]}), 6 iterations: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in sol_ms.items()) + " per call",
          flush=True)
    agree_all, chi_all = agreement({s: solve(s, gauge)
                                    for s in opt_mod.SOLVERS})
    print("[8] every keyframe but the gauge free (not checked): " + ", ".join(
        f"{s} poses off by {d:.2e}, chi2 {c:.6g}" for s, (d, c)
        in agree_all.items()) + f"; dense_schur chi2 {chi_all:.6g}",
        flush=True)

    # ---- 9. the bench workload with the EKF motion model --------------------
    ekf_cfg = cfg.replace(motion_model=dataclasses.replace(
        cfg.motion_model, enabled=True))
    (pb3, pa3, outs3, _), dt3, n3 = timed(
        lambda: slam.run_slam_final(ekf_cfg, grays, depths, init_pose=gt[0],
                                    device=dev), counter)
    check(n3 == N_FRAMES, f"EKF run launches {n3}")
    ate3_b = ate_mod.ate_rmse_aligned_frames(gt, pb3)
    ate3_f = ate_mod.ate_rmse_aligned_frames(gt, pa3)
    check(ate3_b < ATE_GATE_M and ate3_f < ATE_GATE_M,
          f"EKF ATE {ate3_b:.5f} / {ate3_f:.5f} m over the gate")
    print(f"[9] motion model on: {dt3:.3f} s, {N_FRAMES / dt3:.2f} SLAM "
          f"frames/s; launches {n3}; VO ok {int(outs3.vo_ok.sum())} of "
          f"{N_FRAMES - 1}; ATE before final {ate3_b:.5f} m, final "
          f"{ate3_f:.5f} m", flush=True)

    # ---- 10. tracking VO ----------------------------------------------------
    klt_cfg = cfg.replace(vo_version=1)
    (est4, stats4), dt4, n4 = timed(
        lambda: vo.run_vo(klt_cfg, grays, depths, init_pose=gt[0],
                          device=dev), counter)
    check(n4 == N_FRAMES, f"tracking VO launches {n4} != {N_FRAMES}")
    ok_frac = float(stats4.ok.mean())
    ate4 = ate_mod.ate_rmse_aligned_frames(gt, est4)
    check(ok_frac > 0.5, f"tracking VO ok on {ok_frac:.3f} of the steps")
    check(ate4 < KLT_ATE_GATE_M, f"tracking VO ATE {ate4:.5f}")
    print(f"[10] tracking VO: {dt4:.3f} s, {N_FRAMES / dt4:.2f} frames/s, "
          f"{1e3 * dt4 / N_FRAMES:.2f} ms/frame; launches {n4}; ok on "
          f"{ok_frac:.3f} of the steps, median tracked "
          f"{float(torch.as_tensor(stats4.n_matches).float().median()):.0f};"
          f" ATE {ate4:.5f} m", flush=True)
    # ---- 10b. the tracking VO from its graph against the eager chain -------
    # phase 10's run captured the graph; this one replays it
    _, dt4g, n4g = timed(
        lambda: vo.run_vo(klt_cfg, grays, depths, init_pose=gt[0],
                          device=dev), counter)
    (est4e, stats4e), dt4e, n4e = timed(
        lambda: vo.run_vo(klt_cfg, grays, depths, init_pose=gt[0],
                          device=dev, graph=False), counter)
    check(n4g == N_FRAMES and n4e == N_FRAMES,
          f"tracking VO launches {n4g} (graph), {n4e} (eager)")
    same4 = (est4 == est4e).all() and all(
        (a == b).all() for a, b in zip(stats4, stats4e))
    check(same4, "tracking VO from its graph differs from the eager chain")
    print(f"[10b] tracking VO from its graph, captured: {dt4g:.3f} s, "
          f"{N_FRAMES / dt4g:.2f} frames/s, {1e3 * dt4g / N_FRAMES:.2f} "
          f"ms/frame (phase 10's run, with the capture: {N_FRAMES / dt4:.2f})"
          f"; eager: {dt4e:.3f} s, {N_FRAMES / dt4e:.2f} frames/s; "
          f"{dt4e / dt4g:.2f}x; poses and per-step results bit-equal; "
          f"launches {n4g} (graph) and {n4e} (eager), one a frame",
          flush=True)

    # ---- 11. the uncertainty path, 12. the front-end options ---------------
    phase_uncertainty(cfg, grays, depths, gt, dev, dt2, args.dump_map)
    phase_frontend_options(cfg, grays, depths, gt, dev, dt)

    # ---- 13. the file player, 14. archive and global BA, 15. state tools ---
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data")
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_", dir=out_dir)
    try:
        root = os.path.join(work, "handheld")
        t13 = time.perf_counter()
        h_grays, h_depths, h_gt, n13, report13 = phase_file_player(
            cfg, dev, root, dt)
        t14 = time.perf_counter()
        n14, n14w = phase_archive(cfg, dev, root, h_grays, h_depths, h_gt,
                                  report13)
        t15 = time.perf_counter()
        n15, n15p = phase_state_tools(cfg, dev, grays, depths, gt, state2,
                                      pb2, work)
        t16 = time.perf_counter()
        print(f"[13-15] wall: file player {t14 - t13:.1f} s, archive and "
              f"global BA {t15 - t14:.1f} s, state tools "
              f"{t16 - t15:.1f} s", flush=True)
        # ---- 16. the distributed path -----------------------------------
        del h_grays, h_depths
        n16v, n16m, (st_h, outs_h) = phase_distributed(
            cfg, dev, state2, window_fixed, root, h_gt, work)
        print(f"[16] the whole script {time.perf_counter() - t_start:.1f} s",
              flush=True)
        # ---- 17. bench_torch, the VO profile, planes, acceptance, se2 ----
        t17 = time.perf_counter()
        n17a = phase_bench(dev, work, dt)
        t17b = time.perf_counter()
        n17b, _ = phase_profile_vo(work)
        t17c = time.perf_counter()
        n17c = phase_planes(cfg, dev, work)
        t17d = time.perf_counter()
        n17d = phase_acceptance(dev, root, h_gt)
        t17e = time.perf_counter()
        phase_se2_affine(cfg, dev, grays, f_gpu)
        t_end = time.perf_counter()
        print(f"[17] wall: bench {t17b - t17:.1f} s, VO profile "
              f"{t17c - t17b:.1f} s, planes {t17d - t17c:.1f} s, acceptance "
              f"{t17e - t17d:.1f} s, se2 and affine {t_end - t17e:.1f} s; "
              f"phase 17 {t_end - t17:.1f} s", flush=True)
        # ---- 18. the compiled end of the run -----------------------------
        t18 = time.perf_counter()
        # 7b's keyframe-dense final states and 16c's handheld one
        cells18 = {tag: finals7b[tag]
                   for tag in ("keyframe_dense", "revisit_lc")}
        cells18["handheld"] = (cfg, st_h, outs_h, h_gt, ATE_GATE_M)
        del finals7b
        seg18 = phase_compiled_end(cells18, dev)
        t_end = time.perf_counter()
        print(f"[18] wall {t_end - t18:.1f} s; the whole script "
              f"{t_end - t_start:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "fast_score_nms",
        "route": "cuda",
        "source": "putslam_tpu_torch/csrc/fast_score_nms.cu",
        "replaces": "putslam_tpu/ops/fast_pallas.py:82",
        "launches": launches,
        "launches_per_frame": launches / N_FRAMES,
        "launches_file_player": n13,
        "launches_global_ba": n14,
        "launches_wrapped_ring": n14w,
        "launches_checkpoint_resume": n15,
        "launches_playback": n15p,
        "launches_sessions": n16v,
        "launches_multi_session": n16m,
        "launches_bench": n17a,
        "launches_profile_vo": n17b,
        "launches_planes": n17c,
        "launches_acceptance": n17d,
        "launches_compiled_step": n7b,
        "launches_tracking_vo": n4,
        "launches_tracking_vo_eager": n4e,
        "max_abs_err": max_err,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bytes": bytes_frame,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "device_us_profiler": us_new,
    }, {
        "name": "segment_sum",
        "route": "cuda",
        "source": "putslam_tpu_torch/csrc/segment_sum.cu",
        "replaces": "none: not a TPU kernel (the one-hot products of "
                    "putslam_tpu/backend/optimize.py:397-408, :476-503, "
                    "which XLA ran)",
        "launches": seg_launches,
        "launches_keyframe_dense": seg_launches2,
        "launches_per_frame_compiled_step": seg7b,
        "launches_per_finalize": seg18,
        "launches_per_iteration": main_seg["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in seg_rows.values()),
        "ms": main_seg["ms"],
        "plain_ms": main_seg["plain_ms"],
        "bound_ms": main_seg["bound_ms"],
        "bound_by": main_seg["bound_by"],
        "library_ms": main_seg["library_ms"],
        "plan_ms": main_seg["plan_ms"],
        "device_us_profiler": main_seg["own_us"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
