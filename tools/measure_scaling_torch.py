#!/usr/bin/env python
"""Measured scaling of the port's distributed BA over real processes: the
counterpart of ``tools/measure_scaling.py``.

Runs ``parallel.dist_ba.dist_gauss_newton`` at the JAX tool's capacities
(K=256 keyframes, L=8192 landmarks, M=8192 observations, E=1024 pose-pose
slots) on 1, 2, 4 ... ranks, one OS process each, joined by a ``file://``
rendezvous. Per world size it times calls of 2 and 6 Gauss-Newton
iterations (best of 3 each) and reports the marginal ms per iteration,
which cancels the fixed cost of a call, and the speed-up and efficiency
against one rank.

  --device cpu   gloo between CPU processes, one thread each: the scaling
                 shape of the per-rank work and the all-reduce, labelled
                 "cpu-gloo"; the times are CPU times.
  --device cuda  world 1 on NCCL, and world 2 with both ranks sharing the
                 one card over gloo (NCCL refuses two ranks on one card; gloo
                 stages the CUDA buffer through the host). Neither is a
                 scaling number: that needs a machine with more than one
                 card. The card's name and power limit are printed.

Usage:  python tools/measure_scaling_torch.py --device cpu --worlds 1 2 4
        python tools/measure_scaling_torch.py --device cuda --worlds 1 2 \\
            --json-out scaling_torch.json
``--caps small`` runs the dryrun tool's problem size, for a quick check.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CAPS = {"fr1": dict(K=256, L=8192, M=8192, E=1024),
        "small": dict(K=8, L=64, M=512, E=16)}
ITERS_A, ITERS_B = 2, 6
WORKER_TIMEOUT_S = 1800


def build_problem(caps, device):
    """The JAX tool's seeded problem (``tools/measure_scaling.py:149-164``):
    random keyframes near the origin, landmarks around z = 3, M random
    noise-free observations of weight 100, keyframe 0 fixed. (The dryrun
    tool's builder observes every landmark from every keyframe: K·L
    observations, 2,097,152 at these capacities against M = 8192 slots.)"""
    import torch

    from putslam_tpu_torch.backend import graph as graph_mod
    from putslam_tpu_torch.geometry import se3

    K, L, M = caps["K"], caps["L"], caps["M"]
    rng = np.random.default_rng(7)
    kf_pose = torch.as_tensor(np.concatenate(
        [rng.normal(0, 0.1, (K, 3)), np.tile([1.0, 0, 0, 0], (K, 1))], -1)
        .astype(np.float32))
    lm_pos = torch.as_tensor(rng.normal(0, 1.0, (L, 3)).astype(np.float32)
                             + np.array([0, 0, 3], np.float32))
    okf = torch.as_tensor(rng.integers(0, K, M), dtype=torch.int32)
    olm = torch.as_tensor(rng.integers(0, L, M), dtype=torch.int32)
    z = se3.apply(se3.inverse(kf_pose[okf.long()]), lm_pos[olm.long()])
    g = graph_mod.add_observations(
        graph_mod.init_graph(M, caps["E"], "cpu"), okf, olm, z,
        torch.full((M,), 100.0), torch.ones((M,), dtype=torch.bool))
    fixed = torch.zeros((K,), dtype=torch.bool)
    fixed[0] = True
    g = graph_mod.GraphState(*(x.to(device) for x in g))
    return (kf_pose.to(device), torch.ones((K,), dtype=torch.bool,
                                           device=device),
            lm_pos.to(device), torch.ones((L,), dtype=torch.bool,
                                          device=device),
            g, fixed.to(device), torch.zeros((L,), dtype=torch.int32,
                                             device=device))


def worker(args):
    """One rank: join the group, time the calls, rank 0 prints its row."""
    import datetime

    import torch

    from putslam_tpu_torch.config import BackendConfig
    from putslam_tpu_torch.parallel import dist_ba, multihost
    from putslam_tpu_torch.utils.device import resolve_device

    from multihost_dryrun_torch import _limit_threads

    _limit_threads()
    dev = resolve_device(args.device)
    backend = None
    if args.world > 1 or dev.type == "cuda":
        # world 1 on the card still joins a group: the NCCL all-reduce is
        # part of what is timed; ranks sharing the card take gloo
        backend = multihost.join_group(
            args.rdv, args.world, args.rank, device=dev,
            backend="gloo" if args.world > 1 else None,
            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = multihost.global_mesh(device=dev)
        caps = CAPS[args.caps]
        kf, kfv, lm, lmv, g, fixed, lmg = build_problem(caps, dev)
        times = {}
        for iters in (ITERS_A, ITERS_B):
            bcfg = BackendConfig(gn_iterations=iters, damping=1e-5,
                                 chi2_ratio_termination=0.0)

            def call():
                out = dist_ba.dist_gauss_newton(bcfg, mesh, kf, kfv, lm, lmv,
                                                g, fixed, lmg)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                return out

            _, _, chi2, ovf = call()                     # warm-up
            if int(ovf):
                raise RuntimeError(f"owner partition dropped {int(ovf)} "
                                   f"observations")
            best = 1e9
            for _ in range(3):
                t0 = time.perf_counter()
                call()
                best = min(best, time.perf_counter() - t0)
            times[iters] = best
        mesh.timed = True
        n0, b0 = mesh.n_all_reduce, mesh.all_reduce_bytes
        call()
        row = {"world": mesh.size, "backend": backend,
               "per_gn_iter_ms": 1e3 * (times[ITERS_B] - times[ITERS_A])
               / (ITERS_B - ITERS_A),
               "call_ms_at_2_iters": 1e3 * times[ITERS_A],
               "all_reduce_ms_per_iter": 1e3 * mesh.all_reduce_s / ITERS_B,
               # one packed buffer an iteration; the landmark gather once a
               # call is left out
               "all_reduce_bytes_per_iter":
                   0 if mesh.group is None else
                   (mesh.all_reduce_bytes - b0 - 4 * lm.numel()) / ITERS_B,
               "all_reduce_calls": mesh.n_all_reduce - n0,
               "chi2_final": float(chi2[-1])}
    finally:
        multihost.shutdown()
    if args.rank == 0:
        print(json.dumps(row), flush=True)
    return 0


def nvidia_smi_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def run_world(args, world, tmp):
    """Start ``world`` ranks, wait for all; rank 0's row."""
    rdv = "file://" + os.path.join(tmp, f"rdv{world}")
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--device", args.device, "--caps", args.caps, "--world",
           str(world), "--rdv", rdv]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            if p.returncode != 0:
                raise RuntimeError(f"world {world}: a rank failed:\n"
                                   f"{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return json.loads(outs[0].strip().splitlines()[-1])


def label(device, world):
    if device == "cpu":
        return "cpu-gloo"
    if world == 1:
        return "cuda-nccl, one rank on one card"
    return f"cuda-gloo, {world} ranks sharing one card (not scaling)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--worlds", type=int, nargs="+", default=None)
    ap.add_argument("--caps", default="fr1", choices=tuple(CAPS))
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--rdv", default=None)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    worlds = args.worlds or ([1, 2, 4] if args.device == "cpu" else [1, 2])
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("measure_scaling_torch: --device cuda needs a CUDA card",
                  file=sys.stderr)
            return 1
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for world in worlds:
            row = run_world(args, world, tmp)
            row["platform"] = label(args.device, world)
            rows.append(row)
            print(f"world={world} ({row['platform']}): "
                  f"{row['per_gn_iter_ms']:.2f} ms/GN-iter, all-reduce "
                  f"{row['all_reduce_ms_per_iter']:.3f} ms and "
                  f"{row['all_reduce_bytes_per_iter']:.0f} bytes per "
                  f"iteration", flush=True)
    t1 = rows[0]["per_gn_iter_ms"]
    for r in rows:
        r["speedup"] = t1 / max(r["per_gn_iter_ms"], 1e-9)
        r["efficiency_pct"] = 100.0 * r["speedup"] / r["world"]
    out = {"platform": "cpu-gloo" if args.device == "cpu" else "cuda",
           "card": nvidia_smi_line() if args.device == "cuda" else None,
           "capacities": CAPS[args.caps], "rows": rows,
           "note": ("CPU processes over gloo, one thread each: the scaling "
                    "shape, CPU times" if args.device == "cpu" else
                    "one card: world 1 on NCCL, world > 1 shares the card "
                    "over gloo; not a scaling measurement")}
    print(json.dumps(out), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
