#!/usr/bin/env python
"""Distributed BA across OS processes with the PyTorch port: the
counterpart of ``tools/multihost_dryrun.py``.

Every process joins one ``torch.distributed`` group (one rank each), builds
the same seeded synthetic BA problem (or loads one, ``--problem``) and runs
``parallel.dist_ba.dist_gauss_newton`` over the global mesh: the reduced
camera system is all-reduced across the process boundary once per
Gauss-Newton iteration. ``--archive`` runs ``global_bundle_adjust(mesh=)``
on an archived graph (after the BA, when ``--problem`` is given too).
Prints one JSON line with the final chi² so the caller can compare the
ranks with each other and with ``--single``.

Usage (each process; ``--coordinator`` is host:port or a file:// path):
    python tools/multihost_dryrun_torch.py --coordinator file:///tmp/rdv \\
        --num-processes 2 --process-id {0,1} --device cpu
Single-process reference (one rank; ``--ranks N``: N virtual ranks):
    python tools/multihost_dryrun_torch.py --single --device cpu
On one card, two ranks sharing it: ``--device cuda --backend gloo``
(NCCL refuses two ranks on one card).

``--problem NPZ`` (written by ``save_problem``) and ``--archive NPZ``
(written by ``save_archive``) carry numpy inputs from the caller;
``--out NPZ`` receives this rank's results (``kf_pose``, ``lm_pos``,
``chi2``, ``kf_polished``; ``{rank}`` in the path becomes the process id);
``--repeat N`` times N more calls.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GRAPH_PREFIX = "graph/"


def _limit_threads():
    """One thread per rank for torch and numpy's BLAS: ranks share the
    host's cores."""
    import torch

    torch.set_num_threads(1)
    try:
        import threadpoolctl
        threadpoolctl.threadpool_limits(1, "blas")
    except ImportError:
        pass


def build_problem(rng, device, K=8, L=64, M=512, E=16):
    """The JAX tool's seeded problem (``tools/multihost_dryrun.py:26``):
    K keyframes, every one observing all L landmarks (noise 0.01 m), poses
    and landmarks perturbed. Returns the inputs of ``dist_gauss_newton``
    after ``bcfg`` and ``mesh``, as a dict."""
    import torch

    from putslam_tpu_torch.backend import graph
    from putslam_tpu_torch.geometry import se3

    kf_t = torch.as_tensor(rng.uniform(-0.5, 0.5, (K, 3)), dtype=torch.float32)
    kf_pose = torch.cat([kf_t, torch.tensor([[1.0, 0, 0, 0]]).expand(K, 4)],
                        dim=1)
    lm_gt = torch.as_tensor(rng.uniform([-2, -1.5, 1.0], [2, 1.5, 4.0], (L, 3)),
                            dtype=torch.float32)
    zs = []
    for k in range(K):
        z = se3.apply(se3.inverse(kf_pose[k]), lm_gt)
        zs.append(z + torch.as_tensor(rng.normal(0, 0.01, z.shape),
                                      dtype=torch.float32))
    n = K * L
    g = graph.add_observations(
        graph.init_graph(M, E, "cpu"),
        torch.arange(K, dtype=torch.int32).repeat_interleave(L),
        torch.arange(L, dtype=torch.int32).repeat(K), torch.cat(zs),
        torch.full((n,), 100.0), torch.ones((n,), dtype=torch.bool))
    lm_init = lm_gt + torch.as_tensor(rng.normal(0, 0.05, (L, 3)),
                                      dtype=torch.float32)
    kf_init = kf_pose.clone()
    kf_init[1:, :3] += torch.as_tensor(rng.normal(0, 0.02, (K - 1, 3)),
                                       dtype=torch.float32)
    fixed = torch.zeros((K,), dtype=torch.bool)
    fixed[0] = True
    p = dict(kf_pose=kf_init, kf_valid=torch.ones((K,), dtype=torch.bool),
             lm_pos=lm_init, lm_valid=torch.ones((L,), dtype=torch.bool),
             g=g, fixed_kf=fixed, lm_gen=torch.zeros((L,), dtype=torch.int32),
             kf_gen=torch.zeros((K,), dtype=torch.int32))
    return _to(p, device)


def _to(p, device):
    from putslam_tpu_torch.backend.graph import GraphState

    out = {k: v.to(device) for k, v in p.items() if k != "g"}
    out["g"] = GraphState(*(x.to(device) for x in p["g"]))
    return out


def save_problem(path, bcfg, cam, kf_pose, kf_valid, lm_pos, lm_valid, g,
                 fixed_kf, lm_gen, kf_gen):
    """Write a BA problem (arrays or tensors of either package, configs as
    dataclasses) for ``--problem``."""
    from putslam_tpu_torch.utils.device import as_numpy

    arrays = dict(kf_pose=kf_pose, kf_valid=kf_valid, lm_pos=lm_pos,
                  lm_valid=lm_valid, fixed_kf=fixed_kf, lm_gen=lm_gen,
                  kf_gen=kf_gen)
    arrays = {k: as_numpy(v) for k, v in arrays.items()}
    arrays.update({GRAPH_PREFIX + f: as_numpy(getattr(g, f))
                   for f in g._fields})
    np.savez(path, backend=json.dumps(dataclasses.asdict(bcfg)),
             camera=json.dumps(None if cam is None
                               else dataclasses.asdict(cam)), **arrays)


def load_problem(path, device):
    """(bcfg, cam, problem dict) of a file written by ``save_problem``."""
    import torch

    from putslam_tpu_torch.backend.graph import GraphState
    from putslam_tpu_torch.config import BackendConfig, CameraConfig

    with np.load(path) as f:
        bcfg = BackendConfig(**json.loads(str(f["backend"])))
        cam = json.loads(str(f["camera"]))
        p = {k: torch.as_tensor(f[k], device=device) for k in
             ("kf_pose", "kf_valid", "lm_pos", "lm_valid", "fixed_kf",
              "lm_gen", "kf_gen")}
        p["g"] = GraphState(*(torch.as_tensor(f[GRAPH_PREFIX + k],
                                              device=device)
                              for k in GraphState._fields))
    return bcfg, None if cam is None else CameraConfig(**cam), p


class DenseArchive:
    """An archive reduced to what ``global_bundle_adjust`` reads: the
    arrays of ``MapArchive.dense()``."""

    def __init__(self, kf, lm, obs, pp):
        self._dense = (kf, lm, tuple(obs), tuple(pp))

    def dense(self):
        kf, lm, obs, pp = self._dense
        return kf.copy(), lm.copy(), obs, pp


def save_archive(path, cfg, archive, gba_kw):
    """Write ``archive.dense()``, the port's ``SlamConfig`` and the keyword
    arguments of ``global_bundle_adjust`` for ``--archive``."""
    kf, lm, obs, pp = archive.dense()
    arrays = {"kf": kf, "lm": lm}
    arrays.update({f"obs{i}": a for i, a in enumerate(obs)})
    arrays.update({f"pp{i}": a for i, a in enumerate(pp)})
    np.savez(path, config=json.dumps(dataclasses.asdict(cfg)),
             gba=json.dumps(gba_kw), **arrays)


def load_archive(path):
    """(cfg, DenseArchive, gba keyword arguments) of ``save_archive``'s
    file."""
    from putslam_tpu_torch.convert import config_from_jax

    with np.load(path) as f:
        cfg = config_from_jax(json.loads(str(f["config"])))
        arch = DenseArchive(f["kf"], f["lm"], [f[f"obs{i}"] for i in range(5)],
                            [f[f"pp{i}"] for i in range(4)])
        gba_kw = json.loads(str(f["gba"]))
    return cfg, arch, gba_kw


def _synchronize(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_ba(args, mesh, dev, info):
    """dist_gauss_newton on the problem; fills ``info``, returns the
    arrays for ``--out``."""
    import torch

    from putslam_tpu_torch.config import tiny_test_config
    from putslam_tpu_torch.parallel import dist_ba

    if args.problem:
        bcfg, cam, p = load_problem(args.problem, dev)
    else:
        bcfg, cam = tiny_test_config().backend, None
        p = build_problem(np.random.default_rng(42), dev)

    def call():
        return dist_ba.dist_gauss_newton(
            bcfg, mesh, p["kf_pose"], p["kf_valid"], p["lm_pos"],
            p["lm_valid"], p["g"], p["fixed_kf"], p["lm_gen"], p["kf_gen"],
            cam=cam)

    kf_out, lm_out, chi2, overflow = call()
    _synchronize(dev)
    if args.repeat:
        times = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            call()
            _synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        info["ms_per_call"] = float(np.median(times))
        n0, b0 = mesh.n_all_reduce, mesh.all_reduce_bytes
        mesh.timed = True
        call()
        mesh.timed = False
        iters = max(bcfg.gn_iterations, 1)
        info["all_reduce_calls_per_call"] = mesh.n_all_reduce - n0
        # one packed buffer an iteration; the landmark gather once a call
        # is left out
        info["all_reduce_bytes_per_iteration"] = 0 if mesh.group is None \
            else ((mesh.all_reduce_bytes - b0) - 4 * lm_out.numel()) / iters
        info["all_reduce_ms_per_call"] = 1e3 * mesh.all_reduce_s
    chi = chi2.cpu().numpy()
    info.update(chi2_final=float(chi[-1]), chi2=chi.tolist(),
                partition_overflow=int(overflow),
                finite=bool(torch.isfinite(kf_out).all()
                            and torch.isfinite(lm_out).all()))
    return dict(kf_pose=kf_out.cpu().numpy(), lm_pos=lm_out.cpu().numpy(),
                chi2=chi)


def run_global_ba(args, mesh, dev, info):
    """global_bundle_adjust(mesh=) on ``--archive``'s graph."""
    from putslam_tpu_torch.slam_map.archive import global_bundle_adjust

    cfg, arch, gba_kw = load_archive(args.archive)
    t0 = time.perf_counter()
    kf = global_bundle_adjust(cfg, arch, mesh=mesh, device=dev, **gba_kw)
    info["gba_s"] = time.perf_counter() - t0
    info["n_keyframes"] = int(len(kf))
    info["finite"] = bool(np.isfinite(kf).all())
    return dict(kf_polished=kf)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port, or a file:// or tcp:// URL")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--single", action="store_true",
                    help="no process group: --ranks virtual ranks here")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="default: nccl on "
                    "cuda, gloo on cpu")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a collective waits for a lost rank")
    ap.add_argument("--problem", default=None)
    ap.add_argument("--archive", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--repeat", type=int, default=0)
    args = ap.parse_args(argv)
    _limit_threads()

    import datetime

    import torch
    import torch.distributed as dist

    from putslam_tpu_torch.parallel import mesh as mesh_mod
    from putslam_tpu_torch.parallel import multihost
    from putslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if not args.single:
        multihost.initialize_distributed(
            args.coordinator, args.num_processes, args.process_id,
            device=dev, backend=args.backend,
            timeout=datetime.timedelta(seconds=args.timeout))
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    try:
        pid, pcount, _, _ = multihost.process_info()
        mesh = (mesh_mod.make_mesh(args.ranks, axis="lm", device=dev)
                if args.single else multihost.global_mesh(device=dev))
        info = {"process": pid, "process_count": pcount,
                "global_ranks": mesh.size, "device": str(dev),
                "backend": (None if mesh.group is None
                            else dist.get_backend(mesh.group))}
        out = run_ba(args, mesh, dev, info) if args.problem or \
            not args.archive else {}
        if args.archive:
            out.update(run_global_ba(args, mesh, dev, info))
        if args.out:
            np.savez(args.out.replace("{rank}", str(pid)), **out)
    finally:
        multihost.shutdown()
    print(json.dumps(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
