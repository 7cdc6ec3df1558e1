#!/usr/bin/env python
"""Canonical acceptance runs through the PyTorch port (the counterpart of
``tools/run_acceptance.py:29-156``): the three 640-frame disk sequences
through the engine at the ACCEPTANCE operating point, scored by the
REFERENCE's own evaluate_ate.py / evaluate_rpe.py
(``tools/run_reference_eval.py``), checked against the golden bounds of
``ACCEPTANCE_r05.json`` (read only).

Operating point (against the bench's defaults): BA every 2 keyframes × 3
Gauss-Newton iterations in the loop, the host map archive and the offline
global bundle adjustment over the full history (window 256, caps 512 /
6144 / 49152, 4 back-to-front sweeps × 10 iterations), and the dataset's
own camera.json (the synthetic renders are pure pinhole).

    python tools/run_acceptance_torch.py [--data-root data] [--device cuda]
        [--alpha A] [--override matcher.retry_hamming_slack=0] [--seed 0]

``run_engine`` is the engine half (config → the played sequence →
``run_slam_global`` → poses, archive, wall time) and needs no reference
script; ``run_one`` scores its trajectory with the reference's scripts,
which must be present (``run_reference_eval.REF_SCRIPTS``). Sequences are
written by ``tools/make_disk_dataset_torch.py``. Exit code 0 iff every
sequence present lands inside its golden bound. ``--record FILE`` writes
the results into that JSON file's ``datasets`` (off by default).
"""

import argparse
import dataclasses as dc
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

GBA = dict(window=256, kf_cap=512, lm_cap=6144, obs_cap=49152,
           sweeps=4, gn_iterations=10)
SEQUENCES = (("synth_handheld_640", "clean"),
             ("synth_handheld_640_noisy", "noisy"),
             ("synth_handheld_640_hard", "hard"))


def apply_overrides(cfg, overrides):
    """--override a.b=v entries applied onto the frozen config tree
    (``tools/run_acceptance.py:33``); v is JSON."""
    for ov in overrides or []:
        path, _, val = ov.partition("=")
        keys = path.split(".")
        v = json.loads(val)
        node = cfg
        objs = []
        for k in keys[:-1]:
            objs.append(node)
            node = getattr(node, k)
        node = dc.replace(node, **{keys[-1]: v})
        for k, parent in zip(reversed(keys[:-1]), reversed(objs)):
            node = parent.replace(**{k: node}) if hasattr(parent, "replace") \
                else dc.replace(parent, **{k: node})
        cfg = node
    return cfg


def acceptance_config(root: str, alpha=None, overrides=None):
    """The acceptance operating point on ``tum_fr1_config()``, with the
    camera of ``root``'s camera.json where there is one."""
    from putslam_tpu_torch.config import tum_fr1_config

    cfg = tum_fr1_config()
    cfg = cfg.replace(backend=dc.replace(
        cfg.backend, optimize_every_n_frames=2, gn_iterations=3))
    if alpha is not None:
        cfg = cfg.replace(pose_blend_alpha=alpha)
    cfg = apply_overrides(cfg, overrides)
    cam_json = os.path.join(root, "camera.json")
    if os.path.exists(cam_json):
        with open(cam_json) as f:
            cfg = cfg.replace(camera=dc.replace(cfg.camera, **json.load(f)))
    return cfg


def run_engine(root: str, alpha=None, overrides=None, seed=0,
               device="cuda"):
    """The engine half of ``run_one``: read the TUM-layout sequence at
    ``root``, run ``run_slam_global`` at the acceptance operating point
    (the global BA at ``GBA``). Returns a dict of
    ``poses_before`` / ``poses_after`` (T, 7), ``gt`` (T, 7), ``outs``,
    ``state``, ``archive``, ``frames``, ``wall_s`` (the engine between two
    synchronisations) and ``loader``."""
    import torch

    from putslam_tpu_torch.io import tum
    from putslam_tpu_torch.models import slam
    from putslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = acceptance_config(root, alpha, overrides)
    ds = tum.TumDataset(root, depth_scale=cfg.camera.depth_image_scale)
    n = len(ds)
    H, W = cfg.camera.height, cfg.camera.width
    grays = np.empty((n, H, W), np.uint8)
    depths = np.empty((n, H, W), np.uint16)
    scale = cfg.camera.depth_image_scale
    for i, f in enumerate(ds):
        grays[i] = np.clip(f.gray * 255 + 0.5, 0, 255)
        depths[i] = np.clip(f.depth * scale + 0.5, 0, 65535)
    _, gt = ds.groundtruth

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    pb, pa, outs, st, archive = slam.run_slam_global(
        cfg, grays, depths, init_pose=gt[0], chunk_size=64, seed=seed,
        device=dev, **GBA)
    sync()
    return dict(poses_before=pb, poses_after=pa, gt=gt[:n], outs=outs,
                state=st, archive=archive, frames=n,
                wall_s=time.perf_counter() - t0, loader=ds.loader)


def run_one(root: str, alpha=None, overrides=None, seed=0, device="cuda"):
    """``run_engine`` and the reference's scoring of its polished
    trajectory (``tools/run_acceptance.py:57``): the report of one
    sequence."""
    import run_reference_eval as rev

    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.io import tum

    r = run_engine(root, alpha, overrides, seed, device)
    n, gt, pb, pa = r["frames"], r["gt"], r["poses_before"], r["poses_after"]
    ts = np.arange(n) / 30.0
    gt_file = os.path.join(root, "groundtruth.txt")
    with tempfile.TemporaryDirectory() as td:
        ef = os.path.join(td, "est.txt")
        tum.save_trajectory(ef, ts, pa)
        ref_ate = float(rev.evaluate("ate", gt_file, ef).strip())
        ref_rpe = float(rev.evaluate(
            "rpe", gt_file, ef,
            extra=["--fixed_delta", "--delta", "1", "--delta_unit", "s"]
        ).strip())
    return {
        "frames": n,
        "ref_ate_rmse_g2o_m": round(ref_ate, 5),
        "ref_rpe_trans_g2o_m_per_s": round(ref_rpe, 5),
        "ref_ate_rmse_VO_m": round(float(
            ate_mod.ate_rmse_aligned_frames(gt, pb)), 5),
        "our_ate_rmse_g2o_m": round(float(
            ate_mod.ate_rmse_aligned_frames(gt, pa)), 5),
        "n_keyframes": r["archive"].n_keyframes(),
        "n_obs_archived": len(r["archive"].obs),
        "wall_s": round(r["wall_s"], 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--record", default=None,
                    help="write results into this ACCEPTANCE json")
    ap.add_argument("--bounds", default="ACCEPTANCE_r05.json")
    ap.add_argument("--alpha", type=float, default=None,
                    help="override cfg.pose_blend_alpha")
    ap.add_argument("--override", action="append", default=None,
                    help="config override path=jsonvalue, e.g. "
                         "matcher.retry_hamming_slack=0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with open(args.bounds) as f:
        bounds = json.load(f)["golden_bounds"]
    results = {}
    ok = True
    for name, key in SEQUENCES:
        root = os.path.join(args.data_root, name)
        if not os.path.isdir(root):
            print(f"SKIP {key}: {root} missing "
                  "(write it with tools/make_disk_dataset_torch.py)")
            continue
        r = run_one(root, alpha=args.alpha, overrides=args.override,
                    seed=args.seed, device=args.device)
        results[key] = r
        bound = bounds[f"{key}_ate_max_m"]
        good = r["ref_ate_rmse_g2o_m"] <= bound
        rpe_bound = bounds.get(f"{key}_rpe_trans_max_m_per_s")
        if rpe_bound is not None:
            good &= r["ref_rpe_trans_g2o_m_per_s"] <= rpe_bound
        ok &= good
        print(f"{key}: ATE {r['ref_ate_rmse_g2o_m']} m (bound {bound})"
              + (f" RPE {r['ref_rpe_trans_g2o_m_per_s']} (bound {rpe_bound})"
                 if rpe_bound else "")
              + f" {'OK' if good else 'FAIL'}", flush=True)
    print(json.dumps(results, indent=1))
    if args.record:
        with open(args.record) as f:
            rec = json.load(f)
        for k, v in results.items():
            rec["datasets"][k].update(v)
        with open(args.record, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
