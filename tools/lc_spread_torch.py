#!/usr/bin/env python
"""Run-to-run spread of the end-of-run optimisation on the loop-closure
workload of ``chip_smoke.py`` (phase 7), on a CUDA card.

Usage (repository root, one card):
    python tools/lc_spread_torch.py [--reps 40] [--out data/lc_spread]
                                    [--no-loop-closure] [--graph]

Each repetition runs ``run_slam`` on the same 64-frame leave-and-return
sequence at the fr1 widths (every tracked frame a keyframe, loop closure
on; eagerly, as the in-loop solves are traced, or with ``--graph`` from
CUDA graphs, untraced), then ``finalize`` by hand, step by step, and appends one JSON line to
``<out>/reps.jsonl`` (a short form of it is printed): the ATE before and
after, and for each of ``finalize``'s two
``optimize_graph`` calls, and for every bundle adjustment the loop ran
(``loop_ba``), the chi² of every Gauss-Newton iteration and, per
iteration, whether the Cholesky factorisation of the reduced system failed
(``chol_info`` != 0), its smallest eigenvalue (float64 ``eigvalsh`` of the
gauge-fixed, damped matrix) as the solver builds it, with the Schur
subtrahend rounded to bfloat16, and with an unrounded float32 subtrahend,
and the largest component of the step applied (0 where it was thrown away)
and of the float64 solution of either system; how far the keyframes moved,
how many keyframes ``check_trajectory`` re-composed from odometry, and the
ATE with and without that repair. The in-loop bundle adjustment sums with atomics, so
the map that ``finalize`` receives differs from run to run on the same
code and inputs; this script shows what ``finalize`` does with each.

A repetition whose final ATE is over ``--keep-over`` metres, or whose
keyframes did not move, has its state (``utils/checkpoint.save_state``) and
its per-frame outputs written under ``--out`` for a closer look on any
machine. The last line is a summary.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES = 64


@contextlib.contextmanager
def traced_solves(opt_mod, sink):
    """Inside the block every reduced solve of ``gauss_newton_mm`` appends a
    record to ``sink``: the call it belongs to, the Cholesky's ``info``, the
    smallest eigenvalue of the gauge-fixed, damped system as the solver
    builds it (its Schur subtrahend rounded to bfloat16) and of the same
    system with an unrounded float32 subtrahend, the largest component of
    the step that was applied and of the float64 solutions of both."""
    real_solve = opt_mod._solve_reduced
    real_sub = opt_mod.schur_subtrahend_mm
    real_gn = opt_mod.gauss_newton_mm
    call = [-1]
    rounding = [None]

    def gn(*a, **kw):
        call[0] += 1
        return real_gn(*a, **kw)

    def sub(obs_kf, obs_lm, F, K, L):
        out = real_sub(obs_kf, obs_lm, F, K, L)
        G = torch.zeros(((K + 1) * (L + 1), 6, 3), dtype=torch.float32,
                        device=F.device)
        G.index_add_(0, obs_kf * (L + 1) + obs_lm, F)
        G = G.view(K + 1, L + 1, 6, 3)[:K, :L].permute(0, 2, 1, 3)
        G = G.reshape(K * 6, L * 3)
        rounding[0] = out - G @ G.T
        return out

    def solve(S, b_red, dead, lam):
        dc = real_solve(S, b_red, dead, lam)
        b = torch.where(dead.repeat_interleave(6), torch.zeros_like(b_red),
                        b_red).double()
        Sg = opt_mod._gauge_fixed(S, dead, lam)
        # a solver that rounds nothing has called no schur_subtrahend_mm
        Se = Sg if rounding[0] is None else opt_mod._gauge_fixed(
            S + rounding[0], dead, lam)
        rounding[0] = None
        _, info = torch.linalg.cholesky_ex(Sg)
        sink.append(dict(
            call=call[0], free=int((~dead).sum()), chol_info=int(info),
            min_eig=float(torch.linalg.eigvalsh(Sg.double())[0]),
            min_eig_unrounded=float(torch.linalg.eigvalsh(Se.double())[0]),
            step_max=float(dc.abs().max()),
            raw_step_max=float(torch.linalg.solve(Sg.double(),
                                                  b).abs().max()),
            unrounded_step_max=float(torch.linalg.solve(Se.double(),
                                                        b).abs().max())))
        return dc

    opt_mod._solve_reduced = solve
    opt_mod.schur_subtrahend_mm = sub
    opt_mod.gauss_newton_mm = gn
    try:
        yield
    finally:
        opt_mod._solve_reduced = real_solve
        opt_mod.schur_subtrahend_mm = real_sub
        opt_mod.gauss_newton_mm = real_gn


def finalize_traced(cfg, state, slam, opt_mod, graph_mod):
    """``models.slam.finalize`` with every reduced solve recorded. Returns
    (final state, state before the trajectory repair, record)."""
    solves = []

    m, g = state.map, state.graph
    bcfg = dataclasses.replace(cfg.backend,
                               gn_iterations=cfg.backend.final_gn_iterations,
                               ba_window=0)
    lm_valid = m.lm_valid & (m.lm_n_obs >= cfg.backend.final_min_obs)
    seqs = torch.where(m.kf_valid, m.kf_seq,
                       torch.full_like(m.kf_seq, np.iinfo(np.int32).max))
    fixed = torch.zeros_like(m.kf_valid)
    fixed[torch.argmin(seqs)] = True
    passes = []
    with traced_solves(opt_mod, solves):
        res1 = opt_mod.optimize_graph(bcfg, m.kf_pose, m.kf_valid, m.lm_pos,
                                      lm_valid, g, fixed, lm_gen=m.lm_gen,
                                      kf_gen=m.kf_gen, cam=cfg.camera)
        passes.append(dict(chi2=[float(c) for c in res1.chi2],
                           solves=list(solves)))
        solves.clear()
        prune = res1.obs_sq_err > cfg.backend.chi2_prune_threshold
        g = graph_mod.prune_observations(g, prune)
        res2 = opt_mod.optimize_graph(bcfg, res1.kf_pose, m.kf_valid,
                                      res1.lm_pos, lm_valid, g, fixed,
                                      lm_gen=m.lm_gen, kf_gen=m.kf_gen,
                                      cam=cfg.camera)
        passes.append(dict(chi2=[float(c) for c in res2.chi2],
                           solves=list(solves)))
    moved = float((res2.kf_pose - m.kf_pose)[m.kf_valid][:, :3].norm(
        dim=-1).max())
    m2 = m._replace(kf_pose=res2.kf_pose, lm_pos=res2.lm_pos,
                    lm_valid=lm_valid)
    unrepaired = state._replace(map=m2, graph=g)
    kf_repaired, n_bad = slam.check_trajectory(cfg, m2, g)
    final = state._replace(map=m2._replace(kf_pose=kf_repaired), graph=g)
    rec = dict(passes=passes, pruned=int((prune & state.graph.obs_valid).sum()),
               kf_moved_m=moved, repaired=int(n_bad))
    return final, unrepaired, rec


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--out", default="data/lc_spread")
    ap.add_argument("--keep-over", type=float, default=0.02)
    ap.add_argument("--no-loop-closure", action="store_true")
    ap.add_argument("--graph", action="store_true",
                    help="replay the frames from one CUDA graph each (the "
                         "card's default path); its in-loop solves, inside "
                         "the graph, are not traced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from putslam_tpu_torch.backend import graph as graph_mod
    from putslam_tpu_torch.backend import optimize as opt_mod
    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.eval import ate as ate_mod
    from putslam_tpu_torch.geometry import se3
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.models import slam
    from putslam_tpu_torch.utils import checkpoint, control

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = tum_fr1_config()
    cfg = cfg.replace(
        map=dataclasses.replace(
            cfg.map, add_features_when_measurements_less_than=10,
            max_keyframes=64, min_keyframe_matches=10_000),
        loop_closure=dataclasses.replace(
            cfg.loop_closure, enabled=not args.no_loop_closure, tail_skip=10))
    poses = synthetic.revisit_trajectory(FRAMES, sweep=1.2, device=dev)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    gt = poses.cpu().numpy()
    os.makedirs(args.out, exist_ok=True)

    def ate_of(state, outs, pb):
        pa = np.concatenate(
            [pb[:1], slam.reanchor_trajectory(state, outs).cpu().numpy()], 0)
        return ate_mod.ate_rmse_aligned_frames(gt, pa)

    rows = []
    for rep in range(args.reps):
        loop_solves = []
        if args.graph:
            pb, outs, state = slam.run_slam(cfg, grays, depths,
                                            init_pose=gt[0], device=dev,
                                            graph=True)
        else:
            # the traced solves read the card: the frames run eagerly, each
            # branch read on the host, so the Gauss-Newton loop stops where
            # its chi² test says, as the captured frame's does on the card
            with traced_solves(opt_mod, loop_solves), \
                    control.branching("host"):
                pb, outs, state = slam.run_slam(cfg, grays, depths,
                                                init_pose=gt[0], device=dev,
                                                graph=False)
        # the in-loop BA calls: frame, chi² at each iteration, their solves
        loop_ba = [dict(frame=int(i) + 1,
                        chi2=[float(c) for c in outs.chi2[i]],
                        solves=[s for s in loop_solves if s["call"] == n])
                   for n, i in enumerate(np.nonzero(outs.ba_ran)[0])]
        final, unrepaired, rec = finalize_traced(cfg, state, slam, opt_mod,
                                                 graph_mod)
        # accepted loop-closure edges against the true relative poses
        g, m = state.graph, state.map
        is_lc = (g.pp_valid & (m.kf_seq[g.pp_j] != m.kf_seq[g.pp_i] + 1)).cpu()
        lc_err = []
        for e in torch.nonzero(is_lc)[:, 0].tolist():
            si, sj = int(m.kf_seq[g.pp_i[e]]), int(m.kf_seq[g.pp_j[e]])
            true_rel = se3.relative(poses[si].cpu(), poses[sj].cpu())
            lc_err.append(round(float(torch.linalg.norm(
                se3.translation(g.pp_rel[e].cpu())
                - se3.translation(true_rel))), 5))
        rec.update(rep=rep, loop_ba=loop_ba, lc_edges=int(state.n_lc_edges),
                   lc_edge_t_err_max=max(lc_err, default=0.0),
                   ate_before=ate_mod.ate_rmse_aligned_frames(gt, pb),
                   ate_final=ate_of(final, outs, pb),
                   ate_final_unrepaired=ate_of(unrepaired, outs, pb))
        rows.append(rec)
        with open(os.path.join(args.out, "reps.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        solves = [s for p in rec["passes"] for s in p["solves"]]
        print(json.dumps(dict(
            {k: v for k, v in rec.items() if k not in ("passes", "loop_ba")},
            loop_chi2_rise_max=max(b["chi2"][-1] / b["chi2"][0]
                                   for b in loop_ba),
            chi2=[[p["chi2"][0], min(p["chi2"]), p["chi2"][-1]]
                  for p in rec["passes"]],
            chol_failures=sum(s["chol_info"] != 0 for s in solves),
            min_eig=min(s["min_eig"] for s in solves),
            step_max=max(s["step_max"] for s in solves))), flush=True)
        if rec["ate_final"] > args.keep_over or rec["kf_moved_m"] == 0.0:
            checkpoint.save_state(os.path.join(args.out, f"state_{rep}.npz"),
                                  state)
            np.savez_compressed(os.path.join(args.out, f"outs_{rep}.npz"),
                                poses_before=pb, gt=gt, **outs._asdict())

    ates = np.array([r["ate_final"] for r in rows])
    summary = dict(
        device=smi, reps=args.reps, loop_closure=not args.no_loop_closure,
        graph=args.graph,
        ate_final_min=float(ates.min()), ate_final_median=float(np.median(ates)),
        ate_final_max=float(ates.max()),
        over_0p05=int((ates >= 0.05).sum()),
        stalled=sum(r["kf_moved_m"] == 0.0 for r in rows),
        chol_failures=sum(s["chol_info"] != 0 for r in rows
                          for p in r["passes"] for s in p["solves"]),
        solves=sum(len(p["solves"]) for r in rows for p in r["passes"]),
        chi2_rose=sum(any(b > a for a, b in zip(p["chi2"], p["chi2"][1:]))
                      for r in rows for p in r["passes"]),
        loop_ba_calls=sum(len(r["loop_ba"]) for r in rows),
        loop_ba_chi2_doubled=sum(b["chi2"][-1] > 2 * b["chi2"][0]
                                 for r in rows for b in r["loop_ba"]),
        repaired=sum(r["repaired"] for r in rows))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(dict(summary=summary, rows=rows), f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
