"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``reference/``).

For every sequence the window ran, once the window has closed:

- the front end: the keypoints, descriptors and 3D points of the
  sequence's last frame, which the final state holds (``prev_feat``),
  against ``reference.frontend`` on the same decoded images: the share of
  keypoints that find no partner (same level, within ``PAIR_PX``), the
  share of differing descriptor tests among the partners, the largest gap
  between their 3D points;
- the map, the BA and ``finalize``: how far the final graph (keyframe
  poses, landmarks, their observations and pose-pose edges) lies from the
  optimum of ``finalize``'s own objective, worked out again by
  ``reference.optimality``: the median step one Gauss-Newton iteration
  would move a landmark, the largest over the sequences (the keyframes'
  steps are printed beside it: no limit holds them yet, PERF.md);
- the final trajectory: against the reference's re-anchoring of the
  frames' emitted poses on the final keyframe poses (the largest gap).

The keyframes' optimality steps and the trajectory against the
generator's ground truth (ATE, and the
relative pose error of the emitted poses and of the final trajectory) are
printed beside these (``info``) and not compared: against the ground truth
the program's own estimation noise (about 15 mm a frame) exceeds what any
precision step adds, so no control separates it from sound runs; the
keyframes' largest median step reads too close to its control (PERF.md).

Each limit below lies between the largest reading of sound runs over a
dozen seeds or more and the smallest reading of the control (the
reference one precision lower in the program's place: bfloat16 for the
float32 stages, float8 for the descriptor's bfloat16 product), as PERF.md
records; a configuration's ``limits`` replace them where its own readings
differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slambench.gen import ate
from slambench.reference import frontend, optimality, poses as ref_poses

PAIR_PX = 0.05          # keypoints closer than this (level-0 px) pair up

# a number passes when it is at most its limit (PERF.md gives the readings
# each limit was set from)
LIMITS = {
    "kp_unpaired": 0.01,
    "desc_bits": 0.006,
    "xyz_gap_mm": 0.01,
    "reanchor_gap_mm": 0.05,
    "ba_landmark_step_mm": 1.0,
}


@dataclasses.dataclass
class Sequence:
    """What the check needs of one sequence the window ran, on the host."""
    gt: np.ndarray              # (T, 7) ground truth
    gray: torch.Tensor          # (H, W) uint8, the last frame
    depth: torch.Tensor         # (H, W) uint16 counts, the last frame
    traj: np.ndarray            # (T, 7) the final re-anchored trajectory
    outs: dict                  # per-frame outputs (T - 1, ...) numpy
    feat: dict                  # the last frame's features, numpy
    kf_pose: np.ndarray         # (K, 7) final keyframe poses
    kf_seq: np.ndarray          # (K,)
    graph: optimality.Graph     # the final map and graph


def frontend_numbers(seqs, det, cam, device, dtype=torch.float32,
                     desc_dtype=torch.bfloat16, feats=None):
    """(kp_unpaired, desc_bits, xyz_gap_mm) over the last frames of
    ``seqs``: the program's features (or ``feats``, the control's) against
    the reference's at ``dtype`` / ``desc_dtype``."""
    unpaired = total = bits = pairs = 0
    gap = 0.0
    for k, s in enumerate(seqs):
        depth = s.depth.view(torch.int16).to(torch.int32) & 0xFFFF
        ref = frontend.keypoints(s.gray.to(device), depth.to(device), det,
                                 cam)
        if feats is None:
            f = s.feat
            got = dict(uv=f["uv"], octave=f["octave"], valid=f["valid"],
                       desc=f["desc"] > 0, xyz=f["xyz"],
                       has_depth=f["has_depth"])
        else:
            c = feats[k]
            got = {n: getattr(c, n).cpu().numpy() for n in
                   ("uv", "octave", "valid", "desc", "xyz", "has_depth")}
        r = {n: getattr(ref, n).cpu().numpy() for n in
             ("uv", "octave", "valid", "desc", "xyz", "has_depth")}
        u, t, b, p, g = _pair(got, r)
        unpaired, total, bits, pairs = unpaired + u, total + t, bits + b, pairs + p
        gap = max(gap, g)
    return (unpaired / max(total, 1), bits / max(256 * pairs, 1),
            1e3 * gap)


def control_features(seqs, det, cam, device):
    """The control's features: the reference one precision lower."""
    out = []
    for s in seqs:
        depth = s.depth.view(torch.int16).to(torch.int32) & 0xFFFF
        out.append(frontend.keypoints(
            s.gray.to(device), depth.to(device), det, cam,
            dtype=torch.bfloat16, desc_dtype=torch.float8_e4m3fn))
    return out


def _pair(a, b):
    """Mutual pairs of valid keypoints of one level within PAIR_PX:
    (unpaired, total, differing tests, pairs, largest 3D gap m)."""
    unpaired = total = bits = pairs = 0
    gap = 0.0
    for lvl in np.union1d(a["octave"][a["valid"]], b["octave"][b["valid"]]):
        ia = np.flatnonzero(a["valid"] & (a["octave"] == lvl))
        ib = np.flatnonzero(b["valid"] & (b["octave"] == lvl))
        total += len(ia) + len(ib)
        if not len(ia) or not len(ib):
            unpaired += len(ia) + len(ib)
            continue
        d = np.abs(a["uv"][ia][:, None, :].astype(np.float64)
                   - b["uv"][ib][None, :, :]).max(-1)
        ja, jb = d.argmin(1), d.argmin(0)
        mutual = (jb[ja] == np.arange(len(ia))) & (d.min(1) <= PAIR_PX)
        pa, pb = ia[mutual], ib[ja[mutual]]
        same_depth = a["has_depth"][pa] == b["has_depth"][pb]
        pa, pb = pa[same_depth], pb[same_depth]
        unpaired += len(ia) + len(ib) - 2 * len(pa)
        pairs += len(pa)
        bits += int(np.sum(a["desc"][pa] != b["desc"][pb]))
        both = a["has_depth"][pa]
        if both.any():
            gap = max(gap, float(np.max(np.linalg.norm(
                a["xyz"][pa][both].astype(np.float64) - b["xyz"][pb][both],
                axis=-1))))
    return unpaired, total, bits, pairs, gap


def reanchor_gap_mm(seqs, dtype=np.float64, trajs=None):
    """Largest gap (mm) between each final trajectory (or ``trajs``, the
    control's) and the reference's re-anchoring at ``dtype``."""
    gap = 0.0
    for k, s in enumerate(seqs):
        o = s.outs
        ref = ref_poses.reanchor(o["pose"], o["anchor_ring"], o["anchor_seq"],
                                 o["anchor_pose"], s.kf_pose, s.kf_seq)
        got = s.traj[1:] if trajs is None else trajs[k]
        gap = max(gap, float(np.max(np.linalg.norm(
            np.asarray(got, np.float64)[:, :3] - ref[:, :3], axis=-1))))
    return 1e3 * gap


def control_trajectories(seqs):
    """The control's re-anchored trajectories: the reference's in bfloat16."""
    return [ref_poses.reanchor(s.outs["pose"], s.outs["anchor_ring"],
                               s.outs["anchor_seq"], s.outs["anchor_pose"],
                               s.kf_pose, s.kf_seq, dtype=torch.bfloat16)
            for s in seqs]


def ba_steps_mm(seqs, backend: dict, device, graphs=None):
    """(landmark, keyframe, keyframe pooled): the largest over the
    sequences of the median step (mm) one Gauss-Newton iteration of
    ``finalize``'s objective would take at each final graph (or ``graphs``,
    the control's), each variable alone (``reference.optimality``), and the
    median keyframe step over all sequences together."""
    lm = kf = 0.0
    pooled = []
    for k, s in enumerate(seqs):
        g = s.graph if graphs is None else graphs[k]
        step_l, step_t, _ = optimality.steps(g, backend, device)
        lm = max(lm, 1e3 * float(step_l.median()) if len(step_l) else 0.0)
        kf = max(kf, 1e3 * float(step_t.median()) if len(step_t) else 0.0)
        pooled.append(step_t)
    pooled = torch.cat(pooled)
    return lm, kf, 1e3 * float(pooled.median()) if len(pooled) else 0.0


def control_graphs(seqs):
    """The control's final graphs: the optimum as a bfloat16 solve could
    hold it at best, the final poses and landmarks rounded to bfloat16."""
    def bf16(x):
        return x.to(torch.bfloat16).to(x.dtype)
    return [dataclasses.replace(s.graph, kf_pose=bf16(s.graph.kf_pose),
                                lm_pos=bf16(s.graph.lm_pos)) for s in seqs]


def emitted(s: Sequence) -> np.ndarray:
    """(T, 7) the poses the tracker emitted frame by frame, frame 0 the
    initial pose."""
    return np.concatenate([s.gt[:1], s.outs["pose"]]).astype(np.float64)


def motion_errors(gt, est, span: int):
    """(translation mm, rotation deg) of the error of ``est``'s motion over
    every ``span`` frames against ``gt``'s: the relative pose error (RPE)."""
    gt, est = np.asarray(gt, np.float64), np.asarray(est, np.float64)
    if len(gt) <= span:
        return np.zeros(0), np.zeros(0)
    e = ref_poses.relative(ref_poses.relative(gt[:-span], gt[span:]),
                           ref_poses.relative(est[:-span], est[span:]))
    ang = 2.0 * np.arctan2(np.linalg.norm(e[:, 4:], axis=-1),
                           np.abs(e[:, 3]))
    return 1e3 * np.linalg.norm(e[:, :3], axis=-1), np.degrees(ang)


def rpe_info(seqs) -> dict:
    """The median translation RPE (mm) over every frame of every sequence:
    of the emitted poses frame to frame, and of the final trajectory over
    30 frames (1 s)."""
    out = {}
    for name, span, pick in (("track_rpe1_mm", 1, emitted),
                             ("final_rpe30_mm", 30, lambda s: s.traj)):
        t = np.concatenate([motion_errors(s.gt, pick(s), span)[0]
                            for s in seqs])
        out[name] = float(np.median(t)) if len(t) else float("nan")
    return out


def ate_rmse_mm(seqs):
    """ATE RMSE (mm) over every frame of every sequence, each sequence
    aligned onto its ground truth by Horn's method."""
    err = np.concatenate([ate.aligned_errors(s.gt, s.traj) for s in seqs])
    return 1e3 * float(np.sqrt(np.mean(err ** 2)))


def numbers(seqs, det, cam, backend, device, limits=None):
    """Every number compared, each as (value, limit, passes); ``limits``
    (a configuration's own) replace ``LIMITS``' entries."""
    kp, bits, xyz = frontend_numbers(seqs, det, cam, device)
    out = {"kp_unpaired": kp, "desc_bits": bits, "xyz_gap_mm": xyz,
           "reanchor_gap_mm": reanchor_gap_mm(seqs),
           "ba_landmark_step_mm": ba_steps_mm(seqs, backend, device)[0]}
    lim = {**LIMITS, **(limits or {})}
    return {k: (v, lim[k], bool(v <= lim[k])) for k, v in out.items()}
