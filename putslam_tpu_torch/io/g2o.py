"""g2o text-format graph export / import, the port's counterpart of
``putslam_tpu/io/g2o.py:52,98`` (``VERTEX_SE3:QUAT``, ``VERTEX_TRACKXYZ``,
``EDGE_SE3:QUAT``, ``EDGE_SE3_TRACKXYZ`` records). A file that either
package exports, the other imports to the same arrays.

Conventions: g2o stores quaternions as (qx qy qz qw); the engine's layout is
[t, qw qx qy qz]. Information matrices are upper-triangular row-major (21
values for 6×6, 6 values for 3×3); scalar-weighted edges export w·I. The
text is read and written on the host in numpy; ``import_graph`` returns
tensors on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from putslam_tpu_torch.backend.graph import (GraphState, add_observations,
                                             add_pose_pose, init_graph)
from putslam_tpu_torch.utils.device import as_numpy

LANDMARK_ID_BASE = 100000  # the reference's feature-id offset


def _pose_to_g2o(p) -> str:
    tx, ty, tz, qw, qx, qy, qz = [float(x) for x in p]
    return f"{tx} {ty} {tz} {qx} {qy} {qz} {qw}"


def _upper_tri(info: np.ndarray) -> str:
    n = info.shape[0]
    vals = [info[i, j] for i in range(n) for j in range(i, n)]
    return " ".join(f"{v:.6g}" for v in vals)


def _from_upper_tri(tokens, n: int) -> np.ndarray:
    """Upper-triangular row-major values → symmetric (n, n) matrix."""
    m = np.zeros((n, n), np.float32)
    it = iter(tokens)
    for i in range(n):
        for j in range(i, n):
            v = float(next(it))
            m[i, j] = v
            m[j, i] = v
    return m


def export_graph(path: str, kf_pose, kf_valid, lm_pos, lm_valid,
                 g: GraphState, lm_gen=None) -> None:
    """Write the factor graph as a .g2o file
    (``putslam_tpu/io/g2o.py:52``). Takes tensors or numpy arrays."""
    kf_pose = as_numpy(kf_pose)
    kf_valid = as_numpy(kf_valid)
    lm_pos = as_numpy(lm_pos)
    lm_valid = as_numpy(lm_valid)
    obs_kf = as_numpy(g.obs_kf)
    obs_lm = as_numpy(g.obs_lm)
    obs_xyz = as_numpy(g.obs_xyz)
    obs_w = as_numpy(g.obs_w)
    obs_ok = as_numpy(g.obs_valid)
    if lm_gen is not None:
        obs_ok = obs_ok & (as_numpy(g.obs_gen) == as_numpy(lm_gen)[obs_lm])

    with open(path, "w") as f:
        for k in np.nonzero(kf_valid)[0]:
            f.write(f"VERTEX_SE3:QUAT {k} {_pose_to_g2o(kf_pose[k])}\n")
        if kf_valid.any():
            f.write(f"FIX {int(np.nonzero(kf_valid)[0][0])}\n")
        for l in np.nonzero(lm_valid)[0]:
            x, y, z = lm_pos[l]
            f.write(f"VERTEX_TRACKXYZ {LANDMARK_ID_BASE + l} {x} {y} {z}\n")
        pp_ok = as_numpy(g.pp_valid)
        pp_i = as_numpy(g.pp_i)
        pp_j = as_numpy(g.pp_j)
        pp_rel = as_numpy(g.pp_rel)
        pp_w = as_numpy(g.pp_w)
        for e in np.nonzero(pp_ok)[0]:
            info = np.eye(6) * pp_w[e]
            f.write(f"EDGE_SE3:QUAT {pp_i[e]} {pp_j[e]} "
                    f"{_pose_to_g2o(pp_rel[e])} {_upper_tri(info)}\n")
        obs_info = as_numpy(g.obs_info)
        for e in np.nonzero(obs_ok & kf_valid[obs_kf] & lm_valid[obs_lm])[0]:
            x, y, z = obs_xyz[e]
            # the stored full information where there is one (uncertainty
            # mode), the scalar w·I otherwise
            info = (obs_info[e] if np.trace(obs_info[e]) > 0.0
                    else np.eye(3) * obs_w[e])
            f.write(f"EDGE_SE3_TRACKXYZ {obs_kf[e]} "
                    f"{LANDMARK_ID_BASE + obs_lm[e]} {x} {y} {z} "
                    f"{_upper_tri(info)}\n")


def import_graph(path: str, max_keyframes: int, max_landmarks: int,
                 max_observations: int, max_pose_pose: int, device="cpu"):
    """Read a .g2o file into array state (``putslam_tpu/io/g2o.py:98``).

    Returns (kf_pose (K,7), kf_valid, lm_pos (L,3), lm_valid, GraphState,
    fixed_kf (K,)) as tensors on ``device``."""
    kf_pose = np.tile(np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                      (max_keyframes, 1))
    kf_valid = np.zeros(max_keyframes, bool)
    fixed = np.zeros(max_keyframes, bool)
    lm_pos = np.zeros((max_landmarks, 3), np.float32)
    lm_valid = np.zeros(max_landmarks, bool)

    obs = []
    pps = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = tok[0]
            if tag == "VERTEX_SE3:QUAT":
                i = int(tok[1])
                tx, ty, tz, qx, qy, qz, qw = map(float, tok[2:9])
                kf_pose[i] = [tx, ty, tz, qw, qx, qy, qz]
                kf_valid[i] = True
            elif tag == "VERTEX_TRACKXYZ":
                l = int(tok[1]) - LANDMARK_ID_BASE
                lm_pos[l] = [float(tok[2]), float(tok[3]), float(tok[4])]
                lm_valid[l] = True
            elif tag == "FIX":
                fixed[int(tok[1])] = True
            elif tag == "EDGE_SE3:QUAT":
                if len(tok) < 11:
                    raise ValueError(
                        f"{path}: malformed EDGE_SE3:QUAT line "
                        f"(need measurement + ≥1 info value): {line.rstrip()!r}")
                i, j = int(tok[1]), int(tok[2])
                tx, ty, tz, qx, qy, qz, qw = map(float, tok[3:10])
                # the pose-pose factor has a scalar weight: the mean of the
                # information diagonal (exact for the isotropic matrices the
                # engine writes); a short line gives its first info value
                if len(tok) >= 31:
                    info6 = _from_upper_tri(tok[10:31], 6)
                    w = float(np.trace(info6) / 6.0)
                else:
                    w = float(tok[10])
                pps.append((i, j, [tx, ty, tz, qw, qx, qy, qz], w))
            elif tag == "EDGE_SE3_TRACKXYZ":
                if len(tok) < 7:
                    raise ValueError(
                        f"{path}: malformed EDGE_SE3_TRACKXYZ line "
                        f"(need measurement + ≥1 info value): {line.rstrip()!r}")
                k = int(tok[1])
                l = int(tok[2]) - LANDMARK_ID_BASE
                xyz = [float(tok[3]), float(tok[4]), float(tok[5])]
                # the full 3×3 information is kept as a matrix (whitened BA);
                # the scalar weight is its mean diagonal
                if len(tok) >= 12:
                    info3 = _from_upper_tri(tok[6:12], 3)
                    w = float(np.trace(info3) / 3.0)
                else:
                    w = float(tok[6])
                    info3 = w * np.eye(3, dtype=np.float32)
                obs.append((k, l, xyz, w, info3))

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    g = init_graph(max_observations, max_pose_pose, device)
    if obs:
        g = add_observations(
            g, dev([o[0] for o in obs], torch.int32),
            dev([o[1] for o in obs], torch.int32),
            dev([o[2] for o in obs], torch.float32),
            dev([o[3] for o in obs], torch.float32),
            torch.ones((len(obs),), dtype=torch.bool, device=device),
            info=dev(np.stack([o[4] for o in obs]), torch.float32))
    for (i, j, rel, w) in pps:
        g = add_pose_pose(g, i, j, dev(rel, torch.float32), w)

    if not fixed.any() and kf_valid.any():
        fixed[np.nonzero(kf_valid)[0][0]] = True
    return (dev(kf_pose, torch.float32), dev(kf_valid, torch.bool),
            dev(lm_pos, torch.float32), dev(lm_valid, torch.bool), g,
            dev(fixed, torch.bool))
