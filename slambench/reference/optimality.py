"""How far the program's final graph is from its own optimum, worked out
again in plain PyTorch float64 from the final state: the map's keyframe
poses and landmarks and the graph's pose-landmark and pose-pose edges, as
``finalize`` leaves them. Imports nothing of the port.

The objective is ``finalize``'s: the 3D Euclidean observation factor
r = T_kf⁻¹(l) − z with its scalar weight, the pose-pose factor
r = log(Z⁻¹ ∘ T_i⁻¹ ∘ T_j) with its weight, each squared error under the
robust kernel (IRLS weight w(e²)). At a Gauss-Newton fixed point the
gradient Σ Jᵀ·w·r vanishes; its size is read as the step one
Gauss-Newton iteration would take, each variable alone with the others
held (a landmark: −g / Σw; a keyframe: its 6×6 observation block solved
against its gradient, pose-pose terms included), in millimetres.

``finalize`` ends with a trajectory repair: walking the keyframes in
sequence order, where the solve's motion from the previous keyframe
departs from the keyframe's odometry edge by more than
``trajectory_repair_threshold`` (translation, metres), that keyframe is
re-composed from the edge, and every later keyframe moves with it, the
landmarks staying where the solve put them. So a repaired graph is not at
the solve's optimum by design. ``undo_repair`` works the solve's poses out
again before the steps are read: a keyframe whose final motion from its
predecessor is its odometry edge to rounding opens a block of keyframes
that moved as one rigid body; each block's motion is found again by
aligning its observations onto the landmarks (Horn's method, weighted
under the robust kernel), and a block is kept only where the motion so
restored departs from the edge by more than the threshold, as the repair's
own test demands.

A pose is ``[tx, ty, tz, qw, qx, qy, qz]`` (camera→world); a keyframe is
perturbed on the right, T ∘ exp(ξ), ξ = (translation, rotation).
"""

from __future__ import annotations

import dataclasses

import torch

F64 = torch.float64


@dataclasses.dataclass
class Graph:
    """The final map and graph on the host (torch tensors)."""
    kf_pose: torch.Tensor       # (K, 7)
    kf_valid: torch.Tensor      # (K,) bool
    kf_gen: torch.Tensor        # (K,)
    kf_seq: torch.Tensor        # (K,)
    lm_pos: torch.Tensor        # (L, 3)
    lm_valid: torch.Tensor      # (L,) bool
    lm_gen: torch.Tensor        # (L,)
    obs_kf: torch.Tensor        # (M,)
    obs_lm: torch.Tensor        # (M,)
    obs_xyz: torch.Tensor       # (M, 3) camera-frame measurement
    obs_w: torch.Tensor         # (M,)
    obs_valid: torch.Tensor     # (M,) bool
    obs_gen: torch.Tensor       # (M,)
    obs_kfgen: torch.Tensor     # (M,)
    pp_i: torch.Tensor          # (P,)
    pp_j: torch.Tensor          # (P,)
    pp_rel: torch.Tensor        # (P, 7)
    pp_w: torch.Tensor          # (P,)
    pp_valid: torch.Tensor      # (P,) bool
    pp_gen_i: torch.Tensor      # (P,)
    pp_gen_j: torch.Tensor      # (P,)


def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qconj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qrot(q, v):
    w, u = q[..., :1], q[..., 1:]
    t = 2.0 * torch.linalg.cross(u, v)
    return v + w * t + torch.linalg.cross(u, t)


def compose(a, b):
    """a ∘ b as (t, q)."""
    ta, qa = a
    tb, qb = b
    return ta + qrot(qa, tb), qmul(qa, qb)


def inverse(p):
    t, q = p
    qc = qconj(q)
    return -qrot(qc, t), qc


def split(pose):
    q = pose[..., 3:]
    return pose[..., :3], q / torch.linalg.norm(q, dim=-1, keepdim=True)


def perturbed(pose, xi):
    """T ∘ exp(ξ) to first order in ξ (exact in its gradient at ξ = 0)."""
    dq = torch.cat([torch.ones_like(xi[..., :1]), 0.5 * xi[..., 3:]], -1)
    dq = dq / torch.linalg.norm(dq, dim=-1, keepdim=True)
    return compose(split(pose), (xi[..., :3], dq))


def se3_log(p):
    """log of (t, q) as (ρ, φ) ∈ R⁶: φ the rotation vector, ρ = V(φ)⁻¹ t."""
    t, q = p
    q = torch.where(q[..., :1] < 0, -q, q)
    v = q[..., 1:]
    s = torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-30)
    theta = 2.0 * torch.atan2(s, q[..., :1])
    phi = (theta / s) * v
    # V⁻¹ = I − ½Φ + c·Φ², c = (1 − θ sinθ / (2(1 − cosθ))) / θ²
    small = theta < 1e-4
    th = torch.where(small, torch.ones_like(theta), theta)
    c = torch.where(small, torch.full_like(theta, 1.0 / 12.0),
                    (1.0 - th * torch.sin(th) / (2.0 * (1.0 - torch.cos(th))))
                    / (th * th))
    pxt = torch.linalg.cross(phi, t)
    rho = t - 0.5 * pxt + c * torch.linalg.cross(phi, pxt)
    return torch.cat([rho, phi], dim=-1)


def robust_weight(sq, kind: str, delta: float):
    if kind == "none":
        return torch.ones_like(sq)
    if kind == "cauchy":
        return 1.0 / (1.0 + sq / (delta * delta))
    if kind == "huber":
        e = torch.sqrt(torch.clamp(sq, min=1e-20))
        return torch.where(e <= delta, torch.ones_like(e), delta / e)
    raise ValueError(f"unknown robust kernel {kind!r}")


def _terms(d):
    """The live observations (keyframe, landmark, camera-frame measurement,
    weight) and the live pose-pose edges (i, j, measurement, weight) of the
    graph's tensors ``d``."""
    okf, olm = d["obs_kf"].long(), d["obs_lm"].long()
    live = d["obs_valid"] & d["lm_valid"][olm] \
        & (d["obs_gen"] == d["lm_gen"][olm]) \
        & (d["obs_kfgen"] == d["kf_gen"][okf]) & d["kf_valid"][okf]
    pi, pj = d["pp_i"].long(), d["pp_j"].long()
    plive = d["pp_valid"] & (d["pp_gen_i"] == d["kf_gen"][pi]) \
        & (d["pp_gen_j"] == d["kf_gen"][pj])
    return (okf[live], olm[live], d["obs_xyz"][live].to(F64),
            d["obs_w"][live].to(F64), pi[plive], pj[plive],
            d["pp_rel"][plive].to(F64), d["pp_w"][plive].to(F64))


def gradient(g: Graph, backend: dict, device="cpu"):
    """The objective's gradient at the final state: (keyframes (K, 6),
    landmarks (L, 3)), with what ``steps`` reads of the live observations
    (keyframe and landmark index, robust weight, camera-frame point)."""
    if backend["error_type"] != 0 or backend["use_obs_info"]:
        raise NotImplementedError("the Euclidean factor with scalar "
                                  "weights is the one written out here")
    d = {f.name: getattr(g, f.name).to(device) for f in dataclasses.fields(g)}
    kf_pose, lm_pos = d["kf_pose"].to(F64), d["lm_pos"].to(F64)
    K, L = len(kf_pose), len(lm_pos)
    okf, olm, z, w_info, pi, pj, zpp, wpp_info = _terms(d)
    kind, delta = backend["robust_kernel"], float(backend["robust_delta"])

    xi = torch.zeros(K, 6, dtype=F64, device=device, requires_grad=True)
    dl = torch.zeros(L, 3, dtype=F64, device=device, requires_grad=True)
    t, q = perturbed(kf_pose, xi)
    lm = lm_pos + dl
    tinv, qinv = inverse((t, q))
    p_cam = tinv[okf] + qrot(qinv[okf], lm[olm])
    r = p_cam - z
    w = w_info * robust_weight(w_info * (r * r).sum(-1).detach(), kind,
                               delta)
    rpp = se3_log(compose(inverse(split(zpp)),
                          compose(inverse((t[pi], q[pi])), (t[pj], q[pj]))))
    wpp = wpp_info * robust_weight(wpp_info * (rpp * rpp).sum(-1).detach(),
                                   kind, delta)
    cost = 0.5 * (w * (r * r).sum(-1)).sum() \
        + 0.5 * (wpp * (rpp * rpp).sum(-1)).sum()
    g_xi, g_l = torch.autograd.grad(cost, (xi, dl))
    return g_xi, g_l, (okf, olm, w.detach(), p_cam.detach(), d)


REPAIR_TOL_M = 1e-5     # a repaired motion is its odometry edge to rounding
REPAIR_TOL_RAD = 1e-5
ALIGN_ROUNDS = 8        # reweighted Horn alignments a block


def _horn(x, y, w):
    """The rigid motion (t, q) taking points ``x`` onto ``y`` (N, 3) in the
    weighted least-squares sense: Horn's quaternion method."""
    w = w / w.sum()
    mx, my = (w[:, None] * x).sum(0), (w[:, None] * y).sum(0)
    S = ((x - mx) * w[:, None]).T @ (y - my)
    tr = S[0, 0] + S[1, 1] + S[2, 2]
    N = torch.stack([
        torch.stack([tr, S[1, 2] - S[2, 1], S[2, 0] - S[0, 2],
                     S[0, 1] - S[1, 0]]),
        torch.stack([S[1, 2] - S[2, 1], S[0, 0] - S[1, 1] - S[2, 2],
                     S[0, 1] + S[1, 0], S[2, 0] + S[0, 2]]),
        torch.stack([S[2, 0] - S[0, 2], S[0, 1] + S[1, 0],
                     S[1, 1] - S[0, 0] - S[2, 2], S[1, 2] + S[2, 1]]),
        torch.stack([S[0, 1] - S[1, 0], S[2, 0] + S[0, 2],
                     S[1, 2] + S[2, 1], S[2, 2] - S[0, 0] - S[1, 1]])])
    q = torch.linalg.eigh(N).eigenvectors[:, -1]
    return my - qrot(q, mx), q


def undo_repair(g: Graph, backend: dict, device="cpu"):
    """(the graph with the keyframe poses that ``finalize``'s solve left,
    before its trajectory repair, the number of repairs undone)."""
    thr = float(backend.get("trajectory_repair_threshold", 0.0))
    if thr <= 0:
        return g, 0
    d = {f.name: getattr(g, f.name).to(device) for f in dataclasses.fields(g)}
    okf, olm, z, w_info, pi, pj, zpp, _ = _terms(d)
    kf = split(d["kf_pose"].to(F64))
    seq = d["kf_seq"].long()
    odo = (seq[pj] == seq[pi] + 1) & d["kf_valid"][pi] & d["kf_valid"][pj]
    pi, pj, zpp = pi[odo], pj[odo], split(zpp[odo])
    # candidates: a keyframe whose final motion is its odometry edge
    rel = compose(inverse((kf[0][pi], kf[1][pi])), (kf[0][pj], kf[1][pj]))
    dt = torch.linalg.norm(rel[0] - zpp[0], dim=-1)
    dang = 2.0 * torch.arccos(torch.clamp(
        torch.abs((rel[1] * zpp[1]).sum(-1)), max=1.0))
    cand = (dt < REPAIR_TOL_M) & (dang < REPAIR_TOL_RAD)
    pi, pj, zt = pi[cand], pj[cand], zpp[0][cand]
    kind, delta = backend["robust_kernel"], float(backend["robust_delta"])
    x_world = kf[0][okf] + qrot(kf[1][okf], z)       # observations, final
    y = d["lm_pos"].to(F64)[olm]
    keep = torch.ones(len(pj), dtype=torch.bool, device=device)
    while True:
        # block of each keyframe: the kept boundaries at or before it
        start = seq[pj[keep]]
        block = (seq[:, None] >= start[None, :]).sum(-1)
        t, q = kf[0].clone(), kf[1].clone()
        for b in range(1, len(start) + 1):
            sel = block[okf] == b
            if not bool(sel.any()):
                continue
            w = w_info[sel]
            for _ in range(ALIGN_ROUNDS):
                et, eq = _horn(x_world[sel], y[sel], w)
                r = y[sel] - (et + qrot(eq.expand(len(w), 4), x_world[sel]))
                w = w_info[sel] * robust_weight(
                    w_info[sel] * (r * r).sum(-1), kind, delta)
            mine = (block == b) & d["kf_valid"]
            n = int(mine.sum())
            t[mine], q[mine] = compose((et.expand(n, 3), eq.expand(n, 4)),
                                       (kf[0][mine], kf[1][mine]))
        # the repair's own test on the motion restored
        rt = compose(inverse((t[pi], q[pi])), (t[pj], q[pj]))[0]
        repaired = torch.linalg.norm(rt - zt, dim=-1) > thr
        if bool((repaired | ~keep).all()):
            break
        keep &= repaired
    if not bool(keep.any()):
        return g, 0
    moved = (block > 0) & d["kf_valid"]
    pose = d["kf_pose"].to(F64).clone()
    pose[moved] = torch.cat([t, q], dim=-1)[moved]
    return dataclasses.replace(g, kf_pose=pose.to(g.kf_pose.device)), \
        int(keep.sum())


def steps(g: Graph, backend: dict, device="cpu"):
    """(landmark steps (live landmarks,) m, keyframe translation steps
    (free keyframes,) m, keyframe rotation steps (free keyframes,) rad) of
    one Gauss-Newton iteration at the final state, each variable alone,
    the trajectory repair undone."""
    g = undo_repair(g, backend, device)[0]
    g_xi, g_l, (okf, olm, w, pc, d) = gradient(g, backend, device)
    K, L = len(g_xi), len(g_l)
    with torch.no_grad():
        wsum_l = torch.zeros(L, dtype=F64, device=device).index_add_(
            0, olm, w)
        live_l = d["lm_valid"] & (wsum_l > 0)
        step_l = torch.linalg.norm(g_l[live_l], dim=-1) / wsum_l[live_l]
        # a keyframe's 6×6 block of its observations: J = [−I | [p]ₓ]
        J = torch.zeros(len(pc), 3, 6, dtype=F64, device=device)
        J[:, :, :3] = -torch.eye(3, dtype=F64, device=device)
        J[:, 0, 4], J[:, 0, 5] = -pc[:, 2], pc[:, 1]
        J[:, 1, 3], J[:, 1, 5] = pc[:, 2], -pc[:, 0]
        J[:, 2, 3], J[:, 2, 4] = -pc[:, 1], pc[:, 0]
        H = torch.zeros(K, 6, 6, dtype=F64, device=device).index_add_(
            0, okf, w[:, None, None] * J.transpose(1, 2) @ J)
        seqs = torch.where(d["kf_valid"], d["kf_seq"].long(),
                           torch.full_like(d["kf_seq"].long(), 2 ** 62))
        free = d["kf_valid"].clone()
        free[torch.argmin(seqs)] = False
        free &= torch.linalg.matrix_rank(H) == 6
        step = -torch.linalg.solve(H[free], g_xi[free])
    return (step_l.cpu(), torch.linalg.norm(step[:, :3], dim=-1).cpu(),
            torch.linalg.norm(step[:, 3:], dim=-1).cpu())
