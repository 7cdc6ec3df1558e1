"""The check's control and faults at the tiny size on the CPU: the
reference one precision lower in the program's place comes out not
correct, and so does a run whose timed path is broken underneath (a step
that returns its state unchanged, half of a frame's keypoints left out,
an end-of-run polish that returns its state unchanged, the answer altered
where it is produced). The exchange between chips is
not a fault these one-card cells can have."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from slambench import check, run
from slambench.tests import tiny

SEED = 2 ** 31 + 777


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("name", ["tiny.offline", "tiny.live"])
def test_control_is_not_correct(root, name):
    cell = tiny.cell(root, name)
    cpu = torch.device("cpu")
    s = run.Setup(cell, SEED, cpu, pin=False)
    win = run.Window(s, cell.traffic, cpu, trace=False)
    getattr(win, cell.traffic["mode"])(0.5)
    win.close()
    seqs = run.records(win)
    det = dataclasses.asdict(s.cfg.detector)
    cam = dataclasses.asdict(s.cfg.camera)
    backend = dataclasses.asdict(s.cfg.backend)
    sound = check.numbers(seqs, det, cam, backend, cpu,
                          cell.config.get("limits"))
    assert all(ok for _, _, ok in sound.values())
    kp, bits, xyz = check.frontend_numbers(
        seqs, det, cam, cpu, feats=check.control_features(seqs, det, cam, cpu))
    reanchor = check.reanchor_gap_mm(seqs,
                                     trajs=check.control_trajectories(seqs))
    lm = check.ba_steps_mm(seqs, backend, cpu,
                           graphs=check.control_graphs(seqs))[0]
    control = {"kp_unpaired": kp, "desc_bits": bits, "xyz_gap_mm": xyz,
               "reanchor_gap_mm": reanchor, "ba_landmark_step_mm": lm}
    limits = {**check.LIMITS, **cell.config.get("limits", {})}
    assert not all(v <= limits[k] for k, v in control.items())
    for k in ("reanchor_gap_mm", "ba_landmark_step_mm"):
        assert control[k] > limits[k]


def _state_unchanged(slam, monkeypatch):
    real = slam.slam_sequence

    def step(cfg, state, *a, **kw):
        _, outs = real(cfg, state, *a, **kw)
        return state, outs
    monkeypatch.setattr(slam, "slam_sequence", step)


def _half_the_keypoints(slam, monkeypatch):
    real = slam.detect_and_describe

    def detect(cfg, gray, depth):
        f = real(cfg, gray, depth)
        keep = f.valid & (torch.cumsum(f.valid.long(), 0) % 2 == 0)
        return f._replace(valid=keep, has_depth=f.has_depth & keep)
    monkeypatch.setattr(slam, "detect_and_describe", detect)


def _finalize_unchanged(slam, monkeypatch):
    monkeypatch.setattr(slam, "finalize", lambda cfg, state, graph=None: state)


def _answer_altered(slam, monkeypatch):
    real = slam.reanchor_trajectory

    def reanchor(state, outs):
        traj = real(state, outs).clone()
        traj[:, 0] += 0.01
        return traj
    monkeypatch.setattr(slam, "reanchor_trajectory", reanchor)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_keypoints,
                                   _finalize_unchanged, _answer_altered])
@pytest.mark.parametrize("name", ["tiny.offline", "tiny.live"])
def test_fault_is_not_correct(root, name, fault, monkeypatch):
    from putslam_tpu_torch.models import slam

    fault(slam, monkeypatch)
    line = run.run_cell(tiny.cell(root, name), SEED, 0.5, False,
                        device="cpu", here=root / "slambench")
    assert line["correct"] is False


def _plant_repair(g, shift_m):
    """``g`` with a trajectory repair planted as ``finalize``'s would make
    it: the middle keyframe's odometry edge set to depart from the solve's
    motion by ``shift_m`` along x, that keyframe re-composed from the edge
    and every later keyframe moved with it, the landmarks left."""
    from slambench.reference import optimality as o

    F64 = torch.float64
    seq = g.kf_seq.long()
    pi, pj = g.pp_i.long(), g.pp_j.long()
    odo = torch.nonzero(g.pp_valid & (seq[pj] == seq[pi] + 1)
                        & (g.pp_gen_i == g.kf_gen[pi])
                        & (g.pp_gen_j == g.kf_gen[pj])).flatten()
    e = odo[torch.argsort(seq[pj[odo]])[len(odo) // 2]]
    i, j = int(pi[e]), int(pj[e])
    pose = g.kf_pose.to(F64)
    t, q = o.split(pose)
    rel = o.compose(o.inverse((t[i], q[i])), (t[j], q[j]))
    z = (rel[0] + torch.tensor([shift_m, 0.0, 0.0], dtype=F64), rel[1])
    new_j = o.compose((t[i], q[i]), z)
    move = o.compose(new_j, o.inverse((t[j], q[j])))
    later = g.kf_valid & (seq >= seq[j])
    n = int(later.sum())
    mt, mq = o.compose((move[0].expand(n, 3), move[1].expand(n, 4)),
                       (t[later], q[later]))
    pose[later] = torch.cat([mt, mq], -1)
    pp_rel = g.pp_rel.clone()
    pp_rel[e] = torch.cat(z).to(pp_rel.dtype)
    return dataclasses.replace(g, kf_pose=pose.to(g.kf_pose.dtype),
                               pp_rel=pp_rel)


@pytest.mark.parametrize("shift_m, undone", [(0.6, 1), (0.1, 0)])
def test_repair_is_undone(root, shift_m, undone):
    """``finalize``'s trajectory repair leaves the landmarks off the
    keyframes it moved: the reference undoes a repair that its own test
    demands (a departure over ``trajectory_repair_threshold``, 0.3 m) and
    reads the solve's optimum again, to within what the alignment that
    finds the moved block's motion leaves (it sees the observations, not
    the pose-pose edges: microns, and a fifth of the fr1 cell's sound
    readings at most); the same move where the test demands none (0.1 m)
    stays, and fails the landmarks' limit."""
    from slambench.reference import optimality

    cell = tiny.cell(root, "tiny.offline")
    cpu = torch.device("cpu")
    s = run.Setup(cell, SEED, cpu, pin=False)
    win = run.Window(s, cell.traffic, cpu, trace=False)
    win.offline(0.0)
    seq = run.records(win)[0]
    backend = dataclasses.asdict(s.cfg.backend)
    limit = cell.config["limits"]["ba_landmark_step_mm"]
    sound = check.ba_steps_mm([seq], backend, cpu)[0]
    planted = _plant_repair(seq.graph, shift_m)
    assert optimality.undo_repair(seq.graph, backend)[1] == 0
    assert optimality.undo_repair(planted, backend)[1] == undone
    step = check.ba_steps_mm([seq], backend, cpu, graphs=[planted])[0]
    if undone:
        assert abs(step - sound) < 0.03
    else:
        assert step > 100 * limit
