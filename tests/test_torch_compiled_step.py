"""The compiled frame reads nothing back from the device but its branches.

``models/compiled.py`` captures the SLAM frame (``slam.slam_frame``: the
track part, the keyframe bookkeeping, the bundle adjustment and the
frame's end, every data-dependent branch a ``control.cond``) and the
VO-only step into CUDA graphs, where a host read cannot happen and each
branch is a conditional node that the card decides. On the CPU the runner
(``capture=False``) reads each branch's predicate on the host instead
(``control.branching("host")``); the frame runs under a dispatch mode that
raises on every other operator that would read the device from the host:
``aten._local_scalar_dense`` (``.item()``, ``bool()``, ``int()``, 0-d tensor
indexing) outside a predicate read, ``aten.nonzero`` (a data-dependent
shape) and ``aten.lift_fresh`` (a tensor made from host data, a host →
device copy on the card). The bundle adjustment runs inside the frame and
is checked with it; so is the guard that a branch body writes only to
tensors it made (``control.checking``).

Each option the captured step can run with is one case, at
``tiny_test_config()`` on the port's own rendered frames; a keyframe-dense
map setting makes the keyframe segments run on real bookkeeping.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from putslam_tpu_torch.config import tiny_test_config
from putslam_tpu_torch.io import synthetic
from putslam_tpu_torch.models import compiled
from putslam_tpu_torch.models import slam as tslam
from putslam_tpu_torch.models import vo as tvo
from putslam_tpu_torch.utils import control

HOST_READS = {
    torch.ops.aten._local_scalar_dense.default,
    torch.ops.aten.nonzero.default,
    torch.ops.aten.lift_fresh.default,
}


class NoHostRead(TorchDispatchMode):
    """Raises on an operator that reads the device from the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS:
            raise AssertionError(f"host read in a captured segment: {func}")
        return func(*args, **(kwargs or {}))


class PredicateReadsOnly(TorchDispatchMode):
    """Raises on an operator that reads the device from the host, except a
    branch predicate's read by ``control.cond``; counts the reads it let
    through in ``reads`` and the predicates read meanwhile in
    ``predicates``."""

    def __enter__(self):
        self.reads = 0
        self._before = control.predicate_reads
        return super().__enter__()

    def __exit__(self, *exc):
        self.predicates = control.predicate_reads - self._before
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        elif func in HOST_READS:
            raise AssertionError(f"host read in a captured step: {func}")
        return func(*args, **(kwargs or {}))


def test_the_mode_catches_each_kind_of_read():
    x = torch.arange(4)
    i = torch.tensor(1)
    for read in (lambda: x[i], lambda: bool(x.sum()), lambda: x.nonzero(),
                 lambda: torch.tensor([1.0, 2.0]), lambda: x.sum().item()):
        with pytest.raises(AssertionError, match="host read"):
            with NoHostRead():
                read()


def _cfg(case):
    cfg = tiny_test_config()
    dense = dataclasses.replace(cfg.map, min_keyframe_matches=10_000)
    cfg = cfg.replace(map=dense)
    if case == "loop_closure":
        cfg = cfg.replace(
            map=dataclasses.replace(dense, max_keyframes=64),
            loop_closure=dataclasses.replace(cfg.loop_closure, enabled=True,
                                             tail_skip=1, min_probability=0.0))
    elif case == "motion_model":
        cfg = cfg.replace(motion_model=dataclasses.replace(
            cfg.motion_model, enabled=True), pose_blend_alpha=0.3)
    elif case in ("uncertainty_normal", "uncertainty_gradient"):
        cfg = cfg.replace(
            map=dataclasses.replace(dense, use_uncertainty=True,
                                    uncertainty_model=case.split("_")[1]),
            backend=dataclasses.replace(cfg.backend, use_obs_info=True),
            ransac=dataclasses.replace(cfg.ransac, error_version=3,
                                       inlier_threshold_mahalanobis=16.0))
    elif case == "front_end_options":
        cfg = cfg.replace(
            detector=dataclasses.replace(cfg.detector, grid_policy="exact",
                                         descriptor="ldb"),
            matcher=dataclasses.replace(cfg.matcher, acceptance="ratio",
                                        retry_hamming_slack=8.0,
                                        retry_threshold_growth=1.5))
    elif case == "max_mates":
        cfg = cfg.replace(matcher=dataclasses.replace(cfg.matcher,
                                                      max_mates=3))
    elif case == "pose_to_pose":
        cfg = cfg.replace(map=dataclasses.replace(
            dense, add_pose_to_pose_edges=True))
    return cfg


CASES = ("default", "loop_closure", "motion_model", "uncertainty_normal",
         "uncertainty_gradient", "front_end_options", "max_mates",
         "pose_to_pose", "playback")


def _frames(cfg, n=5):
    poses = synthetic.orbit_trajectory(n, radius=0.10, yaw_amp=0.1)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    return grays, depths, poses


@pytest.mark.parametrize("case", CASES)
def test_segments_make_no_host_read(case):
    """The runner's frame (its commit into the static state included) over
    three frames under the mode, as a CUDA graph would replay it: the only
    reads are its branch predicates, one each, and its bodies write only to
    tensors they made. A first eager frame warms the caches (the BRIEF
    bank, the BoW vocabulary)."""
    cfg = _cfg(case)
    playback = case == "playback"
    grays, depths, poses = _frames(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = tslam.slam_init(cfg, grays[0], depths[0], poses[0])
    state, _ = tslam.slam_step(cfg, state, grays[1], depths[1],
                               generator=gen, gt_pose=poses[1],
                               playback=playback)
    runner = compiled.SlamGraphs(cfg, state, grays.shape[1:], playback,
                                 capture=False)
    runner.load(state)
    n_kf = 0
    for i in (2, 3, 4):
        runner.gray.copy_(grays[i])
        runner.depth.copy_(depths[i])
        if playback:
            runner.gt_pose.copy_(poses[i])
        tslam.frame_draws(cfg, gen, "cpu", playback, out=runner.draws)
        with control.checking(), PredicateReadsOnly() as mode:
            runner.frame.run()
        # the keyframe and not-keyframe branches at least
        assert mode.reads == mode.predicates >= 2, (mode.reads,
                                                     mode.predicates)
        n_kf += int(runner.outs.is_keyframe)
    assert n_kf >= 1                     # the keyframe branch ran


def test_vo_segment_makes_no_host_read():
    """The VO-only segment (detection, vo_step with the widened rescue, the
    pose update, the commit into its buffers) on the CPU without graphs:
    the rescue's predicate is its one read."""
    cfg = tiny_test_config()
    cfg = cfg.replace(matcher=dataclasses.replace(
        cfg.matcher, retry_hamming_slack=8.0, retry_threshold_growth=1.5))
    grays, depths, poses = _frames(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    feat0 = tslam.detect_and_describe(cfg, grays[0], depths[0])
    runner = compiled.VoGraphs(cfg, feat0, poses[0], grays.shape[1:],
                               capture=False)
    for i in (1, 2, 3):
        runner.gray.copy_(grays[i])
        runner.depth.copy_(depths[i])
        tvo.vo_draws(cfg, gen, "cpu", out=runner.draws)
        with control.checking(), PredicateReadsOnly() as mode:
            res, pose = runner.segment.run()
        assert mode.reads == mode.predicates == 1   # the retry's predicate
        assert torch.equal(runner.pose, pose)


def test_graph_mode_is_cuda_only():
    """``graph=None`` is eager on the CPU; asking for graphs there raises
    instead of running something else."""
    from putslam_tpu_torch.utils.device import use_graphs

    assert use_graphs(None, "cpu") is False
    assert use_graphs(False, "cpu") is False
    with pytest.raises(ValueError, match="CUDA"):
        use_graphs(True, "cpu")
    cfg = tiny_test_config()
    grays, depths, poses = _frames(cfg, n=2)
    state = tslam.slam_init(cfg, grays[0], depths[0], poses[0])
    with pytest.raises(ValueError, match="CUDA"):
        tslam.slam_sequence(cfg, state, grays[1:], depths[1:], graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        tvo.vo_sequence(cfg, grays, depths, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        compiled.SlamGraphs(cfg, state, grays.shape[1:], capture=True)
