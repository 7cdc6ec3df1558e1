"""The segmented step (``models/compiled.py``) equals the eager step.

``SlamGraphs(capture=False)`` runs the frame (``slam.slam_frame``) on the
runner's static buffers exactly as its CUDA graph replays it (the branches
of a frame that is no keyframe and of a keyframe, the BA inside the
keyframe branch, each committing the state), only without a graph: each
branch's predicate is read on the host, and those are the frame's only
reads; its bodies write only to tensors they made (``control.checking``). Over tiny sequences fed the JAX key chain's uniforms it must equal
the port's eager ``slam_step`` bit for bit, outputs and state, frame by
frame; and follow the JAX ``slam_step`` within the tolerances of
tests/test_torch_slam.py (poses 1e-4, keyframe / BA / inlier / landmark
counts exact, chi² 1e-3 relative + 1e-5).

Cases: an orbit with a flat frame, whose next frames take the map retry
ladder (the first pass's inlier ratio under ``retry_inlier_ratio``), with
keyframes and the windowed BA; the loop-closure revisit, with candidates
popped, verified and accepted; playback. And the VO-only runner against
the eager ``vo_sequence`` on the port's own generator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import port_cfg, t
from test_torch_compiled_step import PredicateReadsOnly
from test_torch_slam import (_check_frame, jax_draws, revisit_lc_config,
                             slice_config)

from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu_torch import convert
from putslam_tpu_torch.config import tiny_test_config
from putslam_tpu_torch.io import synthetic as tsyn
from putslam_tpu_torch.models import compiled
from putslam_tpu_torch.models import slam as tslam
from putslam_tpu_torch.models import vo as tvo
from putslam_tpu_torch.utils import control


def _equal_trees(a, b, what):
    la, lb = compiled._leaves(a), compiled._leaves(b)
    assert len(la) == len(lb), what
    for k, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, k)


def _case(name):
    """(config, frames, given poses or None)."""
    if name == "loop_closure":
        cfg = revisit_lc_config()
        poses = np.asarray(jsyn.revisit_trajectory(24, sweep=0.6))
    else:
        cfg = slice_config()
        poses = np.asarray(jsyn.orbit_trajectory(12, radius=0.10,
                                                 yaw_amp=0.1))
    g, d = (np.array(x) for x in jsyn.render_sequence(cfg.camera,
                                                      jnp.asarray(poses)))
    given = None
    if name == "retry_keyframes":
        g[8] = 0.5                       # no features: VO and the map fail
    if name == "playback":
        rng = np.random.default_rng(1)
        given = poses.copy()
        given[1:, :3] += rng.normal(scale=0.004, size=(len(poses) - 1, 3)
                                    ).astype(np.float32)
    return cfg, g, d, poses if given is None else given, given


@pytest.mark.parametrize("name", ["retry_keyframes", "loop_closure",
                                  "playback"])
def test_segmented_step_equals_eager_and_follows_jax(name):
    cfg, g, d, init, given = _case(name)
    pcfg = port_cfg(cfg)
    playback = given is not None
    js = jslam.slam_init(cfg, g[0], d[0], init[0])
    ts = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    runner = compiled.SlamGraphs(pcfg, ts, g.shape[1:], playback=playback,
                                 capture=False)
    runner.load(ts)
    seen = dict(ladder=0, keyframe=0, ba=0)
    for i in range(1, len(g)):
        draws, _ = jax_draws(cfg, js.key)
        if playback:
            del draws["vo"]
            js, jo = jslam.slam_step(cfg, js, g[i], d[i],
                                     jnp.asarray(given[i]), True)
        else:
            js, jo = jslam.slam_step(cfg, js, g[i], d[i])
        gt = None if given is None else t(given[i])
        ts, to = tslam.slam_step(pcfg, ts, t(g[i]), t(d[i]), draws=draws,
                                 gt_pose=gt, playback=playback)
        gi, di = t(g[i]), t(d[i])
        with control.checking(), PredicateReadsOnly() as mode:
            ro = runner.step(gi, di, draws=draws, gt_pose=gt)
        assert mode.reads == mode.predicates >= 2, (i, mode.reads,
                                                    mode.predicates)
        _equal_trees(ro, to, f"frame {i} outputs")
        _equal_trees(runner.state, ts, f"frame {i} state")
        _check_frame(i, ro, jo)
        seen["ladder"] += int(runner.frame.out.first_pass_ratio
                              < pcfg.matcher.retry_inlier_ratio)
        seen["keyframe"] += int(ro.is_keyframe)
        seen["ba"] += int(ro.ba_ran)
    if name == "retry_keyframes":
        assert seen["ladder"] >= 1 and seen["keyframe"] >= 2 \
            and seen["ba"] >= 1, seen
    if name == "loop_closure":
        # candidates popped, verified and accepted as edges
        assert int(runner.state.n_lc_edges) >= 1 and seen["keyframe"] >= 4
    if name == "playback":
        assert seen["keyframe"] >= 2, seen


def test_vo_runner_equals_eager_vo_sequence():
    """The VO-only segment on its buffers, frame by frame, against the
    eager ``vo_sequence`` with the same generator seed: poses and every
    per-step result bit-equal (the widened rescue on)."""
    cfg = tiny_test_config()
    cfg = cfg.replace(matcher=dataclasses.replace(
        cfg.matcher, retry_hamming_slack=8.0, retry_threshold_growth=1.5))
    poses = tsyn.orbit_trajectory(6, radius=0.10, yaw_amp=0.1)
    grays, depths = tsyn.render_sequence(cfg.camera, poses)
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    p_eager, s_eager = tvo.vo_sequence(cfg, grays, depths, generator=gens[0],
                                       init_pose=poses[0])
    p_run, s_run = compiled.vo_run_sequence(cfg, grays, depths, poses[0],
                                            generator=gens[1], capture=False)
    p_run = tvo.normalise_poses(p_run)
    assert torch.equal(p_eager, p_run)
    _equal_trees(s_eager, s_run, "VO steps")
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
