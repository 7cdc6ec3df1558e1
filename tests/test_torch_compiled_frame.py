"""The one-replay SLAM frame (``slam.slam_frame`` in ``compiled.SlamGraphs``).

On the card the runner replays the whole frame (track, the keyframe
bookkeeping, the bundle adjustment with its Gauss-Newton iterations, the
frame's end) from one CUDA graph whose branches are conditional nodes. On
the CPU ``SlamGraphs(capture=False)`` runs the same frame on the same
static buffers with each branch's predicate read on the host
(``control.branching("host")``). It must:

* equal the eager ``slam_step`` (its branches masked) bit for bit, outputs
  and state, frame by frame, over the orbit that makes keyframes, takes the
  map retry ladder and runs the BA, with each solver, its only host reads
  the branch predicates and its bodies writing only to tensors they made
  (``control.checking``); ``test_torch_compiled_parity.py`` holds the same
  over the loop-closure revisit and playback;
* follow the JAX package's ``slam_sequence`` (one ``lax.scan``) fed the
  uniforms of the same key chain, within the tolerances of
  ``test_torch_compiled_parity.py`` (poses 1e-4; keyframe, BA, inlier and
  landmark counts exact; chi² 1e-3 relative + 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import port_cfg, t
from test_torch_compiled_parity import _case
from test_torch_compiled_step import PredicateReadsOnly
from test_torch_slam import _check_frame, jax_draws, slice_config

from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu_torch import convert
from putslam_tpu_torch.models import compiled
from putslam_tpu_torch.models import slam as tslam
from putslam_tpu_torch.utils import control


def _equal_trees(a, b, what):
    la, lb = control.leaves(a), control.leaves(b)
    assert len(la) == len(lb), what
    for k, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, k)


def _port_case(solver):
    """(JAX config, grays, depths, poses as tensors): the orbit with a flat
    frame of ``test_torch_compiled_parity.py`` with ``solver``."""
    cfg, g, d, poses, _ = _case("retry_keyframes")
    cfg = cfg.replace(backend=dataclasses.replace(cfg.backend, solver=solver))
    return cfg, t(g), t(d), t(poses)


@pytest.mark.parametrize("name", ["dense_schur_mm", "dense_schur", "pcg"])
def test_frame_equals_eager_step(name):
    jcfg, grays, depths, poses = _port_case(name)
    cfg = port_cfg(jcfg)
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    state = tslam.slam_init(cfg, grays[0], depths[0], poses[0])
    runner = compiled.SlamGraphs(cfg, state, grays.shape[1:], capture=False)
    runner.load(state)
    seen = dict(keyframe=0, ba=0, ladder=0)
    for i in range(1, grays.shape[0]):
        state, eo = tslam.slam_step(cfg, state, grays[i], depths[i],
                                    generator=gens[0])
        with control.checking(), PredicateReadsOnly() as mode:
            ro = runner.step(grays[i], depths[i], generator=gens[1])
        assert mode.reads == mode.predicates >= 2, (i, mode.reads,
                                                    mode.predicates)
        _equal_trees(ro, eo, f"frame {i} outputs")
        _equal_trees(runner.state, state, f"frame {i} state")
        seen["keyframe"] += int(ro.is_keyframe)
        seen["ba"] += int(ro.ba_ran)
        seen["ladder"] += int(runner.frame.out.first_pass_ratio
                              < cfg.matcher.retry_inlier_ratio)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert seen["keyframe"] >= 2 and seen["ba"] >= 1 \
        and seen["ladder"] >= 1, seen


def test_frame_follows_jax_slam_sequence():
    """The JAX package's slam_sequence (one lax.scan over the frames)
    against the runner fed the uniforms of the scan's key chain: the
    orbit with a flat frame (the ladder, keyframes, the windowed BA)."""
    cfg = slice_config()
    pcfg = port_cfg(cfg)
    poses = np.asarray(jsyn.orbit_trajectory(12, radius=0.10, yaw_amp=0.1))
    g, d = (np.array(x) for x in jsyn.render_sequence(cfg.camera,
                                                      jnp.asarray(poses)))
    g[8] = 0.5
    js = jslam.slam_init(cfg, g[0], d[0], poses[0])
    ts = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    _, jouts = jslam.slam_sequence(cfg, js, jnp.asarray(g[1:]),
                                   jnp.asarray(d[1:]))
    runner = compiled.SlamGraphs(pcfg, ts, g.shape[1:], capture=False)
    runner.load(ts)
    key = js.key
    n_kf = n_ba = 0
    for i in range(1, len(g)):
        draws, key = jax_draws(cfg, key)
        ro = runner.step(t(g[i]), t(d[i]), draws=draws)
        jo = jax.tree.map(lambda x, k=i - 1: np.asarray(x)[k], jouts)
        _check_frame(i, ro, jo)
        n_kf += int(ro.is_keyframe)
        n_ba += int(ro.ba_ran)
    assert n_kf >= 2 and n_ba >= 1, (n_kf, n_ba)
