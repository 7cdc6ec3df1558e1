"""Multi-session merging, cross-session loop closures and the joint BA
(parallel/multi_session.py) against the JAX package's.

Two sessions run by the port's engine (tiny config with loop closure, the
settings of tests/test_multi_session.py, JAX-rendered orbits of 14 frames)
give the states; the same states, as numpy, are handed to the JAX package.
``merge_sessions`` is exact. ``find_cross_session_closures`` fed the JAX key
chain's RANSAC uniforms accepts the same edges, relative poses within 1e-5
(tests/test_torch_loop_closure.py's tolerance). ``joint_optimize`` on a
2-rank mesh against the JAX function on 2 of conftest.py's 8 virtual
devices: chi² 1e-3 relative, poses and landmarks 1e-4 (the dist-BA parity
of tests/test_torch_dist_ba.py); and chi² does not rise by more than 5 %
(tests/test_multi_session.py:56). The slow
``test_handheld_walks_close_in_both_packages_or_neither`` runs the walks of
``chip_smoke.py`` phase 16 (e) through both engines at the tiny camera
(``-s`` prints the keyframes and closures of each package)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg

from putslam_tpu.backend import graph as jgraph
from putslam_tpu.config import LoopClosureConfig, tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu.parallel import mesh as jmesh
from putslam_tpu.parallel import multi_session as jms
from putslam_tpu.slam_map import features_map as jfm
from putslam_tpu_torch import convert
from putslam_tpu_torch.models import slam as tslam
from putslam_tpu_torch.parallel import dist_ba as tdist
from putslam_tpu_torch.parallel import mesh as tmesh
from putslam_tpu_torch.parallel import multi_session as tms


def lc_cfg():
    cfg = tiny_test_config()
    return cfg.replace(
        map=dataclasses.replace(cfg.map,
                                add_features_when_measurements_less_than=10,
                                min_keyframe_matches=10),
        loop_closure=LoopClosureConfig(enabled=True, vocab_size=128,
                                       tail_skip=8, min_probability=0.05,
                                       min_features_lc=10, queue_capacity=16))


def run_sessions(cfg, radii, n_frames):
    states = []
    for b, radius in enumerate(radii):
        poses = np.asarray(jsyn.orbit_trajectory(n_frames, radius=radius,
                                                 yaw_amp=0.1))
        g, d = jsyn.render_sequence(cfg.camera, jnp.asarray(poses))
        _, _, st = tslam.run_slam(port_cfg(cfg), np.asarray(g), np.asarray(d),
                                  init_pose=poses[0], seed=b, device="cpu")
        states.append(st)
    return states


def as_jax(state):
    """The fields of a port state that the JAX functions read, as JAX
    arrays in the JAX package's classes."""
    s = convert.to_numpy(state)
    return types.SimpleNamespace(
        map=jfm.MapState(**{f: jnp.asarray(getattr(s.map, f))
                            for f in jfm.MapState._fields}),
        graph=jgraph.GraphState(**{f: jnp.asarray(getattr(s.graph, f))
                                   for f in jgraph.GraphState._fields}),
        kf_sig=jnp.asarray(s.kf_sig), sig_valid=jnp.asarray(s.sig_valid))


@pytest.fixture(scope="module")
def sessions():
    cfg = lc_cfg()
    states = run_sessions(cfg, (0.12, 0.18), 14)
    return cfg, states, [as_jax(s) for s in states]


def _uniforms(cfg, n_cand, key):
    keys = jax.random.split(key, n_cand)
    k, H = cfg.ransac.used_pairs, cfg.ransac.n_hypotheses
    return torch.stack([torch.as_tensor(np.array(
        jax.random.uniform(kk, (k, H), maxval=1.0))) for kk in keys])


def _closures(cfg, states, jstates, top_per_pair=3):
    tm = tms.merge_sessions(port_cfg(cfg), states)
    jm = jms.merge_sessions(cfg, jstates)
    key = jax.random.PRNGKey(0)
    n_pairs = len(states) * (len(states) - 1) // 2
    jg, jn = jms.find_cross_session_closures(cfg, jm, jstates, key,
                                             top_per_pair=top_per_pair)
    tg, tn = tms.find_cross_session_closures(
        port_cfg(cfg), tm, states,
        u=_uniforms(cfg, n_pairs * top_per_pair, key),
        top_per_pair=top_per_pair)
    return tm, jm, tg, jg, tn, jn


def test_merge_sessions_matches_jax(sessions):
    cfg, states, jstates = sessions
    tm = tms.merge_sessions(port_cfg(cfg), states)
    jm = jms.merge_sessions(cfg, jstates)
    for f in ("kf_pose", "kf_valid", "kf_gen", "lm_pos", "lm_valid",
              "lm_gen", "session_of_kf", "anchors"):
        np.testing.assert_array_equal(n(getattr(tm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    for f in jgraph.GraphState._fields:
        np.testing.assert_array_equal(n(getattr(tm.graph, f)),
                                      np.asarray(getattr(jm.graph, f)),
                                      err_msg=f)
    K = states[0].map.kf_pose.shape[0]
    assert tm.kf_pose.shape == (2 * K, 7)
    assert int(tm.graph.obs_valid.sum()) == sum(
        int(s.graph.obs_valid.sum()) for s in states)
    assert int(tm.anchors[0]) < K <= int(tm.anchors[1])
    assert len(tm.map_states) == 2


def test_cross_session_closures_match_jax(sessions):
    cfg, states, jstates = sessions
    tm, jm, tg, jg, tn, jn = _closures(cfg, states, jstates)
    assert tn == jn >= 1
    for f in ("pp_i", "pp_j", "pp_valid", "pp_gen_i", "pp_gen_j", "pp_w",
              "n_pp"):
        np.testing.assert_array_equal(n(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_allclose(n(tg.pp_rel), np.asarray(jg.pp_rel), atol=1e-5)


def test_joint_optimize_matches_jax(sessions):
    cfg, states, jstates = sessions
    tm, jm, tg, jg, tn, jn = _closures(cfg, states, jstates)
    kf, lm, chi2 = tms.joint_optimize(
        port_cfg(cfg), tmesh.make_mesh(2, axis="lm", device="cpu"), tm, tg,
        tn)
    rkf, rlm, rchi2 = jms.joint_optimize(cfg, jmesh.make_mesh(2, axis="lm"),
                                         jm, jg, jn)
    np.testing.assert_allclose(n(chi2), np.asarray(rchi2), rtol=1e-3)
    np.testing.assert_allclose(n(kf), np.asarray(rkf), atol=1e-4)
    np.testing.assert_allclose(n(lm), np.asarray(rlm), atol=1e-4)
    chi = n(chi2)
    assert np.isfinite(chi).all() and np.isfinite(n(kf)).all()
    assert chi[-1] <= chi[0] * 1.05
    # with a cross-session edge only session 0's anchor holds the gauge
    fixed = tms.joint_fixed(tm, tn)
    assert int(fixed.sum()) == 1 and bool(fixed[int(tm.anchors[0])])
    assert int(tms.joint_fixed(tm, 0).sum()) == 2


def test_skewed_ownership_resolves_on_one_rank(sessions):
    """Every observation remapped into rank 0's landmark block of a
    256-rank mesh (a slice of 2M/256 slots, fewer than the live
    observations): the owner partition overflows, joint_optimize warns and
    returns gauss_newton_mm's solve of the same problem."""
    from putslam_tpu_torch.backend import optimize as topt

    cfg, states, _ = sessions
    pcfg = port_cfg(cfg)
    tm = tms.merge_sessions(pcfg, states)
    L, size = tm.lm_pos.shape[0], 256
    g = tm.graph._replace(obs_lm=tm.graph.obs_lm % (L // size))
    tm = tm._replace(graph=g, lm_valid=torch.ones_like(tm.lm_valid))
    assert tdist.partition_overflow(g, size, L) > 0
    with pytest.warns(UserWarning, match="re-solving on one rank"):
        kf, lm, chi2 = tms.joint_optimize(
            pcfg, tmesh.make_mesh(size, axis="lm", device="cpu"), tm, g, 0)
    ref = topt.gauss_newton_mm(pcfg.backend, tm.kf_pose, tm.kf_valid,
                               tm.lm_pos, tm.lm_valid, g,
                               tms.joint_fixed(tm, 0), tm.lm_gen, tm.kf_gen,
                               cam=pcfg.camera)
    assert torch.equal(kf, ref.kf_pose) and torch.equal(chi2, ref.chi2)


@pytest.mark.slow
def test_four_session_stretch():
    """tests/test_multi_session.py:62-91 on the port: four orbits of the
    same room, all six pairs scored in one pass, several close, the joint
    BA over an 8-rank mesh stays finite and does not raise chi²."""
    cfg = lc_cfg()
    states = run_sessions(cfg, (0.10, 0.13, 0.16, 0.19), 12)
    pcfg = port_cfg(cfg)
    merged = tms.merge_sessions(pcfg, states)
    K = states[0].map.kf_pose.shape[0]
    assert merged.kf_pose.shape == (4 * K, 7)
    gen = torch.Generator()
    gen.manual_seed(0)
    g2, n_edges = tms.find_cross_session_closures(pcfg, merged, states,
                                                  generator=gen)
    assert n_edges >= 2, n_edges
    kf, _, chi2 = tms.joint_optimize(
        pcfg, tmesh.make_mesh(8, axis="lm", device="cpu"), merged, g2,
        n_edges)
    chi = n(chi2)
    assert np.isfinite(n(kf)).all() and np.isfinite(chi).all()
    assert chi[-1] <= chi[0] * 1.05


def _handheld_walks(case):
    """The walks of ``chip_smoke.py`` phase 16 (e) at the tiny camera."""
    if case == "seeds 3/4":
        return [np.asarray(jsyn.handheld_trajectory(64, seed=s))
                for s in (3, 4)]
    h = np.asarray(jsyn.handheld_trajectory(128, seed=3))
    return {"windows 0-63 / 40-103": [h[0:64], h[40:104]],
            "40-79 forward / backward": [h[40:80], h[79:39:-1]],
            "dense 40-53 / 60-47": [h[40:54], h[60:46:-1]]}[case]


@pytest.mark.slow
@pytest.mark.parametrize("case, closes", [
    ("seeds 3/4", False), ("windows 0-63 / 40-103", False),
    ("40-79 forward / backward", True), ("dense 40-53 / 60-47", True)])
def test_handheld_walks_close_in_both_packages_or_neither(case, closes):
    """Whether two handheld walks close across sessions is a property of
    the walks, not of the port: each walk runs through both engines (the
    JAX package's with its own key chain, the port's with its generator),
    and each package's closure search runs on its own states. Both accept
    a closure, or neither does. Keyframe-dense for the "dense" case."""
    cfg = lc_cfg()
    if case.startswith("dense"):
        cfg = cfg.replace(map=dataclasses.replace(
            cfg.map, min_keyframe_matches=10_000))
    pcfg = port_cfg(cfg)
    js, ts = [], []
    for b, p in enumerate(_handheld_walks(case)):
        g, d = jsyn.render_sequence(cfg.camera, jnp.asarray(p))
        g, d = np.asarray(g), np.asarray(d)
        js.append(jslam.run_slam(cfg, g, d, init_pose=p[0], seed=b)[2])
        ts.append(tslam.run_slam(pcfg, g, d, init_pose=p[0], seed=b,
                                 device="cpu")[2])
    _, jn = jms.find_cross_session_closures(
        cfg, jms.merge_sessions(cfg, js), js, jax.random.PRNGKey(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    _, tn = tms.find_cross_session_closures(
        pcfg, tms.merge_sessions(pcfg, ts), ts, generator=gen)
    print(f"{case}: keyframes JAX "
          f"{[int(s.map.kf_valid.sum()) for s in js]}, port "
          f"{[int(s.map.kf_valid.sum()) for s in ts]}; closures JAX {jn}, "
          f"port {tn}")
    assert (jn > 0, tn > 0) == (closes, closes), (jn, tn)
