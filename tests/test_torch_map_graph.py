"""Map and graph state parity: each ported function of
slam_map/features_map.py and backend/graph.py on states from a JAX
slam_init, carried across with putslam_tpu_torch.convert. Integers and
masks exact; floats ≤ 1e-6 (absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t

from putslam_tpu.backend import graph as jgraph
from putslam_tpu.config import tiny_test_config
from putslam_tpu.frontend import detector as jdet
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu.slam_map import features_map as jfm
from putslam_tpu_torch import convert
from putslam_tpu_torch.backend import graph as tgraph
from putslam_tpu_torch.slam_map import features_map as tfm

CFG = tiny_test_config()
PCFG = port_cfg(CFG)


def assert_tree_close(got, ref, atol=1e-6):
    for f in ref._fields:
        a, b = n(getattr(got, f)), np.asarray(getattr(ref, f))
        if hasattr(b, "_fields"):
            assert_tree_close(getattr(got, f), getattr(ref, f), atol)
        elif b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def to_port(x):
    return convert.from_numpy(jax.tree.map(np.asarray, x), "cpu")


@pytest.fixture(scope="module")
def world():
    poses = jsyn.orbit_trajectory(6, radius=0.10, yaw_amp=0.1)
    g, d = jsyn.render_sequence(CFG.camera, poses)
    st = jslam.slam_init(CFG, g[0], d[0], poses[0])
    feat = jdet.detect_and_describe(CFG, g[2], d[2])
    return st, feat, np.asarray(poses)


def test_state_round_trip(world):
    st, _, _ = world
    js = jax.tree.map(np.asarray, st)
    back = convert.to_numpy(convert.from_numpy(js, "cpu"))
    for f in back._fields:
        for a, b in zip(jax.tree.leaves(getattr(back, f)),
                        jax.tree.leaves(getattr(js, f))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_guided_match(world, scale):
    st, feat, poses = world
    pose = jnp.asarray(poses[2])
    ref = jfm.guided_match(CFG, st.map, pose, feat, radius_scale=scale)
    got = tfm.guided_match(PCFG, to_port(st.map), t(poses[2]), to_port(feat),
                           radius_scale=scale)
    assert int(ref.valid.sum()) > 10
    assert_tree_close(got, ref)


def test_allocate_slots():
    rng = np.random.default_rng(0)
    free = rng.uniform(size=300) < 0.3
    want = rng.uniform(size=128) < 0.5
    for cap in (16, 200):
        ref = jfm._allocate_slots(jnp.asarray(free), jnp.asarray(want), cap)
        got = tfm._allocate_slots(t(free), t(want), cap)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(n(a), np.asarray(b))


@pytest.mark.parametrize("n_free", [None, 5, 0])
def test_add_landmarks(world, n_free):
    """n_free: leave only this many free slots (0 = a full store: every
    allocation lands on the out-of-bounds sentinel and is dropped)."""
    st, feat, poses = world
    m = st.map
    if n_free is not None:
        valid = np.ones(m.capacity, bool)
        valid[np.arange(n_free) * 7 + 3] = False
        m = m._replace(lm_valid=jnp.asarray(valid))
    matched = jnp.asarray(np.random.default_rng(1).uniform(size=feat.capacity)
                          < 0.3)
    ref = jfm.add_landmarks(CFG, m, jnp.asarray(poses[2]), feat, matched,
                            jnp.int32(4))
    got = tfm.add_landmarks(PCFG, to_port(m), t(poses[2]), to_port(feat),
                            t(matched), torch.tensor(4, dtype=torch.int32))
    assert_tree_close(got, ref)


def test_update_matched_landmarks(world):
    st, feat, poses = world
    pose = jnp.asarray(poses[2])
    gm = jfm.guided_match(CFG, st.map, pose, feat)
    ref = jfm.update_matched_landmarks(CFG, st.map, pose + jnp.asarray(
        [2.5, 0, 0, 0, 0, 0, 0]), feat, gm, jnp.int32(3))
    got = tfm.update_matched_landmarks(
        PCFG, to_port(st.map), t(poses[2]) + torch.tensor(
            [2.5, 0, 0, 0, 0, 0, 0]), to_port(feat), to_port(gm),
        torch.tensor(3, dtype=torch.int32))
    assert int(np.asarray(ref.lm_slot_used).sum()) > int(
        np.asarray(st.map.lm_slot_used).sum())
    assert_tree_close(got, ref)


@pytest.mark.parametrize("n_kf", [1, 35])
def test_add_keyframe_and_window(world, n_kf):
    """n_kf=35 > K=32: the ring wraps onto a valid slot (generation bump,
    covisibility row/column reset)."""
    st, _, poses = world
    K = CFG.map.max_keyframes
    m = st.map
    if n_kf > K:
        m = m._replace(kf_valid=jnp.ones(K, bool), n_kf=jnp.int32(n_kf),
                       kf_seq=jnp.arange(K, dtype=jnp.int32) + (n_kf - K),
                       covis=jnp.asarray(np.random.default_rng(2).uniform(
                           size=(K, K)).astype(np.float32)))
    ref, ridx = jfm.add_keyframe(CFG, m, jnp.asarray(poses[3]),
                                 jnp.float32(0.7))
    got, gidx = tfm.add_keyframe(PCFG, to_port(m), t(poses[3]), 0.7)
    assert int(gidx) == int(ridx)
    assert_tree_close(got, ref)
    for w in (1, 4):
        np.testing.assert_array_equal(
            n(tfm.active_window_fixed(got, w)),
            np.asarray(jfm.active_window_fixed(ref, w)))


def test_covisibility_and_compress(world):
    st, feat, poses = world
    gm = jfm.guided_match(CFG, st.map, jnp.asarray(poses[2]), feat)
    m = st.map._replace(n_kf=jnp.int32(300),
                        lm_n_obs=st.map.lm_n_obs.at[::3].set(2))
    np.testing.assert_allclose(
        n(tfm.covisibility_ratio(to_port(gm), to_port(m), 0)),
        np.asarray(jfm.covisibility_ratio(gm, m, 0)), atol=1e-7)
    assert_tree_close(tfm.compress_map(PCFG, to_port(m), 250),
                      jfm.compress_map(CFG, m, 250))


def _obs_batch(rng, L, K):
    return (np.full(L, 3, np.int32), np.arange(L, dtype=np.int32),
            rng.normal(size=(L, 3)).astype(np.float32),
            np.full(L, 400.0, np.float32), rng.uniform(size=L) < 0.4,
            rng.integers(0, 3, L).astype(np.int32),
            np.full(L, 1, np.int32))


@pytest.mark.parametrize("prefill", [0, 4000])
def test_add_observations(prefill):
    """prefill=4000 of M=4096: the append wraps, so slots come from the
    dead-first sorted allocator (invalid slots, then the oldest)."""
    rng = np.random.default_rng(3)
    g = jgraph.init_graph(CFG.backend.max_observations,
                          CFG.backend.max_pose_pose_edges)
    if prefill:
        valid = rng.uniform(size=g.obs_capacity) < 0.9
        valid[prefill:] = False
        g = g._replace(obs_valid=jnp.asarray(valid), n_obs=jnp.int32(prefill),
                       obs_seq=jnp.asarray(rng.permutation(
                           g.obs_capacity).astype(np.int32)))
    kf, lm, xyz, w, mask, gen, kfg = _obs_batch(rng, 512, 32)
    ref = jgraph.add_observations(g, *map(jnp.asarray, (kf, lm, xyz, w, mask)),
                                  gen=jnp.asarray(gen), kf_gen=jnp.asarray(kfg))
    got = tgraph.add_observations(to_port(g), *map(t, (kf, lm, xyz, w, mask)),
                                  gen=t(gen), kf_gen=t(kfg))
    assert_tree_close(got, ref)
    lm_gen = rng.integers(0, 3, 512).astype(np.int32)
    kf_gen = np.ones(32, np.int32)
    assert_tree_close(
        tgraph.reclaim_observation_slots(got, t(lm_gen), t(kf_gen)),
        jgraph.reclaim_observation_slots(ref, jnp.asarray(lm_gen),
                                         jnp.asarray(kf_gen)))
    drop = rng.uniform(size=g.obs_capacity) < 0.2
    assert_tree_close(tgraph.prune_observations(got, t(drop)),
                      jgraph.prune_observations(ref, jnp.asarray(drop)))


@pytest.mark.parametrize("prefill", [0, 4000])
def test_add_observations_stores_info(prefill):
    """``info=``: the (N, 3, 3) matrices land in the slots of their
    observations (masked rows nowhere), exactly; without it the slots are
    zeroed. The state with stored matrices crosses convert both ways."""
    rng = np.random.default_rng(4)
    g = jgraph.init_graph(CFG.backend.max_observations,
                          CFG.backend.max_pose_pose_edges)
    g = g._replace(obs_info=jnp.asarray(rng.normal(
        size=g.obs_info.shape).astype(np.float32)))
    if prefill:
        g = g._replace(obs_valid=jnp.asarray(
            np.arange(g.obs_capacity) < prefill), n_obs=jnp.int32(prefill),
            obs_seq=jnp.arange(g.obs_capacity, dtype=jnp.int32))
    kf, lm, xyz, w, mask, gen, kfg = _obs_batch(rng, 512, 32)
    info = rng.normal(size=(512, 3, 3)).astype(np.float32)
    for inf in (info, None):
        ref = jgraph.add_observations(
            g, *map(jnp.asarray, (kf, lm, xyz, w, mask)), gen=jnp.asarray(gen),
            kf_gen=jnp.asarray(kfg),
            info=None if inf is None else jnp.asarray(inf))
        got = tgraph.add_observations(
            to_port(g), *map(t, (kf, lm, xyz, w, mask)), gen=t(gen),
            kf_gen=t(kfg), info=None if inf is None else t(inf))
        assert_tree_close(got, ref, atol=0)
    back = convert.to_numpy(got)
    np.testing.assert_array_equal(back.obs_info, np.asarray(ref.obs_info))
    stored = np.asarray(ref.obs_info)
    assert (np.abs(stored).sum(axis=(1, 2)) == 0).sum() == int(mask.sum())


@pytest.mark.parametrize("n_pp,valid", [(0, True), (66, True), (5, False)])
def test_add_pose_pose(n_pp, valid):
    """n_pp=66 > E=64 wraps the ring; valid=False drops the append."""
    g = jgraph.init_graph(CFG.backend.max_observations,
                          CFG.backend.max_pose_pose_edges)
    g = g._replace(n_pp=jnp.int32(n_pp))
    rel = np.asarray([0.1, 0.0, -0.2, 0.99, 0.1, 0.0, 0.0], np.float32)
    ref = jgraph.add_pose_pose(g, jnp.int32(3), jnp.int32(4),
                               jnp.asarray(rel), jnp.float32(100.0),
                               jnp.asarray(valid), gen_i=jnp.int32(1),
                               gen_j=jnp.int32(2))
    got = tgraph.add_pose_pose(to_port(g), torch.tensor(3, dtype=torch.int32),
                               torch.tensor(4, dtype=torch.int32), t(rel),
                               torch.tensor(100.0), torch.tensor(valid),
                               gen_i=torch.tensor(1, dtype=torch.int32),
                               gen_j=torch.tensor(2, dtype=torch.int32))
    assert_tree_close(got, ref)
