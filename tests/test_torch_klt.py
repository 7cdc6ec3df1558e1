"""KLT and tracking-VO parity: the pyramid (exact at the tiny config's
96×128; within two float32 ulps after two levels at other shapes, where
XLA's CPU reduction adds the 2×2 block in a shape-dependent order, ROADMAP
Queue 3m), track and refine_patch_alignment (valid exact; points 1e-4 px on
the tracks JAX keeps valid — a lost track's position is not used),
vo_step_tracking fed
the same RANSAC uniforms (rel_pose 1e-5, masks exact, the refill of lost
tracks included) and an 8-frame tracking-VO chain against the JAX
package's run_vo (poses 1e-4, per-step counts exact)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t

from putslam_tpu.config import TrackerConfig, tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import vo as jvo
from putslam_tpu.ops import klt as jklt
from putslam_tpu_torch import convert
from putslam_tpu_torch.models import vo as tvo
from putslam_tpu_torch.ops import klt as tklt


@functools.lru_cache(maxsize=1)
def _frames():
    """The first 8 frames of the JAX tracking test's 30-frame orbit."""
    cfg = tiny_test_config()
    poses = np.asarray(jsyn.orbit_trajectory(30, radius=0.12,
                                             yaw_amp=0.1))[:8]
    g, d = jsyn.render_sequence(cfg.camera, jnp.asarray(poses))
    return np.asarray(g), np.asarray(d), poses


def _tracking_cfg(patch_refine=False):
    cfg = tiny_test_config().replace(vo_version=1)
    return cfg.replace(tracker=dataclasses.replace(
        cfg.tracker, min_tracked_features=60, patch_refine=patch_refine))


@pytest.mark.parametrize("shape,atol", [((96, 128), 0.0),
                                        ((97, 131), 2.5e-7)])
def test_build_pyramid_exact(shape, atol):
    img = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    ref = jklt.build_pyramid(jnp.asarray(img), 3)
    got = tklt.build_pyramid(t(img), 3)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), np.asarray(b), atol=atol, rtol=0)


def _track_points():
    """FAST features of frame 2 (the JAX package's init_tracking)."""
    g, d, _ = _frames()
    ts = jvo.init_tracking(tiny_test_config(), g[2], d[2])
    return np.asarray(ts.uv), np.asarray(ts.valid)


def _check_track(got, ref):
    keep = np.asarray(ref.valid)
    np.testing.assert_array_equal(n(got.valid), keep)
    np.testing.assert_allclose(n(got.pts)[keep], np.asarray(ref.pts)[keep],
                               atol=1e-4)
    np.testing.assert_allclose(n(got.err)[keep], np.asarray(ref.err)[keep],
                               atol=1e-3)
    return keep


@pytest.mark.parametrize("tcfg", [TrackerConfig(),
                                  TrackerConfig(win_size=9, max_levels=2,
                                                max_iter=12)])
def test_track_matches_jax(tcfg):
    g, _, _ = _frames()
    pts, valid = _track_points()
    ref = jklt.track(tcfg, jnp.asarray(g[2]), jnp.asarray(g[3]),
                     jnp.asarray(pts), jnp.asarray(valid))
    got = tklt.track(port_cfg(tcfg), t(g[2]), t(g[3]), t(pts), t(valid))
    assert _check_track(got, ref).sum() >= 20


def test_refine_patch_alignment_matches_jax():
    g, _, _ = _frames()
    pts, valid = _track_points()
    init = pts + np.random.default_rng(1).uniform(
        -1.5, 1.5, pts.shape).astype(np.float32)
    tcfg = TrackerConfig(win_size=11, max_iter=30)
    ref = jklt.refine_patch_alignment(tcfg, jnp.asarray(g[2]),
                                      jnp.asarray(g[3]), jnp.asarray(pts),
                                      jnp.asarray(init), jnp.asarray(valid))
    got = tklt.refine_patch_alignment(port_cfg(tcfg), t(g[2]), t(g[3]),
                                      t(pts), t(init), t(valid))
    assert _check_track(got, ref).sum() >= 20


def _uniforms(cfg, key):
    return t(jax.random.uniform(key, (cfg.ransac.used_pairs,
                                      cfg.ransac.n_hypotheses), maxval=1.0))


def _refill_slot0_only(t_valid, j_valid):
    """The port's refill equals the JAX package's except where the JAX
    package left a free slot 0 empty (Queue 3l): there the port filled it.
    Returns whether that happened."""
    t_valid, j_valid = n(t_valid), np.asarray(j_valid)
    np.testing.assert_array_equal(t_valid[1:], j_valid[1:])
    if t_valid[0] == j_valid[0]:
        return False
    assert t_valid[0] and not j_valid[0]
    return True


@pytest.mark.parametrize("patch_refine", [False, True])
def test_vo_step_tracking_matches_jax(patch_refine):
    """Five steps, each from the same (JAX) tracking state in both
    packages; lost tracks are refilled (min_tracked_features 60 of 128) and
    RANSAC accepts from step 3 on. Masks and tracks are exact but for a free
    slot 0, which only the port refills (Queue 3l)."""
    cfg = _tracking_cfg(patch_refine)
    pcfg = port_cfg(cfg)
    g, d, _ = _frames()
    js = jvo.init_tracking(cfg, g[0], d[0])
    n_ok = n_refilled = 0
    for i in range(1, 6):
        ts = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
        key = jax.random.PRNGKey(i)
        js2, jr = jvo.vo_step_tracking(cfg, key, js, g[i], d[i])
        ts2, tr = tvo.vo_step_tracking(pcfg, ts, t(g[i]), t(d[i]),
                                       u=_uniforms(cfg, key))
        n_ok += int(jr.ok)
        np.testing.assert_allclose(n(tr.rel_pose), np.asarray(jr.rel_pose),
                                   atol=1e-5)
        for f in ("n_matches", "n_inliers", "ok"):
            assert int(n(getattr(tr, f))) == int(np.asarray(getattr(jr, f)))
        slot0 = _refill_slot0_only(ts2.valid, js2.valid)
        keep = slice(1, None) if slot0 else slice(None)
        np.testing.assert_allclose(n(ts2.uv)[keep], np.asarray(js2.uv)[keep],
                                   atol=1e-4)
        np.testing.assert_allclose(n(ts2.xyz)[keep],
                                   np.asarray(js2.xyz)[keep], atol=1e-4)
        n_refilled += int(np.asarray(js2.valid).sum()
                          > int(np.asarray(jr.n_matches)))
        js = js2
    assert n_ok >= 2 and n_refilled >= 2


def test_refill_fills_free_slots_in_order():
    """With the first 16 tracks lost (and the rest tracked in place), fresh
    detections away from live tracks fill the free slots as a prefix —
    slot 0 first, which the JAX package's CPU run leaves empty (Queue 3l).
    Each refilled slot holds a detection's pixel and lifted point."""
    cfg = _tracking_cfg()
    cfg = port_cfg(cfg.replace(tracker=dataclasses.replace(
        cfg.tracker, min_tracked_features=300)))
    g, d, _ = _frames()
    ts = tvo.init_tracking(cfg, t(g[1]), t(d[1]))
    valid = ts.valid.clone()
    valid[:16] = False
    u = _uniforms(cfg, jax.random.PRNGKey(0))
    ts2, res = tvo.vo_step_tracking(cfg, ts._replace(valid=valid), t(g[1]),
                                    t(d[1]), u=u)
    assert int(res.n_matches) < cfg.tracker.min_tracked_features
    head = n(ts2.valid)[:16]
    k = int(head.sum())
    assert k >= 1 and head[:k].all() and not head[k:].any()
    uv_d, xyz_d, v_d = tvo._detect_for_tracking(cfg, t(g[1]), t(d[1]))
    for slot in range(k):
        hit = np.nonzero((n(uv_d) == n(ts2.uv)[slot]).all(1) & n(v_d))[0]
        assert len(hit) == 1, slot
        np.testing.assert_array_equal(n(ts2.xyz)[slot], n(xyz_d)[hit[0]])


def test_tracking_vo_chain_matches_jax():
    """8 frames: the JAX package's run_vo(vo_version=1, seed 0) against the
    port's chain fed the uniforms of the same key chain; the port's run_vo
    on the same frames returns the same shapes."""
    cfg = _tracking_cfg()
    g, d, poses = _frames()
    ref_poses, ref_stats = jvo.run_vo(cfg, g, d, seed=0, init_pose=poses[0])
    key = jax.random.PRNGKey(0)
    draws = []
    for _ in range(len(g) - 1):
        key, sub = jax.random.split(key)
        draws.append(_uniforms(cfg, sub))
    got_poses, got_stats = tvo.vo_sequence_tracking(
        port_cfg(cfg), t(g), t(d), init_pose=t(poses[0]), draws=draws)
    np.testing.assert_allclose(n(got_poses), ref_poses, atol=1e-4)
    for f in ("n_matches", "n_inliers", "ok"):
        np.testing.assert_array_equal(n(getattr(got_stats, f)),
                                      np.asarray(getattr(ref_stats, f)))
    assert ref_stats.ok.mean() > 0.5
    p2, s2 = tvo.run_vo(port_cfg(cfg), g, d, init_pose=poses[0], device="cpu")
    assert p2.shape == (8, 7) and np.isfinite(p2).all()
    assert s2.ok.shape == (7,)
    assert not torch.is_tensor(p2)
