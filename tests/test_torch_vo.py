"""VO parity: Hamming matching, Kabsch, RANSAC fed the same uniforms, and
vo_step. Poses ≤ 1e-5; inlier masks and matches exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import n, port_cfg, t

from putslam_tpu.config import tiny_test_config
from putslam_tpu.frontend import detector as jdet
from putslam_tpu.frontend import ransac as jransac
from putslam_tpu.geometry import se3 as jse3
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import vo as jvo
from putslam_tpu.ops import kabsch as jkabsch
from putslam_tpu.ops import matching as jmatch
from putslam_tpu_torch import convert
from putslam_tpu_torch.frontend import ransac as transac
from putslam_tpu_torch.models import vo as tvo
from putslam_tpu_torch.ops import kabsch as tkabsch
from putslam_tpu_torch.ops import matching as tmatch


def _descs(rng, N, M, flip=0.1):
    a = rng.choice(np.array([-1, 1], np.int8), (N, 256))
    b = a[rng.permutation(N)[:M]].copy()
    b[rng.uniform(size=b.shape) < flip] *= -1
    return a, b


def test_hamming_and_mutual_nn_match_jax():
    rng = np.random.default_rng(0)
    a, b = _descs(rng, 128, 96)
    b[10] = b[11]                     # exact ties: first index wins
    va = rng.uniform(size=128) > 0.1
    vb = rng.uniform(size=96) > 0.1
    dj = jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(va), jnp.asarray(vb))
    dt = tmatch.hamming_matrix(t(a), t(b), t(va), t(vb))
    np.testing.assert_array_equal(n(dt), np.asarray(dj))
    for got, ref in zip(tmatch.mutual_nn(dt, 64), jmatch.mutual_nn(dj, 64)):
        np.testing.assert_array_equal(n(got), np.asarray(ref))


def _pairs(rng, N=96, outliers=0.3):
    p = rng.uniform(-1, 1, (N, 3)).astype(np.float32) + [0, 0, 2]
    T = np.asarray(jse3.make_pose(jnp.asarray([0.05, -0.02, 0.03]),
                                  jnp.asarray([1.0, 0.02, -0.03, 0.01])))
    q = np.asarray(jse3.apply(jnp.asarray(T), jnp.asarray(p)))
    q = q + rng.normal(0, 0.003, q.shape).astype(np.float32)
    bad = rng.uniform(size=N) < outliers
    q[bad] += rng.uniform(-0.5, 0.5, (bad.sum(), 3)).astype(np.float32)
    valid = rng.uniform(size=N) > 0.05
    return p.astype(np.float32), q.astype(np.float32), valid


def test_kabsch_matches_jax():
    rng = np.random.default_rng(1)
    p, q, valid = _pairs(rng, outliers=0.0)
    w = valid.astype(np.float32)
    np.testing.assert_allclose(
        n(tkabsch.weighted_kabsch(t(p), t(q), t(w))),
        np.asarray(jkabsch.weighted_kabsch(jnp.asarray(p), jnp.asarray(q),
                                           jnp.asarray(w))), atol=1e-5)
    idx = rng.integers(0, len(p), (3, 256))
    comps = [x[:, c][idx] for x in (p, q) for c in range(3)]
    np.testing.assert_allclose(
        n(tkabsch.kabsch_soa(*(t(c) for c in comps))),
        np.asarray(jkabsch.kabsch_soa(*(jnp.asarray(c) for c in comps))),
        atol=1e-5)


@pytest.mark.parametrize("outliers", [0.3, 0.85])
def test_ransac_same_draws_matches_jax(outliers):
    """Uniforms drawn the way estimate() draws them from its key, handed to
    the port through ``u``; 0.85 outliers exercises the identity fallback."""
    cfg = tiny_test_config().ransac
    rng = np.random.default_rng(2)
    p, q, valid = _pairs(rng, outliers=outliers)
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, (cfg.used_pairs, cfg.n_hypotheses), maxval=1.0)
    ref = jransac.estimate(cfg, None, key, jnp.asarray(p), jnp.asarray(q),
                           jnp.asarray(valid))
    got = transac.estimate(port_cfg(cfg), None, t(p), t(q), t(valid), u=t(u))
    np.testing.assert_allclose(n(got.pose), np.asarray(ref.pose), atol=1e-5)
    for f in ("inliers", "n_inliers", "ok"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(n(got.inlier_ratio),
                               np.asarray(ref.inlier_ratio), rtol=1e-6)


def test_vo_step_matches_jax():
    cfg = tiny_test_config()
    poses = jsyn.orbit_trajectory(8, radius=0.10, yaw_amp=0.1)
    g, d = jsyn.render_sequence(cfg.camera, poses)
    fa = jdet.detect_and_describe(cfg, g[2], d[2])
    fb = jdet.detect_and_describe(cfg, g[3], d[3])
    key = jax.random.PRNGKey(11)
    u = jax.random.uniform(key, (cfg.ransac.used_pairs,
                                 cfg.ransac.n_hypotheses), maxval=1.0)
    ref = jvo.vo_step(cfg, key, fa, fb)
    got = tvo.vo_step(port_cfg(cfg),
                      convert.from_numpy(jax.tree.map(np.asarray, fa), "cpu"),
                      convert.from_numpy(jax.tree.map(np.asarray, fb), "cpu"),
                      u=t(u))
    assert bool(ref.ok)
    np.testing.assert_allclose(n(got.rel_pose), np.asarray(ref.rel_pose),
                               atol=1e-5)
    for f in ("n_matches", "n_inliers", "ok"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))


def _retry_draws(cfg, key):
    """The uniforms of vo_step's two RANSAC calls when the rescue branch is
    compiled in (putslam_tpu/models/vo.py:59-60: the key is split once
    more, the strict pass draws from the first half, the rescue from the
    second)."""
    shape = (cfg.ransac.used_pairs, cfg.ransac.n_hypotheses)
    k1, k2 = jax.random.split(key)
    return (t(jax.random.uniform(k1, shape, maxval=1.0)),
            t(jax.random.uniform(k2, shape, maxval=1.0)))


def _degraded_pair(cfg):
    """Two frames whose depth noise (σ 20 mm) defeats an 8 mm RANSAC gate."""
    poses = jsyn.orbit_trajectory(3, radius=0.04, yaw_amp=0.03)
    g, d = jsyn.render_sequence(cfg.camera, poses)
    noisy = np.asarray(d) + np.random.default_rng(0).normal(
        0, 0.02, np.asarray(d).shape).astype(np.float32)
    return [jdet.detect_and_describe(cfg, jnp.asarray(g[i]),
                                     jnp.asarray(noisy[i])) for i in (0, 1)]


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("strict_gate", [0.008, None])
def test_vo_step_hamming_slack_rescue_matches_jax(strict_gate, force):
    """retry_hamming_slack=16 with an 8× threshold growth. With the strict
    8 mm gate the first pass fails on the noisy frames and the widened one
    is adopted; with the default gate the first pass holds and the rescue
    runs only when forced, and is not adopted. Pose ≤ 1e-5, counts exact."""
    import dataclasses

    cfg = tiny_test_config()
    rc = cfg.ransac if strict_gate is None else dataclasses.replace(
        cfg.ransac, inlier_threshold_euclidean=strict_gate)
    cfg = cfg.replace(ransac=rc, matcher=dataclasses.replace(
        cfg.matcher, retry_hamming_slack=16.0, retry_threshold_growth=8.0))
    f0, f1 = _degraded_pair(cfg)
    key = jax.random.PRNGKey(4)
    u, u_retry = _retry_draws(cfg, key)
    ref = jvo.vo_step(cfg, key, f0, f1, force_retry=force)
    p0, p1 = (convert.from_numpy(jax.tree.map(np.asarray, f), "cpu")
              for f in (f0, f1))
    got = tvo.vo_step(port_cfg(cfg), p0, p1, u=u, u_retry=u_retry,
                      force_retry=force)
    off = cfg.replace(matcher=dataclasses.replace(
        cfg.matcher, retry_hamming_slack=0.0, retry_threshold_growth=1.0))
    strict = tvo.vo_step(port_cfg(off), p0, p1, u=u)
    assert bool(ref.ok)
    assert bool(strict.ok) == (strict_gate is None)    # the rescue rescued
    np.testing.assert_allclose(n(got.rel_pose), np.asarray(ref.rel_pose),
                               atol=1e-5)
    for f in ("n_matches", "n_inliers", "ok"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
    if strict_gate is None:         # rescue-only: the strict result stays
        np.testing.assert_array_equal(n(got.rel_pose), n(strict.rel_pose))
    # a 0-d tensor forces the retry as the bool does
    got_t = tvo.vo_step(port_cfg(cfg), p0, p1, u=u, u_retry=u_retry,
                        force_retry=t(np.asarray(force)))
    np.testing.assert_array_equal(n(got_t.rel_pose), n(got.rel_pose))


def test_widened_ransac_scales_the_three_thresholds():
    rc = port_cfg(tiny_test_config().ransac)
    assert tvo.widened_ransac(rc, 1.0) is rc
    w = tvo.widened_ransac(rc, 4.0)
    for f in ("inlier_threshold_euclidean", "inlier_threshold_reprojection",
              "inlier_threshold_mahalanobis"):
        assert getattr(w, f) == 4.0 * getattr(rc, f)
    assert w.n_hypotheses == rc.n_hypotheses


@pytest.mark.parametrize("over", [
    dict(ransac=dict(error_version=1)),
    dict(ransac=dict(error_version=2, quality_tau=10.0)),
    dict(ransac=dict(error_version=4)),
    dict(detector=dict(grid_policy="exact")),
    dict(matcher=dict(retry_hamming_slack=16.0, retry_threshold_growth=2.0)),
])
def test_run_vo_accepts_the_options(over):
    """run_vo of the port with each option on the first 5 frames of a
    30-frame orbit: a finite trajectory within 2 cm of the truth."""
    import dataclasses

    cfg = tiny_test_config()
    cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                         for k, v in over.items()})
    poses = np.asarray(jsyn.orbit_trajectory(30, radius=0.10,
                                             yaw_amp=0.1))[:5]
    g, d = (np.asarray(x) for x in jsyn.render_sequence(cfg.camera,
                                                        jnp.asarray(poses)))
    est, _ = tvo.run_vo(port_cfg(cfg), g, d, init_pose=poses[0], device="cpu")
    est = n(est)
    assert est.shape == (5, 7) and np.all(np.isfinite(est))
    assert np.abs(est[:, :3] - poses[:, :3]).max() < 0.02
    assert np.abs(est[-1, :3] - est[0, :3]).max() > 0.01       # it moved


def test_check_vo_config_rejects_unknown_values():
    import dataclasses

    cfg = tiny_test_config()
    with pytest.raises(ValueError):
        tvo.check_vo_config(port_cfg(cfg.replace(ransac=dataclasses.replace(
            cfg.ransac, error_version=5))))
    with pytest.raises(NotImplementedError):
        tvo.check_vo_config(port_cfg(cfg).replace(vo_version=2))
    tvo.check_vo_config(port_cfg(cfg))
