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
