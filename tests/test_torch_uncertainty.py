"""Sensor-noise models: every function of geometry/uncertainty.py against
the JAX package on the same numpy inputs, on the tiny and the fr1 camera,
depths 0.4–6 m. Covariances ≤ 1e-6 relative (to the largest entry of each
matrix); information matrices, which pass through the adjugate inverse,
≤ 1e-4 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import n, port_cfg, t

from putslam_tpu.config import tiny_test_config, tum_fr1_config
from putslam_tpu.geometry import uncertainty as junc
from putslam_tpu_torch.geometry import uncertainty as tunc

CAMS = {"tiny": tiny_test_config().camera, "fr1": tum_fr1_config().camera}


def _inputs(cam, seed, N=257):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(0, cam.width - 1, N),
                   rng.uniform(0, cam.height - 1, N)], -1).astype(np.float32)
    z = rng.uniform(0.4, 6.0, N).astype(np.float32)
    return uv, z, rng


def _close(got, ref, rtol):
    """Relative to the largest entry of each trailing matrix (or to the
    value itself for a vector)."""
    got, ref = n(got), np.asarray(ref)
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True) if ref.ndim >= 3 \
        else np.abs(ref)
    assert np.all(np.abs(got - ref) <= rtol * scale + 1e-30), \
        float(np.max(np.abs(got - ref) / (scale + 1e-30)))


@pytest.mark.parametrize("cam_name", ["tiny", "fr1"])
def test_depth_sigma_and_point_covariance(cam_name):
    cam = CAMS[cam_name]
    uv, z, _ = _inputs(cam, 0)
    _close(tunc.depth_sigma(port_cfg(cam), t(z)),
           junc.depth_sigma(cam, jnp.asarray(z)), 1e-6)
    ref = junc.point_covariance(cam, jnp.asarray(uv), jnp.asarray(z))
    got = tunc.point_covariance(port_cfg(cam), t(uv), t(z))
    assert got.shape == (len(z), 3, 3)
    _close(got, ref, 1e-6)
    # batched leading dims go through as they are
    got2 = tunc.point_covariance(port_cfg(cam), t(uv).reshape(1, -1, 2),
                                 t(z).reshape(1, -1))
    np.testing.assert_array_equal(n(got2[0]), n(got))


@pytest.mark.parametrize("cam_name", ["tiny", "fr1"])
def test_information_matrix(cam_name):
    cam = CAMS[cam_name]
    uv, z, _ = _inputs(cam, 1)
    ref = junc.information_matrix(cam, jnp.asarray(uv), jnp.asarray(z))
    got = tunc.information_matrix(port_cfg(cam), t(uv), t(z))
    _close(got, ref, 1e-4)
    # symmetric positive: the BA takes its Cholesky factor
    g = n(got)
    assert np.all(np.abs(g - np.swapaxes(g, -1, -2))
                  <= 1e-4 * np.abs(g).max(axis=(-1, -2), keepdims=True))
    assert np.all(np.linalg.eigvalsh(0.5 * (g + np.swapaxes(g, -1, -2))
                                     .astype(np.float64)) > 0)


@pytest.mark.parametrize("kind", ["normal", "gradient"])
@pytest.mark.parametrize("cam_name", ["tiny", "fr1"])
def test_scaled_covariances(cam_name, kind):
    cam = CAMS[cam_name]
    uv, z, rng = _inputs(cam, 2)
    dirs = rng.normal(size=(len(z), 3)).astype(np.float32)
    dirs[::7] = 0.0                          # no direction: the clamp path
    cov = np.asarray(junc.point_covariance(cam, jnp.asarray(uv),
                                           jnp.asarray(z)))
    jfn = getattr(junc, f"{kind}_scaled_covariance")
    tfn = getattr(tunc, f"{kind}_scaled_covariance")
    for scale in (0.25, 1.0, 3.0):
        ref = jfn(jnp.asarray(cov), jnp.asarray(dirs), scale)
        _close(tfn(t(cov), t(dirs), scale), ref, 1e-6)
        _close(tunc.inv3x3(tfn(t(cov), t(dirs), scale)), junc.inv3x3(ref),
               1e-4)


def test_strasdat_information():
    z = np.random.default_rng(3).uniform(0.0, 6.0, 64).astype(np.float32)
    z[0] = 0.0                               # clamped at 1 mm
    for w in (1.0, 2.5):
        ref = junc.strasdat_information(jnp.asarray(z), w)
        got = tunc.strasdat_information(t(z), w)
        np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-6)


def test_inv_and_chol_roundtrip_match_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(128, 3, 3)).astype(np.float32)
    M = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3, dtype=np.float32)
    _close(tunc.inv3x3(t(M)), junc.inv3x3(jnp.asarray(M)), 1e-4)
    _close(tunc.chol3x3(t(M)), junc.chol3x3(jnp.asarray(M)), 1e-5)
    Lc = n(tunc.chol3x3(t(M)))
    np.testing.assert_allclose(Lc @ np.swapaxes(Lc, -1, -2), M, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("model", ["sensor", "normal", "gradient"])
def test_obs_dirs_and_full_obs_info_match_jax(model):
    """models/slam.py::_obs_dirs and _full_obs_info on a rendered frame's
    features, each uncertainty model: directions ≤ 1e-5 absolute (None for
    the sensor model), information ≤ 1e-4 relative; None without
    use_uncertainty."""
    import dataclasses

    import jax

    from putslam_tpu.frontend import detector as jdet
    from putslam_tpu.io import synthetic as jsyn
    from putslam_tpu.models import slam as jslam
    from putslam_tpu_torch import convert
    from putslam_tpu_torch.models import slam as tslam

    cfg = tiny_test_config()
    cfg = cfg.replace(map=dataclasses.replace(
        cfg.map, use_uncertainty=True, uncertainty_model=model))
    poses = jsyn.orbit_trajectory(3, radius=0.05, yaw_amp=0.05)
    g, d = jsyn.render_sequence(cfg.camera, poses)
    feat = jdet.detect_and_describe(cfg, g[1], d[1])
    pfeat = convert.from_numpy(jax.tree.map(np.asarray, feat), "cpu")
    pcfg = port_cfg(cfg)
    ref_dirs = jslam._obs_dirs(cfg, g[1], d[1], feat)
    got_dirs = tslam._obs_dirs(pcfg, t(g[1]), t(d[1]), pfeat)
    if model == "sensor":
        assert ref_dirs is None and got_dirs is None
    else:
        ref_np = np.asarray(ref_dirs)
        assert (np.linalg.norm(ref_np, axis=-1) > 0.5).sum() > 20
        np.testing.assert_allclose(n(got_dirs), ref_np, atol=1e-5)
    ref = jslam._full_obs_info(cfg, feat.uv_undist, feat.xyz, ref_dirs)
    got = tslam._full_obs_info(pcfg, pfeat.uv_undist, pfeat.xyz, got_dirs)
    _close(got, ref, 1e-4)
    off = port_cfg(tiny_test_config())
    assert tslam._full_obs_info(off, pfeat.uv_undist, pfeat.xyz) is None
    assert tslam._obs_dirs(off, t(g[1]), t(d[1]), pfeat) is None
