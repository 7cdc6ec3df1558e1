"""Parity of putslam_tpu_torch.geometry with putslam_tpu.geometry.
Tolerance: float32, ≤ 1e-6 absolute (≤ 1e-5 for the 8-step undistort)."""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import n, port_cfg, t

from putslam_tpu.config import CameraConfig
from putslam_tpu.geometry import camera as jcam
from putslam_tpu.geometry import se3 as jse3
from putslam_tpu.geometry import uncertainty as junc
from putslam_tpu_torch.geometry import camera as tcam
from putslam_tpu_torch.geometry import se3 as tse3
from putslam_tpu_torch.geometry import uncertainty as tunc


def _poses(rng, k=64, rot=1.0):
    tr = rng.normal(0, 0.5, (k, 3)).astype(np.float32)
    q = rng.normal(0, 1, (k, 4)).astype(np.float32)
    q[:, 0] += rot * 3.0
    return np.asarray(jse3.make_pose(jnp.asarray(tr), jnp.asarray(q)))


def _twists(rng, k=64):
    xi = rng.normal(0, 0.3, (k, 6)).astype(np.float32)
    xi[: k // 4, 3:] *= 1e-4      # the small-angle Taylor branches
    return xi


CASES = {
    "compose": lambda m, a, b, xi, p: m.compose(a, b),
    "inverse": lambda m, a, b, xi, p: m.inverse(a),
    "relative": lambda m, a, b, xi, p: m.relative(a, b),
    "apply": lambda m, a, b, xi, p: m.apply(a, p),
    "apply_soa": lambda m, a, b, xi, p: m.apply_soa(
        a, p[..., 0], p[..., 1], p[..., 2])[1],
    "quat_to_matrix": lambda m, a, b, xi, p: m.quat_to_matrix(
        m.rotation_quat(a)),
    "exp": lambda m, a, b, xi, p: m.exp(xi),
    "log": lambda m, a, b, xi, p: m.log(a),
    "retract": lambda m, a, b, xi, p: m.retract(a, xi),
    "boxminus": lambda m, a, b, xi, p: m.boxminus(a, b),
    "jl_inv_blocks": lambda m, a, b, xi, p: m.se3_left_jacobian_inv_blocks(
        xi)[1],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_se3_matches_jax(name):
    rng = np.random.default_rng(1)
    a, b = _poses(rng), _poses(rng)
    xi = _twists(rng)
    p = rng.normal(0, 2, (64, 3)).astype(np.float32)
    ref = CASES[name](jse3, *(jnp.asarray(x) for x in (a, b, xi, p)))
    got = CASES[name](tse3, *(t(x) for x in (a, b, xi, p)))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-6, rtol=0)


FR1 = CameraConfig()
PFR1 = port_cfg(FR1)


def test_camera_matches_jax():
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(0, 639, 512), rng.uniform(0, 479, 512)],
                  -1).astype(np.float32)
    z = rng.uniform(0.05, 7.0, 512).astype(np.float32)
    und_j = np.asarray(jcam.undistort_pixels(FR1, jnp.asarray(uv)))
    und_t = n(tcam.undistort_pixels(PFR1, t(uv)))
    np.testing.assert_allclose(und_t, und_j, atol=1e-5, rtol=0)
    xyz_j = np.asarray(jcam.unproject(FR1, jnp.asarray(und_j), jnp.asarray(z)))
    xyz_t = n(tcam.unproject(PFR1, t(und_j), t(z)))
    np.testing.assert_allclose(xyz_t, xyz_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        n(tcam.project(PFR1, t(xyz_j))),
        np.asarray(jcam.project(FR1, jnp.asarray(xyz_j))), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(
        n(tcam.depth_valid_mask(PFR1, t(z))),
        np.asarray(jcam.depth_valid_mask(FR1, jnp.asarray(z))))
    img = rng.uniform(0, 5, (480, 640)).astype(np.float32)
    np.testing.assert_array_equal(
        n(tcam.sample_depth(t(img), t(uv))),
        np.asarray(jcam.sample_depth(jnp.asarray(img), jnp.asarray(uv))))
    np.testing.assert_allclose(
        n(tcam.bilinear_sample(t(img), t(uv))),
        np.asarray(jcam.bilinear_sample(jnp.asarray(img), jnp.asarray(uv))),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn", ["inv3x3", "chol3x3"])
def test_3x3_solvers_match_jax(fn):
    rng = np.random.default_rng(3)
    A = rng.normal(0, 1, (256, 3, 3)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    ref = np.asarray(getattr(junc, fn)(jnp.asarray(M)))
    got = n(getattr(tunc, fn)(t(M)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)
