"""Parity of the public helpers the port had lacked in modules it had
already ported (ROADMAP Queue 1 item 2): the same numpy inputs through the
JAX function and its counterpart.

Tolerances: float32 closed forms 1e-5 absolute (1e-6 where the algebra is
a few products); ``matrix_to_quat`` picks the same candidate, so quaternions
within 1e-6; ``orientations`` within 1e-4 rad (float32 moment sums in
another order); ``transform_covariance`` inverts a damped 6×6 in float32:
1e-4 relative; ``pp_jacobians_autodiff`` against the port's closed form
within 1e-4 relative to the largest entry and against the JAX autodiff
within 1e-5; the synthetic sequence's poses exactly and its depths within
1e-6 (its grays only against the port's own renderer: the wall textures
of the two packages differ, ROADMAP 3h)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t

from putslam_tpu.backend import factors as jfactors
from putslam_tpu.config import CameraConfig, tiny_test_config
from putslam_tpu.geometry import camera as jcam
from putslam_tpu.geometry import se3 as jse3
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.ops import brief as jbrief
from putslam_tpu.ops import kabsch as jkabsch
from putslam_tpu_torch.backend import factors as tfactors
from putslam_tpu_torch.geometry import camera as tcam
from putslam_tpu_torch.geometry import se3 as tse3
from putslam_tpu_torch.io import synthetic as tsyn
from putslam_tpu_torch.ops import brief as tbrief
from putslam_tpu_torch.ops import kabsch as tkabsch


def _poses(rng, n_, rot=0.8):
    xi = np.concatenate([rng.normal(0, 0.5, (n_, 3)),
                         rng.normal(0, rot, (n_, 3))], -1).astype(np.float32)
    return np.array(jse3.exp(jnp.asarray(xi)))


def _twists(rng, n_):
    """Twists with rotation angles from 0 (the Taylor branches) to ~2."""
    xi = np.concatenate([rng.normal(0, 0.5, (n_, 3)),
                         rng.normal(0, 0.7, (n_, 3))], -1).astype(np.float32)
    xi[:4, 3:] *= np.array([0.0, 1e-5, 1e-3, 0.1], np.float32)[:, None]
    return xi


def test_quat_identity_matches_jax():
    for shape in [(), (3,), (2, 5)]:
        got = tse3.quat_identity(shape)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(n(got),
                                      np.asarray(jse3.quat_identity(shape)))


def test_matrix_round_trips_match_jax():
    rng = np.random.default_rng(0)
    p = _poses(rng, 64)
    # the four candidate branches: rotations of π about x, y, z and none
    p[:4, 3:] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    M = n(tse3.to_matrix(t(p)))
    np.testing.assert_allclose(M, np.asarray(jse3.to_matrix(jnp.asarray(p))),
                               atol=1e-6)
    assert M.shape == (64, 4, 4) and np.all(M[:, 3] == [0, 0, 0, 1])
    q = n(tse3.matrix_to_quat(t(M[:, :3, :3])))
    np.testing.assert_allclose(
        q, np.asarray(jse3.matrix_to_quat(jnp.asarray(M[:, :3, :3]))),
        atol=1e-6)
    back = n(tse3.from_matrix(t(M)))
    np.testing.assert_allclose(
        back, np.asarray(jse3.from_matrix(jnp.asarray(M))), atol=1e-6)
    # the round trip recovers the pose up to the quaternion's sign
    sign = np.where(p[:, 3:4] < 0, -1.0, 1.0)
    np.testing.assert_allclose(back[:, :3], p[:, :3], atol=1e-6)
    np.testing.assert_allclose(back[:, 3:], sign * p[:, 3:], atol=1e-5)


def test_adjoint_and_jacobian_inverses_match_jax():
    rng = np.random.default_rng(1)
    p = _poses(rng, 32)
    xi = _twists(rng, 32)
    np.testing.assert_allclose(n(tse3.adjoint(t(p))),
                               np.asarray(jse3.adjoint(jnp.asarray(p))),
                               atol=1e-5)
    for tf, jf in ((tse3.se3_left_jacobian_inv, jse3.se3_left_jacobian_inv),
                   (tse3.se3_right_jacobian_inv,
                    jse3.se3_right_jacobian_inv)):
        got = n(tf(t(xi)))
        assert got.shape == (32, 6, 6)
        np.testing.assert_allclose(got, np.asarray(jf(jnp.asarray(xi))),
                                   atol=1e-5)
    # Ad(T)·ξ conjugates: T·exp(ξ)·T⁻¹ = exp(Ad(T)·ξ)
    small = 0.1 * xi
    lhs = tse3.compose(tse3.compose(t(p), tse3.exp(t(small))),
                       tse3.inverse(t(p)))
    rhs = tse3.exp(torch.einsum("kij,kj->ki", tse3.adjoint(t(p)), t(small)))
    np.testing.assert_allclose(n(tse3.to_matrix(lhs)),
                               n(tse3.to_matrix(rhs)), atol=1e-5)


def _distorted_camera():
    return CameraConfig(fu=500.0, fv=510.0, cu=320.0, cv=240.0, k1=0.08,
                        k2=-0.04, p1=0.001, p2=-0.002, k3=0.01)


def test_camera_helpers_match_jax():
    cam = _distorted_camera()
    pc = port_cfg(cam)
    rng = np.random.default_rng(2)
    xyz = np.stack([rng.uniform(-1.5, 1.5, 200), rng.uniform(-1, 1, 200),
                    rng.uniform(0.5, 4, 200)], -1).astype(np.float32)
    xyz[0, 2] = 0.0                                      # the tiny-z guard
    np.testing.assert_array_equal(
        n(tcam.intrinsics_matrix(pc)),
        np.asarray(jcam.intrinsics_matrix(cam)))
    xy = xyz[:, :2] / np.maximum(xyz[:, 2:], 0.5)
    np.testing.assert_allclose(
        n(tcam.distort_normalized(pc, t(xy))),
        np.asarray(jcam.distort_normalized(cam, jnp.asarray(xy))), atol=1e-6)
    for distort in (False, True):
        uv = n(tcam.project(pc, t(xyz), distort=distort))
        np.testing.assert_allclose(
            uv, np.asarray(jcam.project(cam, jnp.asarray(xyz),
                                        distort=distort)), rtol=1e-6)
    uv = n(tcam.project(pc, t(xyz[1:]), distort=True))
    for undistort in (False, True):
        got = n(tcam.unproject(pc, t(uv), t(xyz[1:, 2]), undistort=undistort))
        np.testing.assert_allclose(
            got, np.asarray(jcam.unproject(cam, jnp.asarray(uv),
                                           jnp.asarray(xyz[1:, 2]),
                                           undistort=undistort)), atol=1e-5)
    # distort ∘ undistort: the round trip lands back on the points where
    # the fixed 8 iterations converge (within 0.6 of the axis)
    back = n(tcam.unproject(pc, t(uv), t(xyz[1:, 2]), undistort=True))
    near = np.linalg.norm(xyz[1:, :2] / xyz[1:, 2:], axis=1) < 0.6
    assert near.sum() > 20
    assert np.abs(back - xyz[1:])[near].max() < 1e-3
    uv_any = rng.uniform(-20, 660, (300, 2)).astype(np.float32)
    for border in (0.0, 8.0):
        np.testing.assert_array_equal(
            n(tcam.in_image_mask(pc, t(uv_any), border)),
            np.asarray(jcam.in_image_mask(cam, jnp.asarray(uv_any), border)))


def _aligned_sets(rng, B=4, N=40):
    T = _poses(rng, B, rot=0.3)
    p = (rng.uniform(-1, 1, (B, N, 3)) + [0, 0, 2]).astype(np.float32)
    q = np.asarray(jse3.apply(jnp.asarray(T)[:, None, :], jnp.asarray(p)))
    q = (q + rng.normal(0, 0.01, q.shape)).astype(np.float32)
    w = (rng.uniform(size=(B, N)) > 0.2).astype(np.float32)
    return T, p, q, w


def test_alignment_residuals_and_covariance_match_jax():
    rng = np.random.default_rng(3)
    T, p, q, w = _aligned_sets(rng)
    np.testing.assert_allclose(
        n(tkabsch.alignment_residuals(t(T), t(p), t(q))),
        np.asarray(jkabsch.alignment_residuals(jnp.asarray(T), jnp.asarray(p),
                                               jnp.asarray(q))), atol=1e-6)
    got = n(tkabsch.transform_covariance(t(T), t(p), t(w), point_var=1e-4))
    ref = np.asarray(jkabsch.transform_covariance(
        jnp.asarray(T), jnp.asarray(p), jnp.asarray(w), point_var=1e-4))
    assert got.shape == (4, 6, 6)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(got, np.swapaxes(got, -1, -2),
                               atol=1e-6 * np.abs(got).max())


def test_box_blur_and_orientations_match_jax():
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(48, 64)).astype(np.float32)
    for radius in (1, 2):
        np.testing.assert_allclose(
            n(tbrief.box_blur(t(img), radius)),
            np.asarray(jbrief.box_blur(jnp.asarray(img), radius)), atol=1e-6)
    patches = rng.uniform(size=(20, 32, 32)).astype(np.float32)
    patches[0] = np.linspace(0, 1, 32)[None, :]          # a pure x gradient
    got = n(tbrief.orientations(t(patches)))
    # float32 moment sums over 1024 pixels in another order: 1e-4 rad
    np.testing.assert_allclose(
        got, np.asarray(jbrief.orientations(jnp.asarray(patches))),
        atol=1e-4)
    assert abs(got[0]) < 1e-5


def test_pp_jacobians_autodiff_matches_the_closed_form_and_jax():
    rng = np.random.default_rng(5)
    pi, pj = _poses(rng, 6, rot=0.4), _poses(rng, 6, rot=0.4)
    z = np.asarray(jse3.retract(jse3.relative(jnp.asarray(pi),
                                              jnp.asarray(pj)),
                                jnp.asarray(_twists(rng, 6) * 0.05)))
    Ji, Jj = tfactors.pp_jacobians_autodiff(t(pi), t(pj), t(z))
    Ci, Cj = tfactors.pp_jacobians(t(pi), t(pj), t(z))
    Ri, Rj = jfactors.pp_jacobians_autodiff(jnp.asarray(pi), jnp.asarray(pj),
                                            jnp.asarray(z))
    for auto, closed, ref in ((Ji, Ci, Ri), (Jj, Cj, Rj)):
        scale = float(closed.abs().max())
        np.testing.assert_allclose(n(auto), n(closed), atol=1e-4 * scale)
        np.testing.assert_allclose(n(auto), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("motion", ["orbit", "static"])
def test_synthetic_sequence(motion):
    """Poses equal to the JAX function's, depths within 1e-6; the grays
    against the port's own renderer, whose wall texture deviates from the
    reference's by design (ROADMAP 3h)."""
    jc = tiny_test_config().camera
    cam = port_cfg(jc)
    g, d, p = tsyn.synthetic_sequence(cam, n_frames=3, motion=motion,
                                      device="cpu")
    jg, jd, jp = jsyn.synthetic_sequence(jc, 3, motion=motion)
    assert isinstance(g, np.ndarray) and g.shape == jg.shape
    assert d.dtype == jd.dtype and p.shape == jp.shape == (3, 7)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(d, jd, atol=1e-6, rtol=0)
    rg, _ = tsyn.render_sequence(cam, t(p))
    np.testing.assert_array_equal(g, n(rg))
    with pytest.raises(ValueError):
        jsyn.synthetic_sequence(jc, 2, motion="spiral")
    with pytest.raises(ValueError):
        tsyn.synthetic_sequence(cam, 2, motion="spiral", device="cpu")
