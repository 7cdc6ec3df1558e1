"""The device renderer against the JAX package's.

Depth ≤ 1e-5 for every pose. Intensity: the reference's hit point o + t·d
sits on a texture-cell boundary along the wall normal, so its texture
layer there is decided by a one-ulp rounding, pixel by pixel (ROADMAP
Queue 3); the port puts the hit exactly on the wall. So the port's gray
is held (≥ 99.9 % of pixels within 1e-5) against the JAX package's
render_frame where that rounding is not in play (an axis-aligned camera),
and against the JAX package's texture3d at the exact wall points for
rotated poses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, t

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu_torch.io import synthetic as tsyn

CAM = tiny_test_config().camera
ORBIT = np.asarray(jsyn.orbit_trajectory(12, radius=0.10, yaw_amp=0.1))


def test_hash_wraps_like_uint32():
    rng = np.random.default_rng(0)
    cells = [rng.integers(-200, 200, 4096).astype(np.float32) for _ in range(3)]
    for seed in (7, 9):
        ref = np.asarray(jsyn._hash3(*(jnp.asarray(c) for c in cells), seed))
        np.testing.assert_array_equal(
            n(tsyn._hash3(*(t(c) for c in cells), seed)), ref)


def test_texture_matches_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(-3, 3, (8192, 3)).astype(np.float32)
    fp = rng.uniform(0, 0.08, 8192).astype(np.float32)
    np.testing.assert_allclose(
        n(tsyn.texture3d(t(p), t(fp))),
        np.asarray(jsyn.texture3d(jnp.asarray(p), jnp.asarray(fp))),
        atol=1e-6, rtol=0)


def test_orbit_trajectory_matches_jax():
    np.testing.assert_allclose(
        n(tsyn.orbit_trajectory(12, radius=0.10, yaw_amp=0.1)), ORBIT,
        atol=1e-6)


def _wall_reference(pose, ss=2):
    """The JAX package's texture3d at exact wall hits (float64 rays)."""
    H, W = CAM.height, CAM.width
    u = (np.arange(W * ss) + 0.5) / ss - 0.5
    v = (np.arange(H * ss) + 0.5) / ss - 0.5
    uu, vv = np.meshgrid(u, v)
    d_cam = np.stack([(uu - CAM.cu) / CAM.fu, (vv - CAM.cv) / CAM.fv,
                      np.ones_like(uu)], -1)
    R = n(tsyn.se3.quat_to_matrix(t(pose[3:]).double()))
    o = pose[:3].astype(np.float64)
    d = d_cam @ R.T
    lo, hi = np.array([-3.0, -2.0, -3.0]), np.array([3.0, 2.0, 3.0])
    t_far = np.maximum((hi - o) / d, (lo - o) / d)
    axis = np.argmin(t_far, -1)
    tt = t_far.min(-1)
    hit = o + tt[..., None] * d
    face = np.where(d > 0, hi, lo)
    onehot = np.eye(3, dtype=bool)[axis]
    hit = np.where(onehot, face, hit)
    cos = np.take_along_axis(np.abs(d), axis[..., None], -1)[..., 0] \
        / np.linalg.norm(d, axis=-1)
    fp = tt * np.linalg.norm(d, axis=-1) / (CAM.fu * ss) / np.maximum(cos, 0.05)
    g = np.asarray(jsyn.texture3d(jnp.asarray(hit, jnp.float32),
                                  jnp.asarray(fp, jnp.float32)))
    return g.reshape(H, ss, W, ss).mean(axis=(1, 3))


@pytest.mark.parametrize("i", [0, 4, 9])
def test_render_frame_matches_jax(i):
    pose = ORBIT[i]
    gj, dj = jsyn.render_frame(CAM, jnp.asarray(pose))
    gt, dt = tsyn.render_frame(CAM, t(pose))
    np.testing.assert_allclose(n(dt), np.asarray(dj), atol=1e-5, rtol=0)
    close = np.abs(n(gt) - _wall_reference(pose)) <= 1e-5
    assert close.mean() >= 0.999, close.mean()


def test_axis_aligned_frame_matches_jax_render():
    pose = np.array([0.05, -0.02, -0.4, 1.0, 0.0, 0.0, 0.0], np.float32)
    gj, dj = jsyn.render_frame(CAM, jnp.asarray(pose))
    gt, dt = tsyn.render_frame(CAM, t(pose))
    close = np.abs(n(gt) - np.asarray(gj)) <= 1e-5
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_allclose(n(dt), np.asarray(dj), atol=1e-5, rtol=0)


def test_render_sequence_shapes():
    g, d = tsyn.render_sequence(CAM, tsyn.orbit_trajectory(2))
    assert g.shape == d.shape == (2, CAM.height, CAM.width)
    assert bool(torch.isfinite(g).all()) and float(g.min()) >= 0.0
