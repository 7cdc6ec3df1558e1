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
from _torch_port import n, port_cfg, t

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu_torch.io import synthetic as tsyn

CAM = tiny_test_config().camera
PCAM = port_cfg(CAM)
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
    gt, dt = tsyn.render_frame(PCAM, t(pose))
    np.testing.assert_allclose(n(dt), np.asarray(dj), atol=1e-5, rtol=0)
    close = np.abs(n(gt) - _wall_reference(pose)) <= 1e-5
    assert close.mean() >= 0.999, close.mean()


def test_axis_aligned_frame_matches_jax_render():
    pose = np.array([0.05, -0.02, -0.4, 1.0, 0.0, 0.0, 0.0], np.float32)
    gj, dj = jsyn.render_frame(CAM, jnp.asarray(pose))
    gt, dt = tsyn.render_frame(PCAM, t(pose))
    close = np.abs(n(gt) - np.asarray(gj)) <= 1e-5
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_allclose(n(dt), np.asarray(dj), atol=1e-5, rtol=0)


def test_render_sequence_shapes():
    g, d = tsyn.render_sequence(PCAM, tsyn.orbit_trajectory(2))
    assert g.shape == d.shape == (2, CAM.height, CAM.width)
    assert bool(torch.isfinite(g).all()) and float(g.min()) >= 0.0


def test_revisit_trajectory_matches_jax():
    for T, sweep in ((64, 1.2), (24, 0.6)):
        np.testing.assert_allclose(
            n(tsyn.revisit_trajectory(T, sweep=sweep)),
            np.asarray(jsyn.revisit_trajectory(T, sweep=sweep)), atol=1e-6)


def _frames3():
    g, d = jsyn.render_sequence(CAM, jnp.asarray(ORBIT[:3]))
    return np.asarray(g), np.asarray(d)


@pytest.mark.parametrize("blur", [1, 2])
def test_blur_only_degrade_matches_jax(blur):
    """The box blur (zero-padded 'same' convolution per row) is
    deterministic: equal to the JAX package's within 1e-6; depth passes
    through untouched."""
    g, d = _frames3()
    gj, dj = jsyn.degrade_sequence(g, d, seed=1, blur=blur)
    gt, dt = tsyn.degrade_sequence(t(g), t(d), seed=1, blur=blur)
    np.testing.assert_allclose(n(gt), np.asarray(gj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(n(dt), np.asarray(dj))


def test_degrade_noise_statistics():
    """The port draws from a seeded torch.Generator (not jax.random), so
    its noise is checked by its statistics: image noise σ and clipping,
    depth noise σ and the ≥ 0 clamp, the hole fraction; the same seed
    gives the same frames."""
    g = torch.full((4, 96, 128), 0.5)
    d = torch.full((4, 96, 128), 2.0)
    g2, d2 = tsyn.degrade_sequence(g, d, seed=3, intensity_sigma=0.03,
                                   depth_sigma=0.01, depth_dropout=0.25)
    dg = (g2 - g).flatten()
    assert abs(float(dg.mean())) < 1e-3
    assert abs(float(dg.std()) - 0.03) < 1e-3
    holes = d2 == 0.0
    assert abs(float(holes.float().mean()) - 0.25) < 0.01
    dd = (d2 - d)[~holes]
    assert abs(float(dd.std()) - 0.01) < 5e-4
    g3, d3 = tsyn.degrade_sequence(g, d, seed=3, intensity_sigma=0.03,
                                   depth_sigma=0.01, depth_dropout=0.25)
    assert torch.equal(g2, g3) and torch.equal(d2, d3)
    gc, dc = tsyn.degrade_sequence(torch.full((1, 8, 8), 0.999),
                                   torch.full((1, 8, 8), 0.001), seed=0,
                                   intensity_sigma=0.5, depth_sigma=0.5)
    assert float(gc.max()) <= 1.0 and float(gc.min()) >= 0.0
    assert float(dc.min()) >= 0.0 and bool((dc == 0.0).any())
