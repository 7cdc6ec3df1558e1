"""Dense RGB-D geometry (ops/rgbd.py) against the JAX package: the point
map, surface normals, Scharr gradients and the per-feature 3D gradient
directions, on a frame rendered by the JAX package and on a depth image
with holes and out-of-gate values. Values ≤ 1e-5 absolute; validity (the
zero normals, the zero directions) exact; the cloud and its PLY file equal."""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import n, port_cfg, t

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.ops import rgbd as jrgbd
from putslam_tpu_torch.ops import rgbd as trgbd


@pytest.fixture(scope="module")
def frames():
    cfg = tiny_test_config()
    poses = jsyn.orbit_trajectory(2, radius=0.10, yaw_amp=0.1)
    g, d = jsyn.render_sequence(cfg.camera, poses)
    g, d = np.asarray(g[1]), np.asarray(d[1])
    rng = np.random.default_rng(0)
    holes = d.copy()
    holes[rng.uniform(size=d.shape) < 0.05] = 0.0          # dropouts
    holes[10:20, 30:50] = 0.0                              # a hole
    holes[0, :] = 9.0                                      # beyond the gate
    holes[:, -1] = 0.05                                    # nearer than it
    noise = (rng.uniform(0.4, 6.0, d.shape)).astype(np.float32)
    return cfg.camera, g, {"rendered": d, "holes": holes, "noise": noise}


@pytest.mark.parametrize("which", ["rendered", "holes", "noise"])
def test_point_map_and_normals(frames, which):
    cam, _, depths = frames
    d = depths[which]
    np.testing.assert_allclose(
        n(trgbd.point_map(port_cfg(cam), t(d))),
        np.asarray(jrgbd.point_map(cam, jnp.asarray(d))), atol=1e-6)
    ref = np.asarray(jrgbd.surface_normals(cam, jnp.asarray(d)))
    got = n(trgbd.surface_normals(port_cfg(cam), t(d)))
    # the validity mask (with the reference's wrap round the border) exact
    np.testing.assert_array_equal(np.all(got == 0, -1), np.all(ref == 0, -1))
    if which == "noise":
        # a near-degenerate cross product can flip its orientation test on
        # the last bit: compare where the test is not within rounding
        P = np.asarray(jrgbd.point_map(cam, jnp.asarray(d)))
        sure = np.abs(np.sum(ref * P, -1)) > 1e-3
        assert sure.mean() > 0.95
        np.testing.assert_allclose(got[sure], ref[sure], atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5)
    live = ~np.all(ref == 0, -1)
    assert live.sum() > 100
    np.testing.assert_allclose(np.linalg.norm(got[live], axis=-1), 1.0,
                               atol=1e-5)


def test_image_gradients(frames):
    cam, g, _ = frames
    noise = np.random.default_rng(1).uniform(0, 1, g.shape).astype(np.float32)
    for img in (g, noise):
        for got, ref in zip(trgbd.image_gradients(t(img)),
                            jrgbd.image_gradients(jnp.asarray(img))):
            np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)
    # a ramp to the right has a positive x gradient: the filter is not flipped
    ramp = np.tile(np.linspace(0, 1, 32, dtype=np.float32), (16, 1))
    gx, gy = trgbd.image_gradients(t(ramp))
    assert float(gx[8, 16]) > 0 and abs(float(gy[8, 16])) < 1e-6


def test_gradient_directions_3d(frames):
    cam, g, depths = frames
    rng = np.random.default_rng(2)
    N = 200
    uv = np.stack([rng.uniform(-3, cam.width + 3, N),
                   rng.uniform(-3, cam.height + 3, N)], -1).astype(np.float32)
    z = rng.uniform(0.4, 6.0, N).astype(np.float32)
    flat = np.full_like(g, 0.5)                           # zero gradient
    for img in (g, flat):
        ref = np.asarray(jrgbd.gradient_directions_3d(
            cam, jnp.asarray(img), jnp.asarray(uv), jnp.asarray(z)))
        got = n(trgbd.gradient_directions_3d(port_cfg(cam), t(img), t(uv),
                                             t(z)))
        np.testing.assert_array_equal(np.all(got == 0, -1),
                                      np.all(ref == 0, -1))
        np.testing.assert_allclose(got, ref, atol=1e-5)
    # the flat image has a gradient only at its zero-padded border
    assert np.all(got == 0, -1).mean() > 0.8


def test_colored_point_cloud_and_ply(frames, tmp_path):
    cam, g, depths = frames
    d = depths["holes"]
    for stride in (1, 3):
        ref = jrgbd.colored_point_cloud(cam, jnp.asarray(g), jnp.asarray(d),
                                        stride)
        got = trgbd.colored_point_cloud(port_cfg(cam), t(g), t(d), stride)
        np.testing.assert_allclose(n(got[0]), np.asarray(ref[0]), atol=1e-6)
        np.testing.assert_array_equal(n(got[1]), np.asarray(ref[1]))
        np.testing.assert_array_equal(n(got[2]), np.asarray(ref[2]))
    jrgbd.save_ply(str(tmp_path / "j.ply"), *ref)
    trgbd.save_ply(str(tmp_path / "t.ply"), *got)
    a = (tmp_path / "j.ply").read_text().splitlines()
    b = (tmp_path / "t.ply").read_text().splitlines()
    assert a[:9] == b[:9] and len(a) == len(b)
    body_a = np.array([x.split() for x in a[9:]], np.float64)
    body_b = np.array([x.split() for x in b[9:]], np.float64)
    np.testing.assert_allclose(body_b, body_a, atol=1.01e-4)
    trgbd.save_ply(str(tmp_path / "p.ply"), got[0])       # points alone
    assert "property uchar gray" not in (tmp_path / "p.ply").read_text()
