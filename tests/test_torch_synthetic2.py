"""The plane-scene renderer (io/synthetic2.py) against the JAX package's
numpy original on the same poses: the planes' texture parameters equal
exactly; texture values within 1e-10 (torch's and numpy's float64 `sin`
differ in the last bit on a few inputs, 3 of 4096 here, and the speckle
hash multiplies that by 43758.5453: 1.2e-12 measured); rendered depth within 1e-6 m and gray
with max |Δ| ≤ 1e-5 on at least 99.9 % of pixels (on the CPU all of them
are equal: 0 of 196,608 pixels differ over four tiny-camera frames of a
handheld walk; on the card `dirs @ n` may sum in another order and flip a
speckle cell where `floor(a · speckle_scale)` sits on a boundary, which the
99.9 % allows and `chip_smoke.py` phase 17c counts)."""

import numpy as np
import pytest
import torch
from _torch_port import n, t

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.io import synthetic2 as j2
from putslam_tpu_torch.io import synthetic2 as t2

GRAY_TOL, GRAY_SHARE, DEPTH_TOL = 1e-5, 0.999, 1e-6


def test_planes_and_textures_match():
    jp, tp = j2.default_room(), t2.default_room()
    assert len(jp) == len(tp) == 7
    rng = np.random.default_rng(2)
    a = rng.uniform(-2.0, 2.0, (64, 64))
    b = rng.uniform(-2.0, 2.0, (64, 64))
    for pj, pt in zip(jp, tp):
        for name in ("p0", "e1", "e2", "n", "h1", "h2", "freqs", "phases",
                     "amps", "base", "speckle_seed", "speckle_amp",
                     "speckle_scale"):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(pj, name), err_msg=name)
        got = n(pt.texture(t(a), t(b)))
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, pj.texture(a, b), rtol=0, atol=1e-10)


def _held(gray, depth, jg, jd):
    """Depth within DEPTH_TOL; the share of gray pixels within GRAY_TOL."""
    np.testing.assert_allclose(depth, jd, rtol=0, atol=DEPTH_TOL)
    share = float(np.mean(np.abs(gray - jg) <= GRAY_TOL))
    assert share >= GRAY_SHARE, share
    return share


@pytest.mark.parametrize("lam", [-0.04, 0.0])
def test_render_sequence_matches_numpy(lam):
    cam = tiny_test_config().camera
    poses = np.asarray(jsyn.handheld_trajectory(4, seed=5))
    jg, jd = j2.render_sequence(cam, poses, division_lambda=lam)
    tg, td = t2.render_sequence(cam, t(poses), division_lambda=lam)
    assert tg.shape == (4, cam.height, cam.width) and tg.device.type == "cpu"
    assert tg.dtype == td.dtype == torch.float32
    share = _held(n(tg), n(td), jg, jd)
    assert share == 1.0                     # the CPU: every pixel equal
    # most rays hit a plane, and the texture has contrast
    assert np.mean(n(td) > 0.0) > 0.9 and n(tg).std() > 0.05
    # numpy poses render on the CPU, one frame as the sequence's first
    g0, d0 = t2.render_frame(cam, poses[0], division_lambda=lam)
    np.testing.assert_array_equal(n(g0), n(tg[0]))
    np.testing.assert_array_equal(n(d0), n(td[0]))
