"""Affine inverse-compositional patch alignment
(ops/klt.py::refine_patch_alignment_affine) against the JAX function on the
same numpy images: the JAX test's smoothed-noise pair shifted by (1.3, -0.8)
(tests/test_round5.py:226-260) and a pair sheared and rotated about the
image centre. Points within 1e-3 px, err within 1e-3 (0..255 scale), ok
equal. On the shifted pair both recover the shift within the JAX test's
0.15 px."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, t
from scipy.signal import convolve2d

from putslam_tpu.config import TrackerConfig as JTrackerConfig
from putslam_tpu.ops import klt as jklt
from putslam_tpu_torch.config import TrackerConfig as TTrackerConfig
from putslam_tpu_torch.ops import klt as tklt

H = W = 96


def _bilinear(sm, u, v):
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    du, dv = u - x0, v - y0
    return (sm[y0, x0] * (1 - du) * (1 - dv) + sm[y0, x0 + 1] * du * (1 - dv)
            + sm[y0 + 1, x0] * (1 - du) * dv + sm[y0 + 1, x0 + 1] * du * dv)


def _smoothed():
    rng = np.random.default_rng(6)
    base = rng.uniform(0, 1, (H + 8, W + 8)).astype(np.float32)
    return convolve2d(base, np.ones((3, 3)) / 9.0, mode="same")


def _shifted_pair():
    """tests/test_round5.py:232-249: the target is the reference shifted by
    (1.3, -0.8)."""
    sm = _smoothed()
    ref = sm[4:H + 4, 4:W + 4]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    u = np.clip(xx + 4 - 1.3, 0, W + 6.999)
    v = np.clip(yy + 4 + 0.8, 0, H + 6.999)
    tgt = _bilinear(sm, u, v)
    pts = np.array([[40.0, 40.0], [56.0, 30.0], [30.0, 60.0]], np.float32)
    return ref.astype(np.float32), tgt.astype(np.float32), pts, pts.copy()


def _sheared_pair():
    """The target is the reference under x' = A (x - c) + c + s: a rotation
    by 4° with a shear of 0.05 about the centre c, then a shift s; the
    initial guesses are the points moved by s only."""
    sm = _smoothed()
    ref = sm[4:H + 4, 4:W + 4]
    c = np.array([W / 2, H / 2])
    th = np.deg2rad(4.0)
    A = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) \
        @ np.array([[1.0, 0.05], [0.0, 1.0]])
    s = np.array([0.9, 0.6])
    Ai = np.linalg.inv(A)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    q = np.stack([xx - c[0] - s[0], yy - c[1] - s[1]], axis=-1) @ Ai.T + c
    u = np.clip(q[..., 0] + 4, 0, W + 6.999)
    v = np.clip(q[..., 1] + 4, 0, H + 6.999)
    tgt = _bilinear(sm, u, v)
    pts = np.array([[40.0, 40.0], [56.0, 30.0], [30.0, 60.0], [62.0, 58.0],
                    [48.0, 48.0], [20.0, 24.0], [3.0, 50.0]], np.float32)
    init = (pts + s).astype(np.float32)
    return ref.astype(np.float32), tgt.astype(np.float32), pts, init


@pytest.mark.parametrize("pair", ["shifted", "sheared"])
def test_affine_alignment_matches_jax(pair):
    ref, tgt, pts, init = {"shifted": _shifted_pair,
                           "sheared": _sheared_pair}[pair]()
    kw = dict(win_size=9, max_iter=30, eps=1e-3, error_threshold=30.0)
    valid = np.ones((len(pts),), bool)
    valid[-1] = pair == "shifted"
    jr = jklt.refine_patch_alignment_affine(
        JTrackerConfig(**kw), jnp.asarray(ref), jnp.asarray(tgt),
        jnp.asarray(pts), jnp.asarray(init), jnp.asarray(valid))
    tr = tklt.refine_patch_alignment_affine(
        TTrackerConfig(**kw), t(ref), t(tgt), t(pts), t(init), t(valid))
    np.testing.assert_allclose(n(tr.pts), np.asarray(jr.pts), atol=1e-3)
    np.testing.assert_allclose(n(tr.err), np.asarray(jr.err), atol=1e-3)
    np.testing.assert_array_equal(n(tr.valid), np.asarray(jr.valid))
    assert tr.pts.dtype == torch.float32
    if pair == "shifted":
        flow = n(tr.pts) - pts
        assert np.all(np.abs(flow[:, 0] - 1.3) < 0.15), flow
        assert np.all(np.abs(flow[:, 1] + 0.8) < 0.15), flow
    else:
        # a point handed in invalid stays invalid; the others align with
        # a photometric error under the gate
        assert not n(tr.valid)[-1] and n(tr.valid)[:-1].all()


def test_affine_alignment_diverging_warps_match_jax():
    """A template with a gradient along x only (a ramp) leaves the 6×6
    Hessian singular but for its 1e-4 ridge: warps diverge. Where the JAX
    function's warp turns NaN the port's does too, and samples without an
    out-of-bounds gather (a NaN coordinate's index is sent to 0); the ok
    flags are equal, and the point that converges agrees within 1e-3 px.
    A warp that diverges to a finite value is chaotic (2.2e7 against 2.2e6
    here) and is not compared."""
    rng = np.random.default_rng(1)
    xx = np.mgrid[0:64, 0:64][1].astype(np.float32)
    ref = (xx / 64.0).astype(np.float32)
    tgt = rng.uniform(0, 1, (64, 64)).astype(np.float32)
    pts = np.array([[20.0, 20.0], [32.0, 30.0], [40.0, 44.0]], np.float32)
    kw = dict(win_size=9, max_iter=30, eps=1e-3, error_threshold=30.0)
    valid = np.ones((3,), bool)
    jr = jklt.refine_patch_alignment_affine(
        JTrackerConfig(**kw), jnp.asarray(ref), jnp.asarray(tgt),
        jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(valid))
    tr = tklt.refine_patch_alignment_affine(
        TTrackerConfig(**kw), t(ref), t(tgt), t(pts), t(pts), t(valid))
    jp, tp = np.asarray(jr.pts), n(tr.pts)
    np.testing.assert_array_equal(np.isnan(tp), np.isnan(jp))
    assert np.isnan(jp[0]).all()
    np.testing.assert_array_equal(n(tr.valid), np.asarray(jr.valid))
    assert list(n(tr.valid)) == [False, False, True]
    np.testing.assert_allclose(tp[2], jp[2], atol=1e-3)
    np.testing.assert_allclose(n(tr.err)[2], np.asarray(jr.err)[2],
                               atol=1e-3)


def test_affine_polish_last_bit_sensitivity():
    """Why a card-against-CPU check of the affine polish holds a share of
    the points and not all: on fr1 frames 0 -> 1 of the bench orbit
    (rendered by the port), 512 keypoints tracked by the pyramidal KLT and
    polished with the refine window (11, 20 iterations), scaling both
    images by 1 ± 1e-7 leaves the median point where it was but moves a
    few past 1e-3 px (measured: 1 and 3 of 394 points, 0.0062 px at most),
    because the freeze test ‖dp[4:6]‖ < eps flips on last-bit differences.
    At least 97 % stay within 1e-3 px; the ok flags do not change."""
    import dataclasses

    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.frontend import detector
    from putslam_tpu_torch.io import synthetic

    cfg = tum_fr1_config()
    poses = synthetic.orbit_trajectory(64, radius=0.10, yaw_amp=0.1,
                                       device="cpu")[:2]
    g, d = synthetic.render_sequence(cfg.camera, poses)
    f = detector.detect_and_describe(cfg, g[0], d[0])
    tracks = tklt.track(cfg.tracker, g[0], g[1], f.uv, f.valid)
    tc = dataclasses.replace(cfg.tracker,
                             win_size=cfg.tracker.patch_refine_win)
    base = tklt.refine_patch_alignment_affine(tc, g[0], g[1], f.uv,
                                              tracks.pts, tracks.valid)
    assert int(base.valid.sum()) > 300
    for scale in (1.0 + 1e-7, 1.0 - 1e-7):
        other = tklt.refine_patch_alignment_affine(
            tc, g[0] * scale, g[1] * scale, f.uv, tracks.pts, tracks.valid)
        both = base.valid & other.valid
        shift = (base.pts - other.pts)[both].abs().amax(-1)
        assert torch.equal(base.valid, other.valid)
        assert float(shift.median()) < 1e-5
        assert float((shift <= 1e-3).float().mean()) >= 0.97
