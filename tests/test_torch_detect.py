"""Detection + description parity: the BRIEF bank, descriptor bits, and
detect_and_describe on frames rendered by the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import n, port_cfg, t

from putslam_tpu.config import tiny_test_config
from putslam_tpu.frontend import detector as jdet
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.ops import brief as jbrief
from putslam_tpu_torch.convert import brief_bank
from putslam_tpu_torch.frontend import detector as tdet
from putslam_tpu_torch.ops import brief as tbrief


def test_bank_is_byte_equal():
    ref = np.asarray(jbrief._get_fused_bank("brief")).view(np.uint16)
    got = n(brief_bank("cpu").view(__import__("torch").int16)).view(np.uint16)
    np.testing.assert_array_equal(got, ref)


def test_describe_patches_bits_exact():
    """bf16 operands and bf16 output rounding: exact bits on the CPU."""
    p = np.random.default_rng(5).uniform(0, 1, (512, 32, 32)).astype(np.float32)
    d_j, a_j = jbrief.describe_patches(jnp.asarray(p))
    d_t, a_t = tbrief.describe_patches(t(p))
    np.testing.assert_array_equal(n(d_t), np.asarray(d_j))
    np.testing.assert_allclose(n(a_t), np.asarray(a_j), atol=1e-6, rtol=0)


def test_extract_patches_exact():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (96, 128)).astype(np.float32)
    uv = np.stack([rng.uniform(-5, 133, 64), rng.uniform(-5, 101, 64)],
                  -1).astype(np.float32)
    np.testing.assert_array_equal(
        n(tbrief.extract_patches(t(img), t(uv))),
        np.asarray(jbrief.extract_patches(jnp.asarray(img), jnp.asarray(uv))))


@pytest.fixture(scope="module")
def frames():
    cfg = tiny_test_config()
    poses = jsyn.orbit_trajectory(3, radius=0.10, yaw_amp=0.1)
    g, d = jsyn.render_sequence(cfg.camera, poses)
    return cfg, np.asarray(g), np.asarray(d)


def test_pyramid_level_matches_jax_resize(frames):
    """Resize weights as jax.image.resize computes them: ≤ 1e-6 abs."""
    import jax

    cfg, g, _ = frames
    for shape in tdet._pyramid_shapes(port_cfg(cfg))[1:]:
        ref = np.asarray(jax.image.resize(jnp.asarray(g[0]), shape, "linear"))
        np.testing.assert_allclose(n(tdet.resize(t(g[0]), shape)), ref,
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_detect_and_describe_matches_jax(frames, i):
    """Level-0 keypoints exact; all levels ≥ 99 % identical (the pyramid
    differs from JAX's by float32 rounding, which can move a sub-pixel
    refine); descriptor bits exact on keypoints both packages found."""
    cfg, g, d = frames
    fj = jdet.detect_and_describe(cfg, jnp.asarray(g[i]), jnp.asarray(d[i]))
    ft = tdet.detect_and_describe(port_cfg(cfg), t(g[i]), t(d[i]))
    vj, vt = np.asarray(fj.valid), n(ft.valid)
    lvl0 = np.asarray(fj.octave) == 0
    np.testing.assert_array_equal(vt[lvl0], vj[lvl0])
    np.testing.assert_array_equal(n(ft.uv)[lvl0], np.asarray(fj.uv)[lvl0])
    same = vj & vt & (np.abs(n(ft.uv) - np.asarray(fj.uv)).max(-1) < 1e-3)
    assert vj.sum() > 50
    assert same.sum() >= 0.99 * max(vj.sum(), vt.sum()), (same.sum(), vj.sum())
    np.testing.assert_array_equal(n(ft.desc)[same], np.asarray(fj.desc)[same])
    np.testing.assert_array_equal(n(ft.has_depth)[same],
                                  np.asarray(fj.has_depth)[same])
    np.testing.assert_allclose(n(ft.xyz)[same], np.asarray(fj.xyz)[same],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("policy,kind", [("exact", "brief"),
                                         ("subtile", "ldb"),
                                         ("exact", "ldb")])
def test_detect_and_describe_options_match_jax(frames, policy, kind):
    """The exact grid cap and the LDB descriptor through the detector, held
    as the default path is: level-0 keypoints exact, ≥ 99 % of all levels
    identical, descriptor bits exact where both found the keypoint."""
    import dataclasses

    cfg, g, d = frames
    cfg = cfg.replace(detector=dataclasses.replace(
        cfg.detector, grid_policy=policy, descriptor=kind))
    fj = jdet.detect_and_describe(cfg, jnp.asarray(g[1]), jnp.asarray(d[1]))
    ft = tdet.detect_and_describe(port_cfg(cfg), t(g[1]), t(d[1]))
    vj, vt = np.asarray(fj.valid), n(ft.valid)
    lvl0 = np.asarray(fj.octave) == 0
    np.testing.assert_array_equal(vt[lvl0], vj[lvl0])
    np.testing.assert_array_equal(n(ft.uv)[lvl0], np.asarray(fj.uv)[lvl0])
    same = vj & vt & (np.abs(n(ft.uv) - np.asarray(fj.uv)).max(-1) < 1e-3)
    assert vj.sum() > 50
    assert same.sum() >= 0.99 * max(vj.sum(), vt.sum()), (same.sum(), vj.sum())
    np.testing.assert_array_equal(n(ft.desc)[same], np.asarray(fj.desc)[same])
    base = tdet.detect_and_describe(port_cfg(frames[0]), t(g[1]), t(d[1]))
    assert not np.array_equal(n(base.desc), n(ft.desc)) or \
        not np.array_equal(n(base.uv), n(ft.uv))


def test_detect_and_describe_rejects_unknown_names(frames):
    import dataclasses

    cfg, g, d = frames
    for over in (dict(descriptor="orb"), dict(grid_policy="anms")):
        bad = port_cfg(cfg.replace(detector=dataclasses.replace(
            cfg.detector, **over)))
        with pytest.raises(NotImplementedError):
            tdet.detect_and_describe(bad, t(g[0]), t(d[0]))


def test_detect_and_describe_makes_one_call_for_all_levels(frames, monkeypatch):
    """The pyramid is built first and FAST + NMS of every level is one call
    of fast_score_nms_levels (one kernel launch on the card); the per-level
    detect gets its maps handed in and calls nothing itself."""
    from putslam_tpu_torch.ops import fast_cuda

    cfg, g, d = frames
    cfg = port_cfg(cfg)
    calls = []
    real = fast_cuda.fast_score_nms_levels

    def spy(levels, threshold, nms_radius):
        calls.append([tuple(x.shape) for x in levels])
        return real(levels, threshold, nms_radius)

    def never(*a, **k):
        raise AssertionError("a level made a call of its own")

    monkeypatch.setattr(fast_cuda, "fast_score_nms_levels", spy)
    monkeypatch.setattr(fast_cuda, "fast_score_nms", never)
    ft = tdet.detect_and_describe(cfg, t(g[0]), t(d[0]))
    assert calls == [tdet._pyramid_shapes(cfg)]
    assert int(ft.valid.sum()) > 50
