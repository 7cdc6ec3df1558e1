"""The front-end options, each against its JAX counterpart on the same
numpy inputs: RANSAC error models 0–4 with and without information matrices
and with quality-weighted sampling (same uniforms: sample indices and inlier
masks exact, pose ≤ 1e-5); the exact per-cell grid cap (exact, on random,
tie-heavy and mostly-zero score maps); the LDB descriptor (bank ≤ 1e-7
before the bf16 cast, bits exact), steered_brief and pack_bits (exact);
ratio_test, gather_pairs, guided_match(acceptance="ratio") and
guided_match_pairs(max_mates=2, 3) (indices and masks exact, distances
≤ 1e-6, tie-heavy cases included)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import n, port_cfg, t
from test_torch_map_graph import to_port, world  # noqa: F401 (fixture)
from test_torch_vo import _pairs

from putslam_tpu.config import tiny_test_config
from putslam_tpu.frontend import ransac as jransac
from putslam_tpu.geometry import se3 as jse3
from putslam_tpu.ops import brief as jbrief
from putslam_tpu.ops import fast as jfast
from putslam_tpu.ops import matching as jmatch
from putslam_tpu.slam_map import features_map as jfm
from putslam_tpu_torch import convert
from putslam_tpu_torch.frontend import ransac as transac
from putslam_tpu_torch.ops import brief as tbrief
from putslam_tpu_torch.ops import fast as tfast
from putslam_tpu_torch.ops import matching as tmatch
from putslam_tpu_torch.slam_map import features_map as tfm

CFG = tiny_test_config()


# ---------------------------------------------------------------------------
# RANSAC error models and weighted sampling
# ---------------------------------------------------------------------------


def _infos(rng, N):
    """Symmetric positive information matrices of a 3–10 mm anisotropic
    noise, exactly symmetric in float32."""
    Q, _ = np.linalg.qr(rng.normal(size=(N, 3, 3)))
    sig = rng.uniform(0.003, 0.01, (N, 3))
    info = np.einsum("nij,nj,nkj->nik", Q, 1.0 / sig ** 2, Q)
    return (0.5 * (info + np.swapaxes(info, -1, -2))).astype(np.float32)


def _jax_sample_idx(cfg, valid, u, quality):
    """The sampler of putslam_tpu/frontend/ransac.py:121-129 (estimate does
    not return its sample indices)."""
    valid = jnp.asarray(valid)
    if cfg.quality_tau > 0.0 and quality is not None:
        wgt = jnp.where(valid, jnp.exp(-jnp.asarray(quality)
                                       / cfg.quality_tau), 0.0)
    else:
        wgt = valid.astype(jnp.float32)
    csum = jnp.cumsum(wgt)
    total = jnp.maximum(csum[-1], 1e-9)
    return jnp.clip(jnp.searchsorted(csum, u * total, side="left"), 0,
                    valid.shape[0] - 1)


@pytest.mark.parametrize("tau", [0.0, 10.0])
@pytest.mark.parametrize("version,with_info", [(0, False), (1, False),
                                               (2, False), (3, False),
                                               (3, True), (4, False)])
def test_ransac_error_models_match_jax(version, with_info, tau):
    """Same uniforms into both packages: every one of the used_pairs·H
    sample indices equal (0 differ), inlier masks and counts exact, pose
    ≤ 1e-5."""
    rng = np.random.default_rng(10 + version)
    p, q, valid = _pairs(rng)
    info = _infos(rng, len(p)) if with_info else None
    quality = rng.integers(0, 64, len(p)).astype(np.float32)
    cfg = dataclasses.replace(CFG.ransac, error_version=version,
                              quality_tau=tau,
                              inlier_threshold_mahalanobis=(
                                  9.0 if with_info else 4e-4))
    cam = CFG.camera
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, (cfg.used_pairs, cfg.n_hypotheses), maxval=1.0)
    ref = jransac.estimate(cfg, cam, key, jnp.asarray(p), jnp.asarray(q),
                           jnp.asarray(valid), quality=jnp.asarray(quality),
                           info=None if info is None else jnp.asarray(info))
    pc = port_cfg(cfg)
    got = transac.estimate(pc, port_cfg(cam), t(p), t(q), t(valid), u=t(u),
                           quality=t(quality),
                           info=None if info is None else t(info))
    idx_ref = np.asarray(_jax_sample_idx(cfg, valid, u, quality))
    idx_got = n(transac.sample_indices(pc, t(valid), t(u), t(quality)))
    assert int((idx_ref != idx_got).sum()) == 0
    assert bool(ref.ok) and int(ref.n_inliers) > 20
    np.testing.assert_allclose(n(got.pose), np.asarray(ref.pose), atol=1e-5)
    for f in ("inliers", "n_inliers", "ok"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(n(got.inlier_ratio),
                               np.asarray(ref.inlier_ratio), rtol=1e-6)


def test_quality_weights_bias_the_sample():
    """With quality_tau > 0 the low-distance matches are drawn more often
    than uniformly; without a quality the weights stay uniform."""
    rng = np.random.default_rng(4)
    valid = np.ones(64, bool)
    quality = np.where(np.arange(64) < 8, 0.0, 60.0).astype(np.float32)
    cfg = port_cfg(dataclasses.replace(CFG.ransac, quality_tau=10.0))
    u = t(rng.uniform(size=(3, 256)).astype(np.float32))
    idx = n(transac.sample_indices(cfg, t(valid), u, t(quality)))
    assert (idx < 8).mean() > 0.9
    flat = n(transac.sample_indices(cfg, t(valid), u, None))
    assert (flat < 8).mean() < 0.3


def test_ransac_pair_errors_match_jax():
    """_pair_errors of every model on a batch of poses: error ≤ 1e-5
    relative (plus 1e-6), the threshold's values equal."""
    rng = np.random.default_rng(5)
    p, q, _ = _pairs(rng, N=48)
    info = _infos(rng, 48)
    T = np.concatenate([rng.normal(0, 0.05, (8, 3)), np.ones((8, 1)),
                        rng.normal(0, 0.02, (8, 3))], -1).astype(np.float32)
    T = np.asarray(jse3.make_pose(jnp.asarray(T[:, :3]),
                                  jnp.asarray(T[:, 3:])))
    for version in range(5):
        cfg = dataclasses.replace(CFG.ransac, error_version=version)
        for inf in (None, info):
            e_ref, thr_ref = jransac._pair_errors(
                cfg, CFG.camera, jnp.asarray(T), jnp.asarray(p),
                jnp.asarray(q), None if inf is None else jnp.asarray(inf))
            e_got, thr_got = transac._pair_errors(
                port_cfg(cfg), port_cfg(CFG.camera), t(T), t(p), t(q),
                None if inf is None else t(inf))
            np.testing.assert_allclose(n(e_got), np.asarray(e_ref),
                                       rtol=1e-5, atol=1e-6)
            thr_got = n(thr_got) if hasattr(thr_got, "shape") else thr_got
            np.testing.assert_allclose(
                np.broadcast_to(thr_got, e_ref.shape),
                np.broadcast_to(np.asarray(thr_ref), e_ref.shape), rtol=1e-7)
    with pytest.raises(ValueError):
        transac._pair_errors(
            port_cfg(dataclasses.replace(CFG.ransac, error_version=5)),
            None, t(T), t(p), t(q))


# ---------------------------------------------------------------------------
# The exact per-cell grid cap
# ---------------------------------------------------------------------------


def _score_map(kind, rng, H, W):
    s = rng.uniform(size=(H, W)).astype(np.float32)
    if kind == "quantised":         # uint8 levels: many equal responses
        s = np.round(s * 6.0).astype(np.float32) / 255.0
    elif kind == "sparse":          # most cells hold nothing but zeros
        s = np.where(rng.uniform(size=(H, W)) < 0.002, s, 0.0).astype(
            np.float32)
    return s


@pytest.mark.parametrize("kind", ["random", "quantised", "sparse"])
@pytest.mark.parametrize("shape,grid,k", [((96, 128), (3, 4), 64),
                                          ((50, 70), (4, 3), 100),
                                          ((12, 16), (4, 4), 512)])
def test_grid_topk_exact_matches_jax(kind, shape, grid, k):
    """uv, response and valid exactly equal, ties and empty cells
    included ((12, 16) has fewer candidates than slots: the padding)."""
    s = _score_map(kind, np.random.default_rng(6), *shape)
    ref = jfast.grid_topk_exact(jnp.asarray(s), grid[0], grid[1], k)
    got = tfast.grid_topk_exact(t(s), grid[0], grid[1], k)
    for a, b in zip(got, ref):
        assert n(a).shape == np.asarray(b).shape
        np.testing.assert_array_equal(n(a), np.asarray(b))


# ---------------------------------------------------------------------------
# LDB, steered_brief, pack_bits
# ---------------------------------------------------------------------------


def _patches(rng, N=96):
    return (rng.integers(0, 256, (N, tbrief.PATCH, tbrief.PATCH))
            / 255.0).astype(np.float32)


def test_ldb_bank_matches_jax():
    """The fused and the unblurred LDB constants before the bf16 cast:
    ≤ 1e-7; the device copy is cached per kind."""
    jbrief._get_fused_bank("ldb")
    np.testing.assert_allclose(tbrief.make_fused_bank("ldb"),
                               jbrief._FUSED_BANKS["ldb"], atol=1e-7, rtol=0)
    jbrief._get_ldb_bank()
    np.testing.assert_allclose(tbrief.make_test_bank("ldb"),
                               jbrief._LDB_BANK, atol=1e-7, rtol=0)
    assert tbrief.make_fused_bank("ldb") is tbrief.make_fused_bank("ldb")
    a = convert.brief_bank("cpu", "ldb")
    assert a is convert.brief_bank("cpu", "ldb")
    assert a is not convert.brief_bank("cpu", "brief")
    assert a.shape == (tbrief.PATCH ** 2,
                       tbrief.N_BINS * tbrief.DESC_BITS + 2)
    with pytest.raises(NotImplementedError):
        tbrief.make_test_bank("orb")


@pytest.mark.parametrize("kind", ["brief", "ldb"])
def test_describe_and_steered_brief_match_jax(kind):
    """describe_patches and describe: bits exact, angles ≤ 1e-6;
    steered_brief for angles handed in (bin boundaries included): exact."""
    rng = np.random.default_rng(7)
    pt = _patches(rng)
    d_ref, a_ref = jbrief.describe_patches(jnp.asarray(pt), kind)
    d_got, a_got = tbrief.describe_patches(t(pt), kind)
    np.testing.assert_array_equal(n(d_got), np.asarray(d_ref))
    np.testing.assert_allclose(n(a_got), np.asarray(a_ref), atol=1e-6)
    ang = rng.uniform(-4 * np.pi, 4 * np.pi, len(pt)).astype(np.float32)
    ang[:8] = (np.arange(8) * 2 * np.pi / tbrief.N_BINS).astype(np.float32)
    s_ref = jbrief.steered_brief(jnp.asarray(pt), jnp.asarray(ang), kind)
    s_got = tbrief.steered_brief(t(pt), t(ang), kind)
    assert n(s_got).dtype == np.int8
    np.testing.assert_array_equal(n(s_got), np.asarray(s_ref))

    img = rng.uniform(size=(96, 128)).astype(np.float32)
    uv = rng.uniform([0, 0], [127, 95], (40, 2)).astype(np.float32)
    valid = rng.uniform(size=40) > 0.2
    r_desc, r_ang = jbrief.describe(jnp.asarray(img), jnp.asarray(uv),
                                    jnp.asarray(valid), kind=kind)
    g_desc, g_ang = tbrief.describe(t(img), t(uv), t(valid), kind=kind)
    np.testing.assert_array_equal(n(g_desc), np.asarray(r_desc))
    np.testing.assert_allclose(n(g_ang), np.asarray(r_ang), atol=1e-6)
    assert np.all(n(g_desc)[~valid] == 0)


def test_ldb_differs_from_brief():
    pt = t(_patches(np.random.default_rng(8), 16))
    a, _ = tbrief.describe_patches(pt, "brief")
    b, _ = tbrief.describe_patches(pt, "ldb")
    assert float((a != b).float().mean()) > 0.2


def test_pack_bits_matches_jax():
    rng = np.random.default_rng(9)
    d = rng.choice(np.array([-1, 1], np.int8), (33, 256))
    d[0] = 1
    d[1] = -1
    ref = np.asarray(jbrief.pack_bits(jnp.asarray(d)))
    got = n(tbrief.pack_bits(t(d)))
    assert got.shape == (33, 8) and got.min() >= 0
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    assert int(got[0, 0]) == 2 ** 32 - 1 and int(got[1].sum()) == 0


# ---------------------------------------------------------------------------
# ratio_test, gather_pairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [256, 4])
def test_ratio_test_and_gather_pairs_match_jax(levels):
    """levels=4: integer distances out of four values, so nearly every row
    has tied nearest neighbours (lowest index wins, as lax.top_k)."""
    rng = np.random.default_rng(11)
    dist = rng.integers(0, levels, (64, 48)).astype(np.float32)
    dist[3] = 7.0
    ref = jmatch.ratio_test(jnp.asarray(dist), 0.8, 200.0)
    got = tmatch.ratio_test(t(dist), 0.8, 200.0)
    for f in ("idx_b", "dist", "valid"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
    assert 0 < int(np.asarray(ref.valid).sum()) < 64 or levels == 4
    xa = rng.normal(size=(64, 3)).astype(np.float32)
    xb = rng.normal(size=(48, 3)).astype(np.float32)
    for a, b in zip(tmatch.gather_pairs(t(xa), t(xb), got),
                    jmatch.gather_pairs(jnp.asarray(xa), jnp.asarray(xb),
                                        ref)):
        np.testing.assert_array_equal(n(a), np.asarray(b))


# ---------------------------------------------------------------------------
# guided matching: ratio acceptance, multi-mate pairs, Hamming slack
# ---------------------------------------------------------------------------


def _with_twins(feat):
    """Every odd feature becomes a copy of its even neighbour (descriptor,
    octave, position 1 mm away): each landmark that sees one sees both at
    the same Hamming distance."""
    f = jax.tree.map(np.array, feat)
    for name in ("desc", "octave", "valid", "has_depth"):
        getattr(f, name)[1::2] = getattr(f, name)[0::2]
    f.xyz[1::2] = f.xyz[0::2] + np.float32(1e-3)
    return jax.tree.map(jnp.asarray, f)


def _matcher(**over):
    return CFG.replace(matcher=dataclasses.replace(CFG.matcher, **over))


@pytest.mark.parametrize("twins", [False, True])
@pytest.mark.parametrize("slack", [0.0, 24.0])
def test_guided_match_ratio_matches_jax(world, twins, slack):
    st, feat, poses = world
    if twins:
        feat = _with_twins(feat)
    cfg = _matcher(acceptance="ratio", matching_xyz_acceptance_ratio=0.9)
    ref = jfm.guided_match(cfg, st.map, jnp.asarray(poses[2]), feat,
                           radius_scale=1.5, hamming_slack=slack)
    got = tfm.guided_match(port_cfg(cfg), to_port(st.map), t(poses[2]),
                           to_port(feat), radius_scale=1.5,
                           hamming_slack=slack)
    plain = jfm.guided_match(CFG, st.map,
                             jnp.asarray(poses[2]), feat, radius_scale=1.5,
                             hamming_slack=slack)
    # the ratio gate rejects some of what the Hamming gate takes (with
    # twins nearly everything: the second best ties the best)
    if twins:
        assert int(ref.valid.sum()) <= int(plain.valid.sum())
    else:
        assert 10 < int(ref.valid.sum()) < int(plain.valid.sum())
    for f in ("feat_idx", "valid", "n_candidates"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(n(got.dist), np.asarray(ref.dist), atol=1e-6)


def test_hamming_slack_widens_the_gate(world):
    st, feat, poses = world
    cfg = _matcher(max_hamming=8.0)
    counts = []
    for slack in (0.0, 16.0, 48.0):
        ref = jfm.guided_match(cfg, st.map, jnp.asarray(poses[2]), feat,
                               hamming_slack=slack)
        got = tfm.guided_match(port_cfg(cfg), to_port(st.map), t(poses[2]),
                               to_port(feat), hamming_slack=slack)
        np.testing.assert_array_equal(n(got.valid), np.asarray(ref.valid))
        np.testing.assert_array_equal(n(got.feat_idx),
                                      np.asarray(ref.feat_idx))
        counts.append(int(ref.valid.sum()))
    assert counts[0] < counts[1] < counts[2]


@pytest.mark.parametrize("twins", [False, True])
@pytest.mark.parametrize("mates", [2, 3])
def test_guided_match_pairs_matches_jax(world, mates, twins):
    """The flat pair list: landmark and feature indices, masks and the
    candidate count exact, distances ≤ 1e-6. With twins every band holds
    tied candidates and the compaction sorts tied pairs."""
    st, feat, poses = world
    if twins:
        feat = _with_twins(feat)
    cfg = _matcher(max_mates=mates, max_hamming=110.0,
                   matching_xyz_acceptance_ratio=0.5)
    ref = jfm.guided_match_pairs(cfg, st.map, jnp.asarray(poses[2]), feat,
                                 radius_scale=4.0, hamming_slack=8.0)
    got = tfm.guided_match_pairs(port_cfg(cfg), to_port(st.map), t(poses[2]),
                                 to_port(feat), radius_scale=4.0,
                                 hamming_slack=8.0)
    n_on = int(ref.valid.sum())
    lms = np.asarray(ref.lm_idx)[np.asarray(ref.valid)]
    assert n_on > 20 and len(np.unique(lms)) < n_on     # real multi-mates
    assert got.valid.shape == (2 * feat.capacity,)
    for f in ("lm_idx", "feat_idx", "valid", "n_candidates"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(n(got.dist), np.asarray(ref.dist), atol=1e-6)
    assert n(got.lm_idx).dtype == np.int32


def test_unknown_acceptance_raises(world):
    st, feat, poses = world
    cfg = port_cfg(_matcher(acceptance="band"))
    with pytest.raises(NotImplementedError):
        tfm.guided_match(cfg, to_port(st.map), t(poses[2]), to_port(feat))
