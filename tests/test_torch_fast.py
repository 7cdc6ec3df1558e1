"""FAST-9 score + NMS: the port's plain version against the JAX XLA chain
and against the Pallas kernel run in interpret mode (as
tests/test_round5.py runs it), level by level and through the multi-level
entry fast_score_nms_levels; and the plain-Python layout of the CUDA
kernel's one flat grid of tiles and one output buffer. All comparisons are
exact (array_equal). The CUDA kernel's own test is
tests/test_torch_fast_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, t

from putslam_tpu.ops import fast as jfast
from putslam_tpu.ops import fast_pallas
from putslam_tpu_torch.ops import fast as tfast
from putslam_tpu_torch.ops import fast_cuda

SHAPES = [(96, 128), (68, 91)]     # the tiny config's two pyramid levels
RAGGED = [(33, 35), (65, 97)]      # no multiple of any tile or vector width
FR1_SHAPES = ((480, 640), (339, 453), (240, 320), (170, 226))


def _image(shape, quantized, seed=0):
    g = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    if quantized:   # integer intensities → integer scores → many ties
        g = (np.round(g * 255) / 255).astype(np.float32)
    return g


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_score_and_nms_match_xla_and_pallas(shape, quantized):
    g = _image(shape, quantized)
    raw_j = np.asarray(jfast.fast_score_map(jnp.asarray(g), 20.0))
    nms_j = np.asarray(jfast.nms(jnp.asarray(raw_j), 3))
    nms_pallas = np.asarray(fast_pallas.fast_score_nms(jnp.asarray(g), 20.0, 3))
    raw_t = tfast.fast_score_map(t(g), 20.0)
    nms_t = tfast.nms(raw_t, 3)
    assert (nms_j > 0).sum() > 50
    np.testing.assert_array_equal(n(raw_t), raw_j)
    np.testing.assert_array_equal(n(nms_t), nms_j)
    np.testing.assert_array_equal(n(nms_t), nms_pallas)
    # the wrapper takes the plain version for a CPU tensor, no launch
    raw_w, nms_w = fast_cuda.fast_score_nms(t(g), 20.0, 3)
    assert not fast_cuda._LIB.loaded
    assert torch.equal(raw_w, raw_t) and torch.equal(nms_w, nms_t)


@pytest.mark.parametrize("quantized", [False, True])
def test_grid_topk_refine_and_detect_match_jax(quantized):
    g = _image((96, 128), quantized, seed=4)
    s = np.asarray(jfast.nms(jfast.fast_score_map(jnp.asarray(g), 20.0), 3))
    for got, ref in zip(tfast.grid_topk(t(s), 3, 4, 96),
                        jfast.grid_topk(jnp.asarray(s), 3, 4, 96)):
        np.testing.assert_array_equal(n(got), np.asarray(ref))
    uv = np.asarray(jfast.grid_topk(jnp.asarray(s), 3, 4, 96)[0])
    np.testing.assert_array_equal(
        n(tfast.subpixel_refine(t(s), t(uv))),
        np.asarray(jfast.subpixel_refine(jnp.asarray(s), jnp.asarray(uv))))
    for got, ref in zip(tfast.detect(t(g), 20.0, 3, 3, 4, 96),
                        jfast.detect(jnp.asarray(g), 20.0, 3, 3, 4, 96)):
        np.testing.assert_array_equal(n(got), np.asarray(ref))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shapes", [SHAPES, RAGGED], ids=["tiny", "ragged"])
def test_levels_entry_matches_plain_xla_and_pallas(shapes, quantized):
    """fast_score_nms_levels on the CPU: per level the plain version, the
    JAX package's XLA chain and its Pallas kernel in interpret mode, all
    exactly; the kernel's library is not loaded for CPU tensors."""
    imgs = [_image(s, quantized, seed=10 + i) for i, s in enumerate(shapes)]
    out = fast_cuda.fast_score_nms_levels([t(g) for g in imgs], 20.0, 3)
    assert not fast_cuda._LIB.loaded
    assert len(out) == len(shapes)
    for g, (raw_l, nms_l) in zip(imgs, out):
        raw_t = tfast.fast_score_map(t(g), 20.0)
        assert torch.equal(raw_l, raw_t)
        assert torch.equal(nms_l, tfast.nms(raw_t, 3))
        raw_j = np.asarray(jfast.fast_score_map(jnp.asarray(g), 20.0))
        np.testing.assert_array_equal(n(raw_l), raw_j)
        np.testing.assert_array_equal(
            n(nms_l), np.asarray(jfast.nms(jnp.asarray(raw_j), 3)))
        np.testing.assert_array_equal(
            n(nms_l),
            np.asarray(fast_pallas.fast_score_nms(jnp.asarray(g), 20.0, 3)))
        assert (n(nms_l) > 0).sum() > 5


@pytest.mark.parametrize("radius", [0, 5])
def test_levels_entry_other_radii(radius):
    g = _image((65, 97), True, seed=3)
    (raw_l, nms_l), = fast_cuda.fast_score_nms_levels([t(g)], 20.0, radius)
    raw_j = jfast.fast_score_map(jnp.asarray(g), 20.0)
    np.testing.assert_array_equal(n(raw_l), np.asarray(raw_j))
    np.testing.assert_array_equal(n(nms_l),
                                  np.asarray(jfast.nms(raw_j, radius)))
    one = fast_cuda.fast_score_nms(t(g), 20.0, radius)
    assert torch.equal(one[0], raw_l) and torch.equal(one[1], nms_l)


def test_detect_takes_maps_handed_in():
    """detect with the (raw, nms) pair of the multi-level call equals detect
    that computes its own."""
    g = t(_image((96, 128), True, seed=4))
    maps = fast_cuda.fast_score_nms_levels([g], 20.0, 3)[0]
    for a, b in zip(tfast.detect(g, 20.0, 3, 3, 4, 96, maps=maps),
                    tfast.detect(g, 20.0, 3, 3, 4, 96)):
        assert torch.equal(a, b)


def _random_shapes(rng):
    return tuple((int(rng.integers(1, 200)), int(rng.integers(1, 300)))
                 for _ in range(int(rng.integers(1, fast_cuda.MAX_LEVELS + 1))))


@pytest.mark.parametrize("tile", [(32, 24), (64, 32), (128, 16)])
@pytest.mark.parametrize("seed", range(4))
def test_tile_layout_covers_every_pixel_once(seed, tile):
    """Walking the flat grid block by block, as the kernel does, paints
    every pixel of every level exactly once (fr1 and random shapes)."""
    rng = np.random.default_rng(seed)
    tw, th = tile
    for shapes in [FR1_SHAPES] + [_random_shapes(rng) for _ in range(6)]:
        tiles_x, first_tile, total = fast_cuda.tile_layout(shapes, tw, th)
        assert first_tile[0] == 0 and len(tiles_x) == len(shapes)
        assert total == sum(-(-H // th) * -(-W // tw) for H, W in shapes)
        hits = [np.zeros(s, np.int32) for s in shapes]
        for block in range(total):
            lvl, y0, x0 = fast_cuda.tile_origin(shapes, block, tw, th)
            H, W = shapes[lvl]
            assert 0 <= y0 < H and 0 <= x0 < W    # no tile wholly outside
            hits[lvl][y0:y0 + th, x0:x0 + tw] += 1
        assert all((h == 1).all() for h in hits)
        with pytest.raises(IndexError):
            fast_cuda.tile_origin(shapes, total, tw, th)


def test_fr1_layout_numbers():
    """The fr1 frame: 789 tiles of 32x24 in one grid (302 of 64x32);
    575,987 pixels."""
    assert (fast_cuda.TILE_W, fast_cuda.TILE_H) == (32, 24)
    tiles_x, first_tile, total = fast_cuda.tile_layout(FR1_SHAPES)
    assert tiles_x == (20, 15, 10, 8)
    assert first_tile == (0, 400, 625, 725) and total == 789
    assert fast_cuda.tile_layout(FR1_SHAPES, 64, 32)[2] == 302
    assert sum(H * W for H, W in FR1_SHAPES) == 575_987


@pytest.mark.parametrize("seed", range(3))
def test_output_layout_is_aligned_and_disjoint(seed):
    rng = np.random.default_rng(100 + seed)
    for shapes in [FR1_SHAPES] + [_random_shapes(rng) for _ in range(8)]:
        raw, nms, size = fast_cuda.output_layout(shapes)
        spans = sorted((o, o + H * W) for offs in (raw, nms)
                       for o, (H, W) in zip(offs, shapes))
        assert all(o % fast_cuda.OUT_ALIGN == 0 for o, _ in spans)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[0][0] == 0 and spans[-1][1] <= size
        assert size < 2 * sum(H * W for H, W in shapes) \
            + 2 * len(shapes) * fast_cuda.OUT_ALIGN


def test_access_width_follows_pitch_and_alignment():
    aw = fast_cuda._access_width
    assert aw(640, 1024, 2048, 4096) == 4
    assert aw(226, 1024, 2048, 4096) == 2
    assert aw(453, 1024, 2048, 4096) == 1
    assert aw(640, 1024 + 8, 2048, 4096) == 2      # one pointer 8-aligned
    assert aw(640, 1024 + 4, 2048, 4096) == 1


def test_detect_rejects_unported_grid_policy():
    """Both policies of the JAX package run; a policy by another name is
    what is left to reject."""
    img = t(_image((96, 128), False))
    for policy in ("quadtree", ""):
        with pytest.raises(NotImplementedError):
            tfast.detect(img, 20.0, 3, 3, 4, 96, grid_policy=policy)
    for policy in tfast.GRID_POLICIES:
        uv, resp, valid = tfast.detect(img, 20.0, 3, 3, 4, 96,
                                       grid_policy=policy)
        assert uv.shape == (96, 2) and int(valid.sum()) > 0


@pytest.mark.parametrize("quantised", [False, True])
def test_detect_exact_policy_matches_jax(quantised):
    """detect(grid_policy="exact") on a random and on a uint8-quantised
    (tie-heavy) image: keypoints, responses and masks exactly equal."""
    img = _image((96, 128), quantised)
    ref = jfast.detect(jnp.asarray(img), 20.0, 3, 3, 4, 96,
                       grid_policy="exact")
    got = tfast.detect(t(img), 20.0, 3, 3, 4, 96,
                       grid_policy="exact")
    assert int(np.asarray(ref[2]).sum()) > 10
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))
