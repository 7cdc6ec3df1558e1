"""FAST-9 score + NMS: the port's plain version against the JAX XLA chain
and against the Pallas kernel run in interpret mode (as
tests/test_round5.py runs it). All comparisons are exact (array_equal).
The CUDA kernel's own test is tests/test_torch_fast_cuda.py."""

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
    before = fast_cuda.fast_score_nms.launches
    raw_w, nms_w = fast_cuda.fast_score_nms(t(g), 20.0, 3)
    assert fast_cuda.fast_score_nms.launches == before
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


def test_detect_rejects_unported_grid_policy():
    with pytest.raises(NotImplementedError):
        tfast.detect(t(_image((96, 128), False)), 20.0, 3, 3, 4, 96,
                     grid_policy="exact")
