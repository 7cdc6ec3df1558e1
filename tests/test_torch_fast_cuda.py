"""The hand-written CUDA FAST-9 + NMS kernel against its plain PyTorch
version, bit for bit: the four fr1 pyramid levels in one launch, ragged
shapes, other radii through the generic instantiation, and the first port's
32x32-tile kernel that is kept as the timing yardstick. Needs a CUDA card
and skips without one. Imports no JAX, so on the machine with the card it
runs as: python -m pytest tests/test_torch_fast_cuda.py --noconftest -q"""

import numpy as np
import pytest
import torch

from putslam_tpu_torch.ops import fast as tfast
from putslam_tpu_torch.ops import fast_cuda

pytestmark = pytest.mark.cuda

FR1_SHAPES = [(480, 640), (339, 453), (240, 320), (170, 226)]


def _image(shape, quantized, seed=7):
    g = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    if quantized:   # integer intensities → integer scores → many ties
        g = (np.round(g * 255) / 255).astype(np.float32)
    return torch.from_numpy(g)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _plain(g, radius=3):
    raw = tfast.fast_score_map(g, 20.0)
    return raw, tfast.nms(raw, radius)


@pytest.mark.parametrize("shape", FR1_SHAPES)
def test_cuda_kernel_matches_plain(cuda, shape):
    for quantized in (False, True):
        g = _image(shape, quantized).to(cuda)
        fast_cuda._LIB.reset_launch_count()
        raw_k, nms_k = fast_cuda.fast_score_nms(g, 20.0, 3)
        assert fast_cuda._LIB.launch_count() == 1
        raw_p, nms_p = _plain(g)
        torch.cuda.synchronize()
        assert torch.equal(raw_k, raw_p)
        assert torch.equal(nms_k, nms_p)


@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_fr1_levels_in_one_launch(cuda, quantized):
    levels = [_image(s, quantized, seed=20 + i).to(cuda)
              for i, s in enumerate(FR1_SHAPES)]
    fast_cuda._LIB.reset_launch_count()
    out = fast_cuda.fast_score_nms_levels(levels, 20.0, 3)
    assert fast_cuda._LIB.launch_count() == 1
    assert len(out) == 4
    base = {raw.untyped_storage().data_ptr() for raw, _ in out} \
        | {nms.untyped_storage().data_ptr() for _, nms in out}
    assert len(base) == 1                     # views of one buffer
    for g, (raw_k, nms_k) in zip(levels, out):
        raw_p, nms_p = _plain(g)
        assert raw_k.shape == g.shape and raw_k.is_contiguous()
        assert torch.equal(raw_k, raw_p)
        assert torch.equal(nms_k, nms_p)
        assert int((nms_k > 0).sum()) > 50


@pytest.mark.parametrize("radius", [0, 3, 5, 16])
def test_cuda_ragged_shapes_and_radii(cuda, radius):
    levels = [_image(s, True, seed=30 + i).to(cuda)
              for i, s in enumerate([(33, 35), (65, 97), (7, 7), (6, 300)])]
    out = fast_cuda.fast_score_nms_levels(levels, 20.0, radius)
    torch.cuda.synchronize()
    for g, (raw_k, nms_k) in zip(levels, out):
        raw_p, nms_p = _plain(g, radius)
        assert torch.equal(raw_k, raw_p), tuple(g.shape)
        assert torch.equal(nms_k, nms_p), tuple(g.shape)


def test_cuda_unaligned_level_takes_the_narrow_path(cuda):
    """A level whose storage starts 4 bytes off a 16-byte boundary is still
    right (the wrapper picks the access width from the pointers)."""
    flat = _image((1, 480 * 640 + 1), False).to(cuda).reshape(-1)
    g = flat[1:].view(480, 640)
    assert g.is_contiguous() and g.data_ptr() % 16 == 4
    raw_k, nms_k = fast_cuda.fast_score_nms(g, 20.0, 3)
    raw_p, nms_p = _plain(g)
    torch.cuda.synchronize()
    assert torch.equal(raw_k, raw_p) and torch.equal(nms_k, nms_p)


def test_cuda_kernel_replays_from_a_graph(cuda):
    """Captured into a CUDA graph, the launch is recorded once and runs at
    every replay on the frame the static buffer holds; each replay counts
    as the launch it is, on the card."""
    shapes = FR1_SHAPES
    src = [_image(sh, True).to(cuda) for sh in shapes]
    levels = [torch.zeros_like(x) for x in src]
    fast_cuda.fast_score_nms_levels(levels, 20.0, 3)        # warm up
    graph = torch.cuda.CUDAGraph()
    fast_cuda._LIB.reset_launch_count()
    with torch.cuda.graph(graph):
        maps = fast_cuda.fast_score_nms_levels(levels, 20.0, 3)
    assert fast_cuda._LIB.launch_count() == 0    # recorded, not run
    for k in range(3):
        for dst, x in zip(levels, src):
            dst.copy_(torch.roll(x, k, dims=1))
        graph.replay()
        torch.cuda.synchronize()
        for (raw_k, nms_k), g in zip(maps, levels):
            raw_p, nms_p = _plain(g)
            assert torch.equal(raw_k, raw_p) and torch.equal(nms_k, nms_p)
    assert fast_cuda._LIB.launch_count() == 3


def test_cuda_wrapper_checks_inputs(cuda):
    g = torch.rand((64, 64), device=cuda)
    with pytest.raises(ValueError):
        fast_cuda.fast_score_nms(g.double(), 20.0, 3)
    with pytest.raises(ValueError):
        fast_cuda.fast_score_nms(g.t(), 20.0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fast_cuda.fast_score_nms_levels([g, g[:, ::2]], 20.0, 3)
    with pytest.raises(ValueError, match="devices"):
        fast_cuda.fast_score_nms_levels([g, g.cpu()], 20.0, 3)
    with pytest.raises(ValueError, match="levels"):
        fast_cuda.fast_score_nms_levels([g] * 9, 20.0, 3)
    with pytest.raises(ValueError, match="levels"):
        fast_cuda.fast_score_nms_levels([], 20.0, 3)
    for bad in (-1, 17):
        with pytest.raises(ValueError, match="nms_radius"):
            fast_cuda.fast_score_nms_levels([g], 20.0, bad)
    fast_cuda._LIB.reset_launch_count()
    assert len(fast_cuda.fast_score_nms_levels([g] * 8, 20.0, 3)) == 8
    assert fast_cuda._LIB.launch_count() == 1
