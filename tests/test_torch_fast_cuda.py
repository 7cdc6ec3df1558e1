"""The hand-written CUDA FAST-9 + NMS kernel against its plain PyTorch
version, bit for bit, at the fr1 pyramid shapes. Needs a CUDA card and
skips without one. Imports no JAX, so on the machine with the card it runs
as: python -m pytest tests/test_torch_fast_cuda.py --noconftest -q"""

import numpy as np
import pytest
import torch

from putslam_tpu_torch.ops import fast as tfast
from putslam_tpu_torch.ops import fast_cuda

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


@pytest.mark.parametrize("shape", FR1_SHAPES)
def test_cuda_kernel_matches_plain(cuda, shape):
    for quantized in (False, True):
        g = _image(shape, quantized).to(cuda)
        before = fast_cuda.fast_score_nms.launches
        raw_k, nms_k = fast_cuda.fast_score_nms(g, 20.0, 3)
        assert fast_cuda.fast_score_nms.launches == before + 1
        raw_p = tfast.fast_score_map(g, 20.0)
        torch.cuda.synchronize()
        assert torch.equal(raw_k, raw_p)
        assert torch.equal(nms_k, tfast.nms(raw_p, 3))


def test_cuda_wrapper_checks_inputs(cuda):
    g = torch.rand((64, 64), device=cuda)
    with pytest.raises(ValueError):
        fast_cuda.fast_score_nms(g.double(), 20.0, 3)
    with pytest.raises(ValueError):
        fast_cuda.fast_score_nms(g.t(), 20.0, 3)
