"""putslam_tpu_torch — the PyTorch / CUDA port of putslam_tpu.

The JAX package ``putslam_tpu`` is the reference; this package mirrors its
module paths (``ops/fast.py`` here is the counterpart of
``putslam_tpu/ops/fast.py``, and so on) and runs the same SLAM main path in
PyTorch on an NVIDIA H100. The JAX package's one Pallas kernel (FAST-9 score
+ NMS) is the hand-written CUDA kernel ``csrc/fast_score_nms.cu``.

It imports ``torch``, ``numpy`` and the pure-dataclass ``putslam_tpu.config``
and never ``jax``. Plain functions on tensors; state is ``NamedTuple``s with
the JAX package's field names; every entry point takes an explicit
``device``; RANSAC draws from an explicit ``torch.Generator``.

Subpackages: geometry, ops, frontend, slam_map, backend, loopclosure,
motion, models, io, eval, utils — as in ``putslam_tpu``. ``run`` is the
command-line runner.
"""

import torch

# Full float32 everywhere: the BA generation gates and the pose reads need
# exact f32 products, which TF32 would round to ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
