"""RANSAC's hypotheses and their scores in one launch: the sampled fit of
every hypothesis and the (H, N) scoring pass that the JAX package leaves
to XLA's fusion (``putslam_tpu/frontend/ransac.py:128-149``).

* ``hypotheses(p, q, valid, idx, model, info)``: the samples gathered by
  the sampler's indices ``idx`` (k, H), the fit of each hypothesis
  (``kabsch.plain_kabsch_soa``'s operations), and its score against the N
  matches. Returns ``(T (H, 7), inl (H, N) bool, counts (H,) int64,
  err_sum (H,) float32)``.
* ``score(T, p, q, valid, model, info)``: the score of given poses T
  (B, 7): ``(inl, counts, err_sum)``; the refit passes call it at B = 1.

The score of a pose is the inlier mask ``(err < thr) & valid`` of the
configured error model (``ScoreModel``: ``error_version`` 0-4, the three
thresholds, ``fu`` and ``fv``), its count, and the sum of the inliers'
errors in the order of ATen's CPU sum of a contiguous row
(``kabsch.inner_sum``).

A CPU tensor takes the plain version (``plain_hypotheses``,
``plain_score``), which is the arithmetic ``frontend/ransac.py`` did
before the kernel, operation for operation, so that CPU results do not
move. A CUDA tensor launches ``csrc/ransac_score.cu`` once a call (built,
bound and counted by ``utils/cuda_lib.py``) or raises; the kernel repeats
every operation of the plain version, so the two agree bit for bit on the
card. Launches are counted on the card by mode (``_LIB.launch_counts()``:
``ransac_score.hypotheses``, ``ransac_score.score``; not under
``cuda_lib.uncounted()``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.ops import kabsch
from putslam_tpu_torch.utils import cuda_lib


class ScoreModel(NamedTuple):
    """The error model of a RANSAC config (``RansacConfig.error_version``
    and its thresholds; the camera's focal lengths for the reprojection
    models 1 and 2, NaN where there is no camera)."""
    error_version: int
    thr_euclidean: float
    thr_reprojection: float
    thr_mahalanobis: float
    fu: float = math.nan
    fv: float = math.nan


def model_of(cfg, cam=None) -> ScoreModel:
    """The ``ScoreModel`` of a ``RansacConfig`` and an optional
    ``CameraConfig``."""
    if cfg.error_version not in range(5):
        raise ValueError(f"unsupported error_version {cfg.error_version}")
    if cfg.error_version in (1, 2) and cam is None:
        raise ValueError(f"error_version {cfg.error_version} needs a camera")
    return ScoreModel(cfg.error_version, cfg.inlier_threshold_euclidean,
                      cfg.inlier_threshold_reprojection,
                      cfg.inlier_threshold_mahalanobis,
                      math.nan if cam is None else cam.fu,
                      math.nan if cam is None else cam.fv)


def _bind(lib) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    floats = ctypes.POINTER(ctypes.c_float)
    lib.ransac_score_hypotheses_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i32, i32, floats, ptr, ptr,
        ptr, ptr, ptr, i32, ptr]
    lib.ransac_score_score_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i64, i32, floats, ptr, ptr, ptr, ptr,
        i32, ptr]
    for fn in (lib.ransac_score_hypotheses_launch,
               lib.ransac_score_score_launch):
        fn.restype = i32


# the most matches the kernel stages (and whose masked errors it stashes)
# in shared memory; a longer row's errors go to a scratch buffer (checked
# against the library when it is loaded)
STAGED = 1024
_LIB = cuda_lib.Library("ransac_score", _bind, constants={"staged": STAGED},
                        modes=("hypotheses", "score"))


def hypotheses(p, q, valid, idx, model: ScoreModel, info=None):
    """Fit and score the hypotheses whose samples ``idx`` (k, H) int64
    picks from the matches p, q (N, 3), ``valid`` (N,) bool; ``info``:
    optional (N, 3, 3) information matrices (``error_version`` 3). Returns
    (T (H, 7), inl (H, N), counts (H,), err_sum (H,)). CPU: the plain
    version; CUDA: one kernel launch."""
    if p.device.type == "cpu":
        return plain_hypotheses(p, q, valid, idx, model, info)
    return _launch(p, q, valid, model, info, idx=idx)


def score(T, p, q, valid, model: ScoreModel, info=None):
    """The inlier rows, counts and masked error sums of the poses T (B, 7)
    against the matches (as ``hypotheses``). CPU: the plain version; CUDA:
    one kernel launch."""
    if p.device.type == "cpu":
        return plain_score(T, p, q, valid, model, info)
    return _launch(p, q, valid, model, info, poses=T)


def plain_errors(T, p, q, model: ScoreModel, info=None):
    """The error of each (pose, match) pair and its threshold:
    (err (B, N), thr: a float or an (N,) tensor) for poses T (B, 7); the
    port's one error model (``putslam_tpu/frontend/ransac.py::
    _pair_errors``). Error_version 2 divides by the thresholds as 0-d
    tensors: PyTorch's CUDA kernel multiplies a tensor divided by a Python
    float by the float's reciprocal, the CPU divides; a 0-d tensor gives
    the division, the CPU's bits, on both.

    ``torch.sqrt`` stays: on the card it is correctly rounded, as the
    kernel's ``__fsqrt_rn``; on the CPU ATen's vectorised square root can
    be an ulp off, and the CPU's results stay those it gave before."""
    x, y, z = se3.apply_soa(T[:, None, :], p[:, 0], p[:, 1], p[:, 2])
    dx, dy, dz = x - q[:, 0], y - q[:, 1], z - q[:, 2]

    def reproj_err():
        zp = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        qz = q[:, 2]
        zo = torch.where(torch.abs(qz) < 1e-9, torch.full_like(qz, 1e-9), qz)
        du = model.fu * (x / zp - q[:, 0] / zo)
        dv = model.fv * (y / zp - q[:, 1] / zo)
        return torch.sqrt(du * du + dv * dv)

    v = model.error_version
    if v == 0:
        return torch.sqrt(dx * dx + dy * dy + dz * dz), model.thr_euclidean
    if v == 4:
        return (torch.sqrt(dx * dx + dy * dy + dz * dz),
                model.thr_euclidean * torch.clamp(q[:, 2], min=1.0))
    if v == 1:
        return reproj_err(), model.thr_reprojection
    if v == 2:
        e1 = torch.sqrt(dx * dx + dy * dy + dz * dz)
        return torch.maximum(e1 / e1.new_full((), model.thr_euclidean),
                             reproj_err()
                             / e1.new_full((), model.thr_reprojection)), 1.0
    if v == 3:
        if info is None:
            err = dx * dx + dy * dy + dz * dz
        else:
            i00, i01, i02 = info[:, 0, 0], info[:, 0, 1], info[:, 0, 2]
            i11, i12, i22 = info[:, 1, 1], info[:, 1, 2], info[:, 2, 2]
            err = (i00 * dx * dx + i11 * dy * dy + i22 * dz * dz
                   + 2.0 * (i01 * dx * dy + i02 * dx * dz + i12 * dy * dz))
        return err, model.thr_mahalanobis
    raise ValueError(f"unsupported error_version {v}")


def plain_score(T, p, q, valid, model: ScoreModel, info=None):
    """The plain version of ``score``: ``plain_errors``, the mask, its
    count, and the masked error sum through ``kabsch.inner_sum`` (on the
    CPU ``torch.sum``'s bits; on the card the same)."""
    err, thr = plain_errors(T, p, q, model, info)
    inl = (err < thr) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    err_sum = kabsch.inner_sum(torch.where(inl, err, torch.zeros_like(err)))
    return inl, counts, err_sum


def plain_hypotheses(p, q, valid, idx, model: ScoreModel, info=None):
    """The plain version of ``hypotheses``: the gather, then
    ``kabsch.plain_kabsch_soa``, then ``plain_score``."""
    T = kabsch.plain_kabsch_soa(*(x[:, c][idx] for x in (p, q)
                                  for c in range(3)))
    return (T,) + plain_score(T, p, q, valid, model, info)


def _check(what, name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{what}: {name} on {x.device}, p on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{what}: {name} needs {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{what}: {name} {tuple(x.shape)}, needs {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: needs contiguous tensors ({name})")


def _launch(p, q, valid, model, info, idx=None, poses=None):
    """The CUDA path of ``hypotheses`` (``idx``) and ``score``
    (``poses``): checks, the outputs, one launch."""
    fit = idx is not None
    what = "ransac_score.hypotheses" if fit else "ransac_score.score"
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if p.dim() != 2:
        raise ValueError(f"{what}: p {tuple(p.shape)}, needs (N, 3)")
    n = p.shape[0]
    _check(what, "p", p, torch.float32, (n, 3), dev)
    _check(what, "q", q, torch.float32, (n, 3), dev)
    _check(what, "valid", valid, torch.bool, (n,), dev)
    if info is not None:
        _check(what, "info", info, torch.float32, (n, 3, 3), dev)
    if model.error_version not in range(5):
        raise ValueError(f"unsupported error_version {model.error_version}")
    if fit:
        if idx.dim() != 2 or idx.shape[0] < 1 or n < 1:
            raise ValueError(f"{what}: idx {tuple(idx.shape)} over {n} "
                             f"matches")
        _check(what, "idx", idx, torch.int64, tuple(idx.shape), dev)
        count = idx.shape[1]
    else:
        if poses.dim() != 2:
            raise ValueError(f"{what}: T {tuple(poses.shape)}, needs (B, 7)")
        count = poses.shape[0]
        _check(what, "T", poses, torch.float32, (count, 7), dev)
    inl = torch.empty((count, n), dtype=torch.bool, device=dev)
    counts = torch.empty((count,), dtype=torch.int64, device=dev)
    err_sum = torch.empty((count,), dtype=torch.float32, device=dev)
    scratch = None if n <= STAGED else torch.empty(
        (count, n), dtype=torch.float32, device=dev)
    scratch_ptr = None if scratch is None else scratch.data_ptr()
    # the model's floats as float32, as PyTorch casts a Python float
    thr = (ctypes.c_float * 5)(model.thr_euclidean, model.thr_reprojection,
                               model.thr_mahalanobis, model.fu, model.fv)
    info_ptr = None if info is None else info.data_ptr()
    with torch.cuda.device(dev):
        cdll = _LIB.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fit:
            T = torch.empty((count, 7), dtype=torch.float32, device=dev)
            rc = cdll.ransac_score_hypotheses_launch(
                p.data_ptr(), q.data_ptr(), valid.data_ptr(), info_ptr,
                idx.data_ptr(), idx.shape[0], n, count,
                kabsch.squarings(30),    # plain_kabsch_soa's iterations
                model.error_version, thr,
                scratch_ptr, T.data_ptr(), inl.data_ptr(), counts.data_ptr(),
                err_sum.data_ptr(), cuda_lib.counted(), stream)
        else:
            rc = cdll.ransac_score_score_launch(
                p.data_ptr(), q.data_ptr(), valid.data_ptr(), info_ptr,
                poses.data_ptr(), n, count, model.error_version, thr,
                scratch_ptr, inl.data_ptr(), counts.data_ptr(),
                err_sum.data_ptr(), cuda_lib.counted(), stream)
        _LIB.check(rc, f"{what} kernel launch")
    if fit:
        return T, inl, counts, err_sum
    return inl, counts, err_sum
