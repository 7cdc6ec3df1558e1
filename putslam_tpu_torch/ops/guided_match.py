"""Guided map matching in one call: for every landmark of the map, its best
feature of the frame under the sphere, octave and depth gates, by the
Hamming distance of the descriptors, and whether the match is accepted.

``match(lm_cam, lm, feat, gates)`` returns ``(feat_idx, dist, valid,
n_candidates)``, what ``slam_map/features_map.py::guided_match`` returns
from the landmarks in the camera frame on: ``lm`` holds the map's
``lm_desc`` (L, D, 256) int8, ``lm_slot_used`` (L, D), ``lm_valid`` (L,)
and ``lm_octave`` (L,); ``feat`` the frame's ``xyz`` (N, 3), ``has_depth``,
``octave`` and ``desc`` (N, 256) int8; ``gates`` the radius, octave window,
Hamming gate and acceptance (``Gates``).

A CPU tensor takes the plain version (``plain_match``), which is the ATen
chain of the map's guided matching unchanged: the (L, N) gated distances
(``plain_distances``, which ``guided_match_pairs`` reads too), then argmin,
amin or the two smallest by topk, and the count. A CUDA tensor makes one
launch of ``csrc/guided_match.cu`` (built, bound and counted by
``utils/cuda_lib.py``) or raises: a warp a landmark, the descriptors
packed to bit planes and compared by AND and popcount, nothing of size
L × N in device memory. Its
operations repeat the chain's bits on the card (the sum of the squares in
the order of the card's ``torch.linalg.vector_norm``, the root correctly
rounded, the Python numbers as float32), so the two agree bit for bit with
descriptors of ±1 and 0. The call counts one launch on the card
(``_LIB.launch_count()``; not under ``cuda_lib.uncounted()``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from putslam_tpu_torch.utils import cuda_lib

DESC_BITS = 256
ACCEPTANCES = ("hamming", "ratio")
WARPS = 32                # warps a block (checked on load)
MAX_FEATURES = 2048       # the frame's features, staged in shared memory
MAX_VIEWS = 8             # descriptor slots a landmark


class Gates(NamedTuple):
    """What decides a match: the sphere radius (metres), the octave
    window, the Hamming gate (bits, slack included), the acceptance
    (``ACCEPTANCES``) and, for "ratio", the ratio of best to second."""

    radius: float
    octave_window: int
    max_dist: float
    acceptance: str
    accept_ratio: float


def plain_distances(lm_cam, lm, feat, radius: float,
                    octave_window: int) -> torch.Tensor:
    """(L, N) gated descriptor distances: 3D sphere gate + octave window +
    min over the multi-view slots of the Hamming distance (one matmul).
    inf where gated out."""
    L, D, _ = lm.lm_desc.shape
    N = feat.xyz.shape[0]
    d3 = torch.linalg.norm(lm_cam[:, None, :] - feat.xyz[None, :, :], dim=-1)
    gate = (d3 < radius) & lm.lm_valid[:, None] & feat.has_depth[None, :]
    d_oct = torch.abs(lm.lm_octave[:, None] - feat.octave[None, :])
    gate &= d_oct <= octave_window
    dots = (feat.desc.float()
            @ lm.lm_desc.reshape(L * D, DESC_BITS).float().T).reshape(N, L, D)
    ham = 0.5 * (DESC_BITS - dots)
    ham = torch.where(lm.lm_slot_used[None, :, :], ham,
                      torch.full_like(ham, math.inf))
    desc_dist = torch.amin(ham, dim=-1).T                            # (L, N)
    return torch.where(gate, desc_dist, torch.full_like(desc_dist, math.inf))


def plain_match(lm_cam, lm, feat, gates: Gates) -> Tuple[torch.Tensor, ...]:
    """The plain version: ``plain_distances``, then the best feature a
    landmark (first minimum), accepted by the Hamming gate or, with
    ``acceptance="ratio"``, only where it also beats the second-best
    candidate by the ratio (a single candidate is distinct)."""
    dist = plain_distances(lm_cam, lm, feat, gates.radius,
                           gates.octave_window)
    best_idx = torch.argmin(dist, dim=1).to(torch.int32)
    if gates.acceptance == "ratio":
        two = torch.topk(torch.where(torch.isfinite(dist), dist,
                                     torch.full_like(dist, 1e9)),
                         2, dim=1, largest=False, sorted=True).values
        best, second = two[:, 0], two[:, 1]
        distinct = (best <= gates.accept_ratio * second) | (second >= 1e9)
        ok = (best < 1e9) & (best <= gates.max_dist) & distinct
    else:
        best = torch.amin(dist, dim=1)
        ok = torch.isfinite(best) & (best <= gates.max_dist)
    n_cand = torch.sum(torch.any(torch.isfinite(dist), dim=1)).to(torch.int32)
    return (best_idx, torch.where(ok, best, torch.full_like(best, math.inf)),
            ok, n_cand)


def check_inputs(lm_cam, lm, feat, gates: Gates) -> None:
    """Raise ``ValueError`` on what the kernel does not take: another
    device, dtype or shape, a non-contiguous tensor, an int8 tensor not
    16-byte aligned (the kernel reads its rows 16 bytes a load), more than ``MAX_VIEWS`` slots or ``MAX_FEATURES``
    features, an unknown acceptance."""
    what = "guided_match.match"
    if gates.acceptance not in ACCEPTANCES:
        raise ValueError(f"{what}: acceptance {gates.acceptance!r}, not one "
                         f"of {ACCEPTANCES}")
    if lm.lm_desc.dim() != 3 or lm.lm_desc.shape[2] != DESC_BITS:
        raise ValueError(f"{what}: lm_desc {tuple(lm.lm_desc.shape)}, needs "
                         f"(L, D, {DESC_BITS})")
    L, D, _ = lm.lm_desc.shape
    N = feat.xyz.shape[0]
    if not 1 <= D <= MAX_VIEWS:
        raise ValueError(f"{what}: {D} descriptor slots, the kernel takes 1 "
                         f"to {MAX_VIEWS}")
    if not 1 <= N <= MAX_FEATURES or L < 1:
        raise ValueError(f"{what}: {L} landmarks and {N} features, the "
                         f"kernel takes 1 to {MAX_FEATURES} features")
    dev = lm_cam.device
    for name, x, dtype, shape in (
            ("lm_cam", lm_cam, torch.float32, (L, 3)),
            ("lm_desc", lm.lm_desc, torch.int8, (L, D, DESC_BITS)),
            ("lm_slot_used", lm.lm_slot_used, torch.bool, (L, D)),
            ("lm_valid", lm.lm_valid, torch.bool, (L,)),
            ("lm_octave", lm.lm_octave, torch.int32, (L,)),
            ("xyz", feat.xyz, torch.float32, (N, 3)),
            ("has_depth", feat.has_depth, torch.bool, (N,)),
            ("octave", feat.octave, torch.int32, (N,)),
            ("desc", feat.desc, torch.int8, (N, DESC_BITS))):
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, lm_cam on {dev}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} {x.dtype} {tuple(x.shape)}, "
                             f"needs {dtype} {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if dtype == torch.int8 and x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def match(lm_cam, lm, feat, gates: Gates) -> Tuple[torch.Tensor, ...]:
    """(feat_idx (L,) int32, dist (L,) float32, valid (L,) bool,
    n_candidates () int32): the plain version on the CPU, else one launch
    of the kernel. Raises ``ValueError`` where ``check_inputs`` does."""
    if lm_cam.device.type != "cuda":
        return plain_match(lm_cam, lm, feat, gates)
    check_inputs(lm_cam, lm, feat, gates)
    return _launch(lm_cam, lm, feat, gates)


def _bind(lib) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.guided_match_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, i32,
        f32, i32, f32, ptr, ptr, ptr, ptr, i32, ptr]
    lib.guided_match_norm3.argtypes = [ptr, ptr, ctypes.c_longlong, ptr]
    lib.guided_match_launch.restype = lib.guided_match_norm3.restype = i32


_LIB = cuda_lib.Library("guided_match", _bind, constants={
    "warps": WARPS, "max_features": MAX_FEATURES, "max_views": MAX_VIEWS})


def _f32(x: float) -> float:
    return float(np.float32(x))


def _launch(lm_cam, lm, feat, gates: Gates) -> Tuple[torch.Tensor, ...]:
    """The CUDA path of ``match``: the outputs and one launch."""
    L, D, _ = lm.lm_desc.shape
    N = feat.xyz.shape[0]
    dev = lm_cam.device
    feat_idx = torch.empty((L,), dtype=torch.int32, device=dev)
    dist = torch.empty((L,), dtype=torch.float32, device=dev)
    valid = torch.empty((L,), dtype=torch.bool, device=dev)
    n_cand = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        lib = _LIB.library()
        rc = lib.guided_match_launch(
            lm_cam.data_ptr(), lm.lm_desc.data_ptr(),
            lm.lm_slot_used.data_ptr(), lm.lm_valid.data_ptr(),
            lm.lm_octave.data_ptr(), feat.xyz.data_ptr(),
            feat.has_depth.data_ptr(), feat.octave.data_ptr(),
            feat.desc.data_ptr(), L, D, N, _f32(gates.radius),
            int(gates.octave_window), _f32(gates.max_dist),
            int(gates.acceptance == "ratio"), _f32(gates.accept_ratio),
            feat_idx.data_ptr(), dist.data_ptr(), valid.data_ptr(),
            n_cand.data_ptr(), cuda_lib.counted(),
            torch.cuda.current_stream(dev).cuda_stream)
        _LIB.check(rc, "guided_match.match kernel launch")
    return feat_idx, dist, valid, n_cand


def norm3(xyz: torch.Tensor) -> torch.Tensor:
    """(n,) the kernel's distance of each row of ``xyz`` (n, 3) float32 on
    the card: its sphere gate's norm, which must equal
    ``torch.linalg.vector_norm(xyz, dim=-1)`` there bit for bit."""
    if xyz.device.type != "cuda" or xyz.dtype != torch.float32 \
            or xyz.dim() != 2 or xyz.shape[1] != 3 or not xyz.is_contiguous():
        raise ValueError("guided_match.norm3 takes a contiguous (n, 3) "
                         "float32 tensor on the card")
    out = torch.empty((xyz.shape[0],), dtype=torch.float32,
                      device=xyz.device)
    with torch.cuda.device(xyz.device):
        lib = _LIB.library()
        _LIB.check(lib.guided_match_norm3(
            xyz.data_ptr(), out.data_ptr(), xyz.shape[0],
            torch.cuda.current_stream(xyz.device).cuda_stream),
            "guided_match.norm3 kernel launch")
    return out
