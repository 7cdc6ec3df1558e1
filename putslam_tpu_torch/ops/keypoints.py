"""The detector's keypoint chain in one call: from the FAST maps of every
pyramid level to the detector's outputs and the descriptor product's
bfloat16 input.

``chain(det, cam, shapes, budgets, levels, maps, depth)`` does, level by
level, what ``frontend/detector.py::detect_and_describe`` did between
``fast_cuda.fast_score_nms_levels`` and ``brief.describe_patches``'s
matrix product:

1. the subtile grid cap (``fast.grid_topk``): each subtile's first maximum
   of the NMS map, then the level's budget of the strongest by a stable
   descending sort (ties to the lower index);
2. the 3×3 parabola refine on the raw map (``fast.subpixel_refine``);
3. the border test, the scaling to level 0, the nearest depth sample,
   the 8 fixed-point undistortion iterations and the unprojection
   (``geometry/camera.py``), the depth gate;
4. the 32×32 window of each slot (``brief.extract_patches``), rounded to
   bfloat16 (``brief.patch_matrix``).

It returns ``Chain``: the ``Features`` fields but the descriptor and the
angle, with ``-1`` / ``0`` in invalid slots, and the (N, 1024) bfloat16
patch matrix.

A CPU tensor takes the plain version (``plain_chain``), which is that
ATen chain unchanged, so CPU results keep their bits. A CUDA tensor makes
one call of ``csrc/keypoints.cu`` (built, bound and counted by
``utils/cuda_lib.py``) or raises: two kernel launches, a warp a subtile
for the subtile maxima, then a warp a subtile's candidate, which ranks its
score among its level's (the stable sort's position), and, where the rank
lies inside the budget, writes that slot: refine, lifting and window. Every operation
repeats the one ATen runs on the card (``_rn`` intrinsics, IEEE division,
a division by a Python float as ATen's CUDA kernel does it: times the
float32 reciprocal), so the two agree bit for bit. The call counts one
launch on the card (``_LIB.launch_count()``; not under
``cuda_lib.uncounted()``).

``grid_policy="exact"`` (the reference's per-cell top-k) has no kernel:
``chain`` hands it to ``plain_chain`` on every device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from putslam_tpu_torch.geometry import camera as camera_mod
from putslam_tpu_torch.ops import brief, fast
from putslam_tpu_torch.utils import cuda_lib

WARPS = 8                 # warps a block, both kernels (checked on load)
MAX_LEVELS = 8
MAX_CANDIDATES = 12288    # a level's subtiles, staged in shared memory
LEVEL_INTS = 10           # per level: H, W, budget, slot0, nsh, nsw,
                          # sub_h, sub_w, cand0, block0
LEVEL_FLOATS = 4          # per level: border low, u high, v high, scale
CAMERA_FLOATS = 13


class Chain(NamedTuple):
    """The keypoint chain's outputs over all levels' slots (N = the sum of
    the level budgets, level 0 first)."""

    uv: torch.Tensor          # (N, 2) float32, level-0 pixels; -1 invalid
    uv_undist: torch.Tensor   # (N, 2) float32; -1 invalid
    xyz: torch.Tensor         # (N, 3) float32; 0 without depth
    response: torch.Tensor    # (N,) float32; 0 invalid
    octave: torch.Tensor      # (N,) int32
    valid: torch.Tensor       # (N,) bool
    has_depth: torch.Tensor   # (N,) bool
    patches: torch.Tensor     # (N, 1024) bfloat16


class Plan(NamedTuple):
    """The static layout of one call: per level its ints (``LEVEL_INTS``)
    and floats (``LEVEL_FLOATS``), the slots, subtiles (= candidates) and
    select blocks in all, and the largest level's candidates."""

    ints: Tuple[int, ...]
    floats: Tuple[float, ...]
    slots: int
    candidates: int
    blocks: int
    max_candidates: int


def _border(border: int, scale_factor: float, lvl: int) -> float:
    """The border test's margin of level ``lvl``, in its pixels."""
    scale = scale_factor ** lvl
    return float(max(border // max(int(scale), 1), brief.PATCH // 2 + 1))


@functools.lru_cache(maxsize=64)
def plan(grid_rows: int, grid_cols: int, scale_factor: float, border: int,
         shapes: Tuple[Tuple[int, int], ...],
         budgets: Tuple[int, ...]) -> Plan:
    """The layout of ``shapes`` (H, W) a level with ``budgets`` slots: the
    subtile grid of each level (``fast.subtile_grid``: at least twice the
    budget of subtiles, so the cap never pads), its first slot, candidate
    and select block (a warp a candidate, ``WARPS`` a block), its border
    test's bounds and its scale, as float32 the way ATen casts the Python
    numbers."""
    ints, floats = [], []
    slot = cand = block = most = 0
    for lvl, ((H, W), K) in enumerate(zip(shapes, budgets)):
        nsh, nsw, sub_h, sub_w = fast.subtile_grid(H, W, grid_rows,
                                                   grid_cols, K)
        n = nsh * nsw
        ints += [H, W, K, slot, nsh, nsw, sub_h, sub_w, cand, block]
        b = _border(border, scale_factor, lvl)
        floats += [float(np.float32(b)), float(np.float32(W - 1 - b)),
                   float(np.float32(H - 1 - b)),
                   float(np.float32(scale_factor ** lvl))]
        slot += K
        cand += n
        block += -(-n // WARPS)
        most = max(most, n)
    return Plan(tuple(ints), tuple(floats), slot, cand, block, most)


def camera_floats(cam) -> Tuple[float, ...]:
    """The camera's numbers as ATen's CUDA kernels use them, float32: cu,
    cv, fu, fv, 1/fu and 1/fv (a division by a Python float is a product
    with the float32 reciprocal there), k1, k2, k3, p1, p2, and the depth
    gate."""
    f = np.float32
    return tuple(float(x) for x in (
        f(cam.cu), f(cam.cv), f(cam.fu), f(cam.fv),
        f(1.0) / f(cam.fu), f(1.0) / f(cam.fv), f(cam.k1), f(cam.k2),
        f(cam.k3), f(cam.p1), f(cam.p2), f(cam.min_depth),
        f(cam.max_depth)))


def plain_chain(det, cam, shapes, budgets, levels, maps,
                depth) -> Chain:
    """The plain version: the ATen chain of ``detect_and_describe``, level
    by level (``fast.detect``'s cap of ``det.grid_policy`` and refine, the
    border test, ``brief.extract_patches``), then the lifting of all
    slots."""
    dev = levels[0].device
    all_uv0, all_resp, all_oct, all_patch, all_valid = [], [], [], [], []
    for lvl, (img, (Hl, Wl)) in enumerate(zip(levels, shapes)):
        scale = det.scale_factor ** lvl
        Nl = budgets[lvl]
        uv_l, resp, valid = fast.detect(
            img, det.fast_threshold, det.nms_radius, det.grid_rows,
            det.grid_cols, Nl, grid_policy=det.grid_policy, maps=maps[lvl])
        b = _border(det.border, det.scale_factor, lvl)
        inb = ((uv_l[:, 0] >= b) & (uv_l[:, 0] <= Wl - 1 - b)
               & (uv_l[:, 1] >= b) & (uv_l[:, 1] <= Hl - 1 - b))
        valid = valid & inb
        all_patch.append(brief.extract_patches(img, uv_l))
        all_uv0.append(uv_l * scale)
        all_resp.append(torch.where(valid, resp, torch.zeros_like(resp)))
        all_oct.append(torch.full((Nl,), lvl, dtype=torch.int32, device=dev))
        all_valid.append(valid)

    uv0 = torch.cat(all_uv0)
    resp = torch.cat(all_resp)
    valid = torch.cat(all_valid)
    z = camera_mod.sample_depth(depth, uv0)
    uv_und = camera_mod.undistort_pixels(cam, uv0)
    xyz = camera_mod.unproject(cam, uv_und, z)
    has_depth = valid & camera_mod.depth_valid_mask(cam, z)
    v2 = valid[:, None]
    return Chain(
        uv=torch.where(v2, uv0, torch.full_like(uv0, -1.0)),
        uv_undist=torch.where(v2, uv_und, torch.full_like(uv_und, -1.0)),
        xyz=torch.where(has_depth[:, None], xyz, torch.zeros_like(xyz)),
        response=torch.where(valid, resp, torch.zeros_like(resp)),
        octave=torch.cat(all_oct),
        valid=valid,
        has_depth=has_depth,
        patches=brief.patch_matrix(torch.cat(all_patch)))


def _check(what, levels, maps, depth, shapes, budgets, cuda: bool):
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{what}: need 1 to {MAX_LEVELS} levels, got "
                         f"{len(levels)}")
    if not len(maps) == len(shapes) == len(budgets) == len(levels):
        raise ValueError(f"{what}: {len(levels)} levels, {len(maps)} map "
                         f"pairs, {len(shapes)} shapes, {len(budgets)} "
                         f"budgets")
    dev = levels[0].device

    def need(name, x, shape):
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, level 0 on "
                             f"{dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"{what}: {name} needs float32, got {x.dtype}")
        if x.dim() != 2 or (shape is not None and tuple(x.shape) != shape):
            raise ValueError(f"{what}: {name} {tuple(x.shape)}, needs "
                             f"{shape or '2-D'}")
        if cuda and not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")

    for lvl, (img, (raw, nms), shape) in enumerate(zip(levels, maps,
                                                       shapes)):
        shape = tuple(shape)
        if min(shape) < brief.PATCH:
            raise ValueError(f"{what}: level {lvl} {shape} is smaller than "
                             f"a {brief.PATCH}-pixel window")
        need(f"level {lvl}", img, shape)
        need(f"level {lvl}'s raw map", raw, shape)
        need(f"level {lvl}'s NMS map", nms, shape)
    need("depth", depth, None)


def chain(det, cam, shapes: Sequence[Tuple[int, int]],
          budgets: Sequence[int], levels: Sequence[torch.Tensor],
          maps: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          depth: torch.Tensor) -> Chain:
    """The keypoint chain of one frame (``det``: a ``DetectorConfig``,
    ``cam``: a ``CameraConfig``): ``levels`` the pyramid (H_l, W_l)
    float32 = ``shapes``, ``maps`` each level's (raw, nms) FAST maps,
    ``depth`` (H, W) float32 metres, ``budgets`` the slots a level. The
    plain version on the CPU or for a ``grid_policy`` other than
    "subtile"; else one call of the kernel. Raises ``ValueError`` on a
    wrong device, dtype, shape or (CUDA) contiguity."""
    levels, maps = list(levels), list(maps)
    shapes = tuple(tuple(int(v) for v in s) for s in shapes)
    budgets = tuple(int(k) for k in budgets)
    what = "keypoints.chain"
    if not levels:
        raise ValueError(f"{what}: no level")
    cuda = levels[0].device.type == "cuda"
    _check(what, levels, maps, depth, shapes, budgets, cuda)
    if not cuda or det.grid_policy != "subtile":
        return plain_chain(det, cam, shapes, budgets, levels, maps, depth)
    return _launch(det, cam, shapes, budgets, levels, maps, depth)


def _bind(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.keypoints_launch.argtypes = [
        i32, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        i32, i32, i32, ptr, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ptr, ptr, ptr, i32, ptr]
    lib.keypoints_launch.restype = i32


_LIB = cuda_lib.Library("keypoints", _bind, constants={"warps": WARPS})


def _launch(det, cam, shapes, budgets, levels, maps, depth) -> Chain:
    """The CUDA path of ``chain``: the outputs, the candidates' buffers
    and one call (two launches)."""
    what = "keypoints.chain"
    p = plan(det.grid_rows, det.grid_cols, det.scale_factor, det.border,
             shapes, budgets)
    if p.max_candidates > MAX_CANDIDATES:
        raise ValueError(f"{what}: a level has {p.max_candidates} subtiles, "
                         f"the kernel stages at most {MAX_CANDIDATES}")
    dev = levels[0].device
    N = p.slots

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Chain(uv=empty(N, 2), uv_undist=empty(N, 2), xyz=empty(N, 3),
                response=empty(N), octave=empty(N, dtype=torch.int32),
                valid=empty(N, dtype=torch.bool),
                has_depth=empty(N, dtype=torch.bool),
                patches=empty(N, brief.PATCH * brief.PATCH,
                              dtype=torch.bfloat16))
    cand_score = empty(p.candidates)
    cand_arg = empty(p.candidates, dtype=torch.int32)
    n = len(levels)
    ptrs = (ctypes.c_void_p * (3 * n))(*(
        t.data_ptr() for img, (raw, nms) in zip(levels, maps)
        for t in (img, raw, nms)))
    ints = (ctypes.c_int * len(p.ints))(*p.ints)
    floats = (ctypes.c_float * len(p.floats))(*p.floats)
    cam_f = (ctypes.c_float * CAMERA_FLOATS)(*camera_floats(cam))
    with torch.cuda.device(dev):
        lib = _LIB.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.keypoints_launch(
            n, ptrs, ints, floats, cam_f, p.candidates, p.blocks,
            p.max_candidates, depth.data_ptr(), depth.shape[0],
            depth.shape[1], out.uv.data_ptr(), out.uv_undist.data_ptr(),
            out.xyz.data_ptr(), out.response.data_ptr(),
            out.octave.data_ptr(), out.valid.data_ptr(),
            out.has_depth.data_ptr(), out.patches.data_ptr(),
            cand_score.data_ptr(), cand_arg.data_ptr(), cuda_lib.counted(),
            stream)
        _LIB.check(rc, f"{what} kernel launch")
    return out
