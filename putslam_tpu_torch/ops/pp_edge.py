"""The bundle adjustment's pose-pose edge terms in one call: for every edge
slot of the graph, the residual, its exact Jacobians, the live gate and the
robust weight.

``terms(g, kf_pose, kf_gen, robust_kernel, robust_delta)`` returns
``(r6, Ji, Jj, wpp, sq_pp)``, what ``backend/optimize.py::_pp_terms``
returns: r6 (E, 6) = log(Z⁻¹ ∘ T_i⁻¹ ∘ T_j), the Jacobians (E, 6, 6) with
respect to right perturbations of T_i and T_j, the robust weight
``wpp`` (E,) and the weighted squared error ``sq_pp`` (E,), for every slot
of ``g``'s pose-pose edges, valid or not. A slot's weight is ``pp_w``
where ``gate`` holds (valid and, with ``kf_gen``, both generations
current) and 0 elsewhere.

A CPU tensor takes the plain version (``plain_terms``), the ATen chain of
the solvers unchanged: the two pose gathers, ``factors.pp_residual``,
``factors.pp_jacobians`` (which evaluates the residual again), the gate
and ``factors.robust_weight``. A CUDA tensor makes one launch of
``csrc/pp_edge.cu`` (built, bound and counted by ``utils/cuda_lib.py``) or
raises: a thread an edge slot. Its operations repeat the chain's bits on
the card (each ATen op's rounding, the contraction of ``linalg.cross``,
the order of cuBLAS's 3×3 products and of the reduce kernel's sums, the
Python numbers as float32), so the two agree bit for bit. The call counts
one launch on the card (``_LIB.launch_count()``; not under
``cuda_lib.uncounted()``).

The kernel replaces no TPU kernel: it replaces the XLA fusion of
``putslam_tpu/backend/factors.py``'s pose-pose factor, which the port ran
as ~554 ATen launches a call. It is bound by its launch and one thread's
dependent chain (the log map, J_l⁻¹, Q), not by bytes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from putslam_tpu_torch.backend import factors
from putslam_tpu_torch.utils import cuda_lib

ROBUST_KINDS = ("none", "cauchy", "huber")
THREADS = 64              # edge slots a block (checked on load)


def gate(g, kf_gen) -> torch.Tensor:
    """Live pose-pose edges (E,) bool: valid, both generations current."""
    live = g.pp_valid
    if kf_gen is not None:
        live = live & (g.pp_gen_i == kf_gen[g.pp_i]) \
            & (g.pp_gen_j == kf_gen[g.pp_j])
    return live


def plain_terms(g, kf_pose, kf_gen, robust_kernel: str,
                robust_delta: float) -> Tuple[torch.Tensor, ...]:
    """The plain version: the ATen chain, (r6, Ji, Jj, wpp, sq_pp)."""
    pi = kf_pose[g.pp_i]
    pj = kf_pose[g.pp_j]
    r6 = factors.pp_residual(pi, pj, g.pp_rel)
    Ji, Jj = factors.pp_jacobians(pi, pj, g.pp_rel)
    wpp_info = g.pp_w * gate(g, kf_gen)
    sq_pp = wpp_info * torch.sum(r6 * r6, dim=-1)
    wpp = wpp_info * factors.robust_weight(sq_pp, robust_kernel, robust_delta)
    return r6, Ji, Jj, wpp, sq_pp


def check_inputs(g, kf_pose, kf_gen, robust_kernel: str) -> None:
    """Raise ``ValueError`` on what the kernel does not take: another
    device, dtype or shape, a non-contiguous tensor, no keyframe or edge
    slot, an unknown robust kernel."""
    what = "pp_edge.terms"
    if robust_kernel not in ROBUST_KINDS:
        raise ValueError(f"{what}: robust kernel {robust_kernel!r}, not one "
                         f"of {ROBUST_KINDS}")
    if kf_pose.dim() != 2 or kf_pose.shape[1] != 7 or kf_pose.shape[0] < 1:
        raise ValueError(f"{what}: kf_pose {tuple(kf_pose.shape)}, needs "
                         f"(K, 7), K ≥ 1")
    K = kf_pose.shape[0]
    E = g.pp_i.shape[0] if g.pp_i.dim() == 1 else 0
    if E < 1:
        raise ValueError(f"{what}: pp_i {tuple(g.pp_i.shape)}, needs (E,), "
                         f"E ≥ 1")
    dev = kf_pose.device
    named = [("kf_pose", kf_pose, torch.float32, (K, 7)),
             ("pp_i", g.pp_i, torch.int32, (E,)),
             ("pp_j", g.pp_j, torch.int32, (E,)),
             ("pp_rel", g.pp_rel, torch.float32, (E, 7)),
             ("pp_w", g.pp_w, torch.float32, (E,)),
             ("pp_valid", g.pp_valid, torch.bool, (E,)),
             ("pp_gen_i", g.pp_gen_i, torch.int32, (E,)),
             ("pp_gen_j", g.pp_gen_j, torch.int32, (E,))]
    if kf_gen is not None:
        named.append(("kf_gen", kf_gen, torch.int32, (K,)))
    for name, x, dtype, shape in named:
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, kf_pose on "
                             f"{dev}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} {x.dtype} {tuple(x.shape)}, "
                             f"needs {dtype} {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def terms(g, kf_pose, kf_gen, robust_kernel: str,
          robust_delta: float) -> Tuple[torch.Tensor, ...]:
    """(r6 (E, 6), Ji (E, 6, 6), Jj (E, 6, 6), wpp (E,), sq_pp (E,)),
    float32, from one launch of the kernel. Raises ``ValueError`` where
    ``check_inputs`` does, and for tensors that are not on a CUDA
    device."""
    if kf_pose.device.type != "cuda":
        raise ValueError(f"pp_edge.terms: kf_pose on {kf_pose.device}; the "
                         f"kernel takes CUDA tensors (plain_terms elsewhere)")
    check_inputs(g, kf_pose, kf_gen, robust_kernel)
    return _launch(g, kf_pose, kf_gen, robust_kernel, robust_delta)


def _bind(lib) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pp_edge_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, f32,
        ptr, ptr, ptr, ptr, ptr, i32, ptr]
    lib.pp_edge_launch.restype = i32


_LIB = cuda_lib.Library("pp_edge", _bind, constants={
    "threads": THREADS, "robust_modes": len(ROBUST_KINDS)})


def robust_floats(robust_delta: float) -> Tuple[float, float]:
    """(δ, 1 / δ²) as the chain's ATen kernels see them on the card: δ
    cast to float32; δ² a Python product cast to float32, its reciprocal
    in float32 (a division by a Python number is a product with it)."""
    d2 = np.float32(robust_delta * robust_delta)
    return float(np.float32(robust_delta)), float(np.float32(1.0) / d2)


def _launch(g, kf_pose, kf_gen, robust_kernel: str,
            robust_delta: float) -> Tuple[torch.Tensor, ...]:
    """The CUDA path of ``terms``: the outputs and one launch."""
    K = kf_pose.shape[0]
    E = g.pp_i.shape[0]
    dev = kf_pose.device
    f32 = dict(dtype=torch.float32, device=dev)
    r6 = torch.empty((E, 6), **f32)
    Ji = torch.empty((E, 6, 6), **f32)
    Jj = torch.empty((E, 6, 6), **f32)
    wpp = torch.empty((E,), **f32)
    sq_pp = torch.empty((E,), **f32)
    delta, inv_delta2 = robust_floats(robust_delta)
    with torch.cuda.device(dev):
        lib = _LIB.library()
        rc = lib.pp_edge_launch(
            kf_pose.data_ptr(),
            None if kf_gen is None else kf_gen.data_ptr(),
            g.pp_i.data_ptr(), g.pp_j.data_ptr(), g.pp_rel.data_ptr(),
            g.pp_w.data_ptr(), g.pp_valid.data_ptr(), g.pp_gen_i.data_ptr(),
            g.pp_gen_j.data_ptr(), K, E, ROBUST_KINDS.index(robust_kernel),
            delta, inv_delta2, r6.data_ptr(), Ji.data_ptr(), Jj.data_ptr(),
            wpp.data_ptr(), sq_pp.data_ptr(), cuda_lib.counted(),
            torch.cuda.current_stream(dev).cuda_stream)
        _LIB.check(rc, "pp_edge.terms kernel launch")
    return r6, Ji, Jj, wpp, sq_pp
