"""Batched closed-form rigid alignment (Horn's quaternion method) — port
of ``putslam_tpu/ops/kabsch.py``: RANSAC's fit, and ``alignment_residuals``
and ``transform_covariance``, which evaluate an estimate.

The JAX package writes the solve structure-of-arrays so that XLA fuses it
into one pass over every hypothesis: the dominant eigenvector of Horn's
4×4 matrix from a fixed number of symmetric squarings, the sign fixed, the
translation from the means. Op by op in PyTorch that is ~500 elementwise
launches a solve. On the card the two fits run in hand-written kernels:

* ``kabsch_soa(px, …, qz)``, the sampled fit, components (n, ...), is the
  plain version (``plain_kabsch_soa``) on every device: RANSAC's main path
  runs the same fit inside ``ops/ransac_score.py::hypotheses``, on samples
  that kernel gathers;
* ``weighted_kabsch(p, q, w)``, the weighted refit, p, q (..., N, 3), w
  (..., N), is ONE launch of ``csrc/kabsch_fit.cu`` a call on the card
  (built, bound and counted by ``utils/cuda_lib.py``): one block a batch
  row, a warp a sum (the independent chains of ``row_sum`` /
  ``inner_sum``'s order on its lanes). A CPU tensor takes the plain version
  (``plain_weighted_kabsch``); a CUDA tensor launches the kernel or raises
  (float32, contiguous, one device).

The plain version writes out, operation for operation, the arithmetic
this module did on the CPU before the kernels (``torch.sum``, ``mean``,
``torch.linalg.norm``, ``torch.linalg.cross``), so that the kernels can
follow it and the CPU's results do not move:

* the refit's sums in the order of ATen's CPU float sums (``row_sum``,
  ``inner_sum``), the sampled fit's over its few points in turn from +0.0,
  a mean as that sum divided by n;
* a norm as the sum of squares in turn, then a correctly rounded square
  root (the first of Horn's through ``torch.sqrt``, as before);
* the cross products of the rotation as the CPU's FMA computes them
  (``_fma``: the exact product in double, then the sum, then float).

The kernels repeat each operation, so they agree with it bit for bit on
the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.utils import cuda_lib

# lanes of the vectors of ATen's CPU float sums, whose order ``inner_sum``
# repeats (checked against the library when it is loaded)
LANES = 8


def _bind(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kabsch_fit_weighted_launch.argtypes = [
        ptr, ptr, ptr, ctypes.c_longlong, i32, i32, ptr, i32, ptr]
    lib.kabsch_fit_weighted_launch.restype = i32


_LIB = cuda_lib.Library("kabsch_fit", _bind, constants={"lanes": LANES})


def squarings(iters: int) -> int:
    """Symmetric squarings of Horn's matrix for ``iters`` power iterations
    (s squarings ≈ 2^s iterations)."""
    return max(3, (iters + 5) // 6)


def weighted_kabsch(p, q, w, iters: int = 30):
    """Poses T = (R, t) minimising Σ wᵢ ‖R·pᵢ + t − qᵢ‖² per batch row.
    p, q: (..., n, 3); w: (..., n). Returns (..., 7). CPU: the plain
    version; CUDA: one kernel launch."""
    if p.device.type == "cpu":
        return plain_weighted_kabsch(p, q, w, iters)
    return _launch_weighted(p, q, w, iters)


def kabsch_soa(px, py, pz, qx, qy, qz, iters: int = 30):
    """Uniform-weight Kabsch from component tensors with the point axis
    leading: (n, ...) each. Returns (..., 7): the plain version on every
    device."""
    return plain_kabsch_soa(px, py, pz, qx, qy, qz, iters=iters)


def _ceil_log2(x: int) -> int:
    return 1 if x <= 2 else (x - 1).bit_length()


def row_sum(x):
    """Σ over dim -2 of x (..., n, m), lane by lane over the m trailing
    columns, in the order of ATen's CPU ``row_sum``: four accumulators take
    the elements in rows of four (element 4i + k into accumulator k)
    through a cascade of partial sums (16 rows a first-level block), the
    elements after the last full row go into accumulator 0, then
    accumulators 1-3 are added to it in turn."""
    n = x.shape[-2]
    size = n // 4
    rows = x[..., :4 * size, :].reshape(x.shape[:-2] + (size, 4)
                                        + x.shape[-1:])
    zero = x.new_zeros(rows.shape[:-3] + rows.shape[-2:])
    acc = [zero] * 4
    power = max(4, _ceil_log2(size) // 4)
    step, mask = 1 << power, (1 << power) - 1
    i = 0
    while i + step <= size:
        for _ in range(step):
            acc[0] = acc[0] + rows[..., i, :, :]
            i += 1
        for j in range(1, 4):
            acc[j], acc[j - 1] = acc[j] + acc[j - 1], zero
            if i & (mask << (j * power)):
                break
    for r in range(i, size):
        acc[0] = acc[0] + rows[..., r, :, :]
    for j in range(1, 4):
        acc[0] = acc[0] + acc[j]
    total = acc[0][..., 0, :]
    for r in range(4 * size, n):
        total = total + x[..., r, :]
    for k in range(1, 4):
        total = total + acc[0][..., k, :]
    return total


def inner_sum(x):
    """Σ over the last dim in the order of ATen's CPU sum of a contiguous
    row: from ``LANES`` elements on, the row's vectors of ``LANES`` through
    ``row_sum``, then, from +0.0, the elements after the last full vector
    and the lanes in turn; a shorter row through ``row_sum`` alone."""
    n = x.shape[-1]
    if n < LANES:
        return row_sum(x[..., None])[..., 0]
    nv = n // LANES
    lanes = row_sum(x[..., :nv * LANES].reshape(x.shape[:-1] + (nv, LANES)))
    total = x.new_zeros(x.shape[:-1])
    for k in range(nv * LANES, n):
        total = total + x[..., k]
    for lane in range(LANES):
        total = total + lanes[..., lane]
    return total


def _seq_sum(x):
    """Σ over dim 0 in turn from +0.0 (ATen's CPU order over fewer than 16
    rows)."""
    total = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        total = total + x[k]
    return total


def plain_weighted_kabsch(p, q, w, iters: int = 30):
    """The plain version of ``weighted_kabsch``: Σw and the nine
    cross-covariance sums through ``inner_sum``, the weighted means
    through ``row_sum`` (over the rows of the (..., n, 3) products)."""
    wsum = torch.clamp(inner_sum(w), min=1e-9)
    wn = w / wsum[..., None]
    p_bar = row_sum(wn[..., None] * p)
    q_bar = row_sum(wn[..., None] * q)
    wpc = wn[..., None] * (p - p_bar[..., None, :])
    qc = q - q_bar[..., None, :]
    S = [inner_sum(wpc[..., i] * qc[..., j])
         for i in range(3) for j in range(3)]
    return _pose(S, list(p_bar.unbind(-1)), list(q_bar.unbind(-1)), iters)


def plain_kabsch_soa(px, py, pz, qx, qy, qz, iters: int = 30):
    """The plain version of ``kabsch_soa``: the means and the nine sums
    over the n points in turn from +0.0; a mean is that sum divided by n,
    as ``mean`` takes it on the CPU (by a tensor: PyTorch's CUDA kernel
    multiplies by the reciprocal of a Python number)."""
    count = px.new_full((), float(px.shape[0]))
    pb = [_seq_sum(c) / count for c in (px, py, pz)]
    qb = [_seq_sum(c) / count for c in (qx, qy, qz)]
    pcs = [c - m for c, m in zip((px, py, pz), pb)]
    qcs = [c - m for c, m in zip((qx, qy, qz), qb)]
    S = [_seq_sum(pcs[i] * qcs[j]) for i in range(3) for j in range(3)]
    return _pose(S, pb, qb, iters)


def _norm(a, b, c, d, floor: float):
    """‖(a, b, c, d)‖ clamped below as ``torch.linalg.norm`` takes it on
    the CPU: the squares added in turn, then a correctly rounded square
    root (in double: ``torch.sqrt`` of a float on the CPU is not)."""
    sq = a * a + b * b + c * c + d * d
    return torch.clamp(torch.sqrt(sq.double()).float(), min=floor)


def _fma(a, b, c):
    """a·b + c as the CPU's cross product computes it, a fused
    multiply-add: the exact product in double, the sum, then float."""
    return (a.double() * b.double() + c.double()).float()


def _cross(a, b):
    """a × b of component lists, as ``torch.linalg.cross`` computes it on
    the CPU: component i is fma(a_j, b_k, −a_k·b_j)."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return [_fma(a1, b2, -(a2 * b1)), _fma(a2, b0, -(a0 * b2)),
            _fma(a0, b1, -(a1 * b0))]


def _pose(S, pb, qb, iters):
    """(..., 7) poses from the nine sums and the means (lists of component
    tensors): t = q̄ − R·p̄ (``se3.quat_rotate``: t' = 2 qv × v,
    v + qw t' + qv × t'), then the quaternion normalised once more, as
    ``se3.make_pose`` does."""
    qw, qx, qy, qz = _horn_quat_soa(S, iters)
    qv = [qx, qy, qz]
    tp = [c * 2.0 for c in _cross(qv, pb)]
    rot = _cross(qv, tp)
    t = [m - (v + qw * c + r) for m, v, c, r in zip(qb, pb, tp, rot)]
    nrm = _norm(qw, qx, qy, qz, 1e-12)
    return torch.stack(t + [qw / nrm, qx / nrm, qy / nrm, qz / nrm], dim=-1)


def _horn_quat_soa(S, iters: int = 30):
    """Optimal rotation quaternion from the nine cross-covariance component
    tensors S = (Sxx, Sxy, …, Szz): its components (w, x, y, z), w ≥ 0,
    normalised."""
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz = S
    k00 = Sxx + Syy + Szz
    k01 = Syz - Szy
    k02 = Szx - Sxz
    k03 = Sxy - Syx
    k11 = Sxx - Syy - Szz
    k12 = Sxy + Syx
    k13 = Szx + Sxz
    k22 = -Sxx + Syy - Szz
    k23 = Syz + Szy
    k33 = -Sxx - Syy + Szz
    a = torch.abs
    c = (a(k00) + a(k11) + a(k22) + a(k33)
         + (a(k01) + a(k02) + a(k03) + a(k12) + a(k13) + a(k23)) * 2.0) \
        * 0.25 + 1e-6
    b00, b11, b22, b33 = k00 + c, k11 + c, k22 + c, k33 + c
    b01, b02, b03, b12, b13, b23 = k01, k02, k03, k12, k13, k23

    for _ in range(squarings(iters)):
        n00 = b00 * b00 + b01 * b01 + b02 * b02 + b03 * b03
        n01 = b00 * b01 + b01 * b11 + b02 * b12 + b03 * b13
        n02 = b00 * b02 + b01 * b12 + b02 * b22 + b03 * b23
        n03 = b00 * b03 + b01 * b13 + b02 * b23 + b03 * b33
        n11 = b01 * b01 + b11 * b11 + b12 * b12 + b13 * b13
        n12 = b01 * b02 + b11 * b12 + b12 * b22 + b13 * b23
        n13 = b01 * b03 + b11 * b13 + b12 * b23 + b13 * b33
        n22 = b02 * b02 + b12 * b12 + b22 * b22 + b23 * b23
        n23 = b02 * b03 + b12 * b13 + b22 * b23 + b23 * b33
        n33 = b03 * b03 + b13 * b13 + b23 * b23 + b33 * b33
        scale = torch.clamp(torch.maximum(torch.maximum(n00, n11),
                                          torch.maximum(n22, n33)), min=1e-30)
        inv = torch.reciprocal(scale)
        b00, b11, b22, b33 = n00 * inv, n11 * inv, n22 * inv, n33 * inv
        b01, b02, b03 = n01 * inv, n02 * inv, n03 * inv
        b12, b13, b23 = n12 * inv, n13 * inv, n23 * inv

    c0, c1, c2, c3 = 1.0, 0.31, 0.17, 0.083
    v0 = b00 * c0 + b01 * c1 + b02 * c2 + b03 * c3
    v1 = b01 * c0 + b11 * c1 + b12 * c2 + b13 * c3
    v2 = b02 * c0 + b12 * c1 + b22 * c2 + b23 * c3
    v3 = b03 * c0 + b13 * c1 + b23 * c2 + b33 * c3
    nrm = torch.clamp(torch.sqrt(v0 * v0 + v1 * v1 + v2 * v2 + v3 * v3),
                      min=1e-20)
    v0, v1, v2, v3 = v0 / nrm, v1 / nrm, v2 / nrm, v3 / nrm
    u0 = b00 * v0 + b01 * v1 + b02 * v2 + b03 * v3
    u1 = b01 * v0 + b11 * v1 + b12 * v2 + b13 * v3
    u2 = b02 * v0 + b12 * v1 + b22 * v2 + b23 * v3
    u3 = b03 * v0 + b13 * v1 + b23 * v2 + b33 * v3
    nrm = _norm(u0, u1, u2, u3, 1e-20)
    v = [u0 / nrm, u1 / nrm, u2 / nrm, u3 / nrm]
    flip = v[0] < 0                           # the canonical sign, w ≥ 0
    v = [torch.where(flip, -x, x) for x in v]
    nrm = _norm(*v, 1e-12)                    # se3.quat_normalize
    return [x / nrm for x in v]


def _check_inputs(what, tensors, device):
    for x in tensors:
        if x.device != device:
            raise ValueError(f"{what}: tensors on {x.device} and {device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{what}: needs float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: needs contiguous tensors")


def _launch_weighted(p, q, w, iters):
    """The CUDA path of ``weighted_kabsch``: checks, the output, one
    launch."""
    what = "weighted_kabsch"
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    _check_inputs(what, (p, q, w), dev)
    if p.dim() < 2 or p.shape[-1] != 3 or q.shape != p.shape \
            or w.shape != p.shape[:-1]:
        raise ValueError(f"{what}: p {tuple(p.shape)}, q {tuple(q.shape)}, "
                         f"w {tuple(w.shape)}")
    batch = tuple(p.shape[:-2])
    out = torch.empty(batch + (7,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _LIB.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        _LIB.check(lib.kabsch_fit_weighted_launch(
            p.data_ptr(), q.data_ptr(), w.data_ptr(), math.prod(batch),
            p.shape[-2], squarings(iters), out.data_ptr(),
            cuda_lib.counted(), stream), f"{what} kernel launch")
    return out


def alignment_residuals(T, p, q):
    """‖T·p − q‖ per pair, broadcasting T (..., 7) over points (..., n, 3)."""
    return torch.linalg.norm(se3.apply(T[..., None, :], p) - q, dim=-1)


def transform_covariance(T, p, w, point_var: float = 1.0):
    """6×6 covariance of the estimated transform in the twist tangent at T
    (``putslam_tpu/ops/kabsch.py:159``): Cov(ξ) = σ² (Σ wᵢ JᵢᵀJᵢ)⁻¹ with
    Jᵢ = [I | −skew(T·pᵢ)] (left perturbation), damped by 1e-9·I for
    degenerate sets. p: (..., n, 3); w: (..., n). Returns (..., 6, 6)."""
    tp = se3.apply(T[..., None, :], p)                        # (..., n, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        tp.shape[:-1] + (3, 3))
    J = torch.cat([eye, -se3.skew(tp)], dim=-1)               # (..., n, 3, 6)
    H = torch.einsum("...n,...nri,...nrj->...ij", w, J, J)
    H = H + 1e-9 * torch.eye(6, dtype=p.dtype, device=p.device)
    return point_var * torch.linalg.inv(H)
