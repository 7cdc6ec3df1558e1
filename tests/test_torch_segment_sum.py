"""Segment sums in a fixed order (``putslam_tpu_torch/ops/segment.py``) on
the CPU.

The plan's plain version (``index_add_`` into a zeroed buffer with a
sentinel row) is what the CPU runs; the CUDA kernel
(``csrc/segment_sum.cu``) adds each segment's rows in the order the plan's
stable sort gives, which ``_ordered_sum`` below repeats in Python, and
``_block_walk`` with the kernel's blocks, chunks and batches: all must
equal ``index_add_`` bit for bit (the CPU's ``index_add_`` adds the
rows in ascending order). Then the solvers' concatenated plans against the
scatters they replaced (the observation rows, then the pose-pose edges'
four blocks, in the order the scatters ran), and the plan's construction
under the dispatch mode that raises on a host read (the plan is built
inside the BA's branch of a captured frame). The kernel itself runs on
the card only: ``tests/test_torch_segment_sum_cuda.py``.
"""

import numpy as np
import pytest
import torch
from test_torch_compiled_step import NoHostRead

from putslam_tpu_torch.backend import optimize as topt
from putslam_tpu_torch.ops import segment
from putslam_tpu_torch.ops.segment import SegmentPlan


def _index_add(x, idx, n):
    out = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=x.dtype)
    out.index_add_(0, idx, x)
    return out[:n]


def _ordered_sum(x, plan):
    """The kernel's order in Python: each segment's rows in the order of
    ``plan.perm``, added one by one from 0."""
    out = torch.zeros((plan.n,) + tuple(x.shape[1:]), dtype=x.dtype)
    off = plan.offsets.tolist()
    for s in range(plan.n):
        acc = torch.zeros(x.shape[1:], dtype=x.dtype)
        for j in range(off[s], off[s + 1]):
            acc = acc + x[plan.perm[j]]
        out[s] = acc
    return out


def _case(kind, trailing, seed):
    """(x, idx, n) of one case, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        n = int(rng.integers(1, 40))
        m = int(rng.integers(0, 300))
        idx = rng.integers(0, n + 1, m)
    elif kind == "sentinel_only":          # every row dropped
        n, m = 5, 17
        idx = np.full(m, n)
    elif kind == "empty_segments":         # most segments get no row
        n, m = 64, 40
        idx = rng.choice([3, 9, 10, 63, 64], m)
    elif kind == "one_long_segment":       # many rows in one segment
        n, m = 6, 2000
        idx = np.where(rng.uniform(size=m) < 0.9, 2, rng.integers(0, 7, m))
    else:                                  # no rows at all
        n, m = 8, 0
        idx = np.zeros(0, np.int64)
    # values of mixed magnitude, so that the order of the adds shows
    x = (rng.standard_normal((m,) + trailing)
         * 10.0 ** rng.integers(-3, 4, (m,) + trailing)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(idx.astype(np.int64)), n


KINDS = ("random", "sentinel_only", "empty_segments", "one_long_segment",
         "no_rows")
TRAILING = ((), (3,), (6, 3), (2, 3, 3))


@pytest.mark.parametrize("trailing", TRAILING, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_plan_sum_equals_index_add(kind, trailing):
    x, idx, n = _case(kind, trailing, seed=len(kind) + len(trailing))
    plan = SegmentPlan(idx, n)
    ref = _index_add(x, idx, n)
    got = plan.sum(x)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.equal(got, ref)
    assert torch.equal(_ordered_sum(x, plan), ref)


@pytest.mark.parametrize("seed", range(6))
def test_random_sizes_in_the_kernels_order(seed):
    x, idx, n = _case("random", (6,), seed=100 + seed)
    plan = SegmentPlan(idx, n)
    assert torch.equal(_ordered_sum(x, plan), _index_add(x, idx, n))


def _block_walk(x, plan, per_block, chunk):
    """The kernel's control flow in Python: a block a run of ``per_block``
    segments; zeros for its empty segments only; its rows staged ``chunk``
    rows at a time; in a chunk, each segment that starts there (or goes on
    from the chunk before) is added by one thread a column, its rows in
    order, eight at a time and then the rest, from 0.0 or from the sum
    carried over; at the segment's end the sum is written, before it
    carried into the next chunk. Every output element must be written
    exactly once."""
    cols = int(np.prod(x.shape[1:]))
    xf = x.reshape(x.shape[0], cols).numpy()
    perm, keys = plan.perm.numpy(), plan.keys.numpy()
    off = plan.offsets.numpy()
    out = np.full((plan.n, cols), np.nan, np.float32)
    writes = np.zeros((plan.n, cols), int)
    for s0 in range(0, plan.n, per_block):
        ns = min(plan.n, s0 + per_block) - s0
        soff = off[s0:s0 + ns + 1]
        for ls in range(ns):                         # the empty segments
            if soff[ls + 1] == soff[ls]:
                out[s0 + ls] = 0.0
                writes[s0 + ls] += 1
        carry = None
        for c0 in range(soff[0], soff[ns], chunk):
            cnt = min(chunk, soff[ns] - c0)
            skey, rows = keys[c0:c0 + cnt], xf[perm[c0:c0 + cnt]]
            starts = [r for r in range(cnt)
                      if r == 0 or skey[r] != skey[r - 1]]
            carry_out = None
            for r in starts[::-1]:                   # in any order
                key = skey[r]
                end = soff[key - s0 + 1] - c0
                stop = min(end, cnt)
                acc = carry if r == 0 and soff[key - s0] < c0 else \
                    np.zeros(cols, np.float32)
                while r + 8 <= stop:
                    for i in range(8):
                        acc = acc + rows[r + i]
                    r += 8
                for i in range(stop - r):
                    acc = acc + rows[r + i]
                if stop == end:
                    out[key] = acc
                    writes[key] += 1
                else:
                    carry_out = acc
            carry = carry_out
    assert (writes == 1).all()
    return torch.from_numpy(out).reshape((plan.n,) + tuple(x.shape[1:]))


@pytest.mark.parametrize("per_block,chunk", [(1, 8), (1, 24), (3, 16),
                                             (7, 32), (64, 48)])
@pytest.mark.parametrize("kind", KINDS)
def test_block_walk_in_python_is_the_plain_order(kind, per_block, chunk):
    """The kernel's blocks, chunks and batches of 8 (``_block_walk``) give
    ``index_add_``'s bits, at chunks far smaller than the kernel's so that
    segments cross them."""
    x, idx, n = _case(kind, (3,), seed=7 + per_block + chunk)
    plan = SegmentPlan(idx, n)
    assert torch.equal(_block_walk(x, plan, per_block, chunk),
                       _index_add(x, idx, n))


def test_plan_layout():
    idx = torch.tensor([4, 1, 1, 0, 4, 2, 1])
    plan = SegmentPlan(idx, 4)
    assert plan.perm.tolist() == [3, 1, 2, 6, 5, 0, 4]      # stable
    assert plan.keys.tolist() == [0, 1, 1, 1, 2, 4, 4]      # idx sorted
    assert plan.offsets.tolist() == [0, 1, 4, 5, 5, 7]     # n + 2 entries
    assert plan.rows == 7
    # the kernel reads keys and offsets as int32, perm as int64
    assert plan.keys.dtype == plan.offsets.dtype == torch.int32
    assert plan.perm.dtype == torch.int64


def test_a_plan_is_reused_over_several_rows():
    _, idx, n = _case("random", (), seed=3)
    plan = SegmentPlan(idx, n)
    rng = np.random.default_rng(4)
    for shape in ((), (6, 6), (3,), ()):
        x = torch.from_numpy(rng.standard_normal(
            (idx.shape[0],) + shape).astype(np.float32))
        first = plan.sum(x)
        assert torch.equal(plan.sum(x), first)
        assert torch.equal(first, SegmentPlan(idx, n).sum(x))
        assert torch.equal(first, _index_add(x, idx, n))


def test_plan_makes_no_host_read():
    x, idx, n = _case("random", (6, 3), seed=5)
    with NoHostRead():
        plan = SegmentPlan(idx, n)
        out = plan.sum(x)
    assert torch.equal(out, _index_add(x, idx, n))


def test_the_kernel_path_refuses_a_cpu_tensor():
    x, idx, n = _case("random", (3,), seed=6)
    with pytest.raises(ValueError, match="unsupported device"):
        segment.launch(x, SegmentPlan(idx, n))


def _edges(rng, n, E, sentinel):
    hi = n + 1 if sentinel else n
    return (torch.from_numpy(rng.integers(0, hi, E)),
            torch.from_numpy(rng.integers(0, hi, E)))


@pytest.mark.parametrize("sentinel", [False, True])
def test_hessian_plan_equals_the_scatters(sentinel):
    """The diagonal rows, then the four blocks of each pose-pose edge, summed
    by one plan: the bits of the scatters ``gauss_newton_mm`` made one after
    the other into an (n + 1)² buffer."""
    rng = np.random.default_rng(7 + sentinel)
    n, M, E = 9, 50, 30
    diag = torch.from_numpy(rng.integers(0, n, M))
    pi, pj = _edges(rng, n, E, sentinel)
    rows = torch.from_numpy(rng.standard_normal((M + 4 * E, 6, 6))
                            .astype(np.float32))
    n1 = n + 1
    ref = torch.zeros((n1 * n1, 6, 6))
    lists = [(diag, diag)] + list(topt._pp_pairs(pi, pj))
    start = 0
    for a, b in lists:
        ref.index_add_(0, a * n1 + b, rows[start:start + a.shape[0]])
        start += a.shape[0]
    ref = ref.view(n1, n1, 6, 6)[:n, :n]
    got = topt.hessian_plan(diag, n, pi, pj).sum(rows).view(n, n, 6, 6)
    assert torch.equal(got, ref)


def test_coupling_plan_equals_the_scatter():
    """G over (kf, lm) with dropped rows at kf = K or lm = L: the bits of
    the (K + 1)·(L + 1) scatter ``schur_subtrahend_mm`` made."""
    rng = np.random.default_rng(9)
    K, L, M = 5, 11, 120
    kf = torch.from_numpy(rng.integers(0, K + 1, M))
    lm = torch.from_numpy(rng.integers(0, L + 1, M))
    F = torch.from_numpy(rng.standard_normal((M, 6, 3)).astype(np.float32))
    ref = torch.zeros(((K + 1) * (L + 1), 6, 3))
    ref.index_add_(0, kf * (L + 1) + lm, F)
    ref = ref.view(K + 1, L + 1, 6, 3)[:K, :L]
    got = topt.coupling_plan(kf, lm, K, L).sum(F).view(K, L, 6, 3)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("seed", range(4))
def test_dead_rows_to_the_sentinel_change_no_bit(seed):
    """The solvers send rows of zero weight (empty store slots, stale
    edges: every term ±0) to the dropped segment: the sums keep their bits,
    since a sum that starts at +0 is never -0, and x + (±0) = x otherwise."""
    x, idx, n = _case("one_long_segment", (6, 6), seed=200 + seed)
    rng = np.random.default_rng(seed)
    live = torch.from_numpy(rng.uniform(size=idx.shape[0]) < 0.3)
    signs = torch.from_numpy(rng.choice([-1.0, 1.0], x.shape)
                             .astype(np.float32))
    x = torch.where(live[:, None, None], x, 0.0 * signs)
    got = SegmentPlan(topt._live(idx, live, n), n).sum(x)
    assert torch.equal(got, _index_add(x, idx, n))
    assert not torch.signbit(got[got == 0]).any()
