"""RANSAC's weighted refit as the hand-written kernel
(``csrc/kabsch_fit.cu``) on the card.

The kernel against its plain version on the card, bit for bit: the refit
at the VO's and the map's 512 matches, at loop closure's 128, at 1500 (read
from global memory, not staged) and in a batch of 700-match rows, the
degenerate inputs (all-zero weights, three
equal points, collinear points, fewer than 3 valid matches), and at the
edges of the warps' split of the sums (N 1 to 2051, one and three rows,
0/1 and all-zero weights); one launch a
call. Replayed from a CUDA graph it gives the eager bits, and a launch
inside a conditional node's body counts only where the card runs the body
(the warm-up under ``uncounted`` not at all). Float64, non-contiguous and
misshapen input on the card raise. Then ``ransac.estimate`` at the fr1
widths: the same bits eager, twice, and replayed (its sampled fit is
``csrc/ransac_score.cu``'s, whose card tests hold its bits).

Needs a CUDA card and skips without one. Imports no JAX, so on the machine
with the card it runs as:
python -m pytest tests/test_torch_kabsch_cuda.py --noconftest -q"""

import numpy as np
import pytest
import torch

from putslam_tpu_torch.ops import kabsch
from putslam_tpu_torch.utils import control, cuda_lib, graph_cond

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _scene(rng, N, outliers=0.3):
    """(p, q) float32: N points about 2 m ahead, q a rigid motion of p plus
    noise, a share of the pairs moved off as outliers."""
    p = rng.uniform(-1, 1, (N, 3)) + [0.0, 0.0, 2.0]
    a = 0.05
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]])
    q = p @ R.T + [0.05, -0.02, 0.03] + rng.normal(0, 0.003, (N, 3))
    bad = rng.uniform(size=N) < outliers
    q[bad] += rng.uniform(-0.5, 0.5, (bad.sum(), 3))
    return p.astype(np.float32), q.astype(np.float32)


def _collinear(rng, N):
    s = rng.uniform(-1, 1, N)[:, None]
    p = (np.array([0.1, 0.2, 2.0]) + s * np.array([0.6, -0.3, 0.2]))
    return p.astype(np.float32), (p + [0.05, 0.0, -0.02]).astype(np.float32)


def _weighted(kind, seed):
    """(p, q, w) numpy float32 of one refit case."""
    rng = np.random.default_rng(seed)
    if kind == "batch":
        ps, qs = zip(*(_scene(rng, 700) for _ in range(3)))
        return (np.stack(ps), np.stack(qs),
                (rng.uniform(size=(3, 700)) < 0.7).astype(np.float32))
    if kind.startswith("N"):                  # "N<points>_B<rows>"
        N, B = (int(v) for v in kind[1:].split("_B"))
        ps, qs = zip(*(_scene(rng, N) for _ in range(B)))
        w = (rng.uniform(size=(B, N)) < 0.6).astype(np.float32)
        if B > 1:                             # an all-zero row, a dense one
            w[1] = 0.0
            w[2] = (rng.uniform(size=N) < 0.95).astype(np.float32)
        return np.stack(ps), np.stack(qs), w
    N = {"loop_closure_128": 128, "unstaged_1500": 1500}.get(kind, 512)
    p, q = _collinear(rng, N) if kind == "collinear" else _scene(rng, N)
    w = (rng.uniform(size=N) < 0.6).astype(np.float32)
    if kind == "zero_weights":
        w[:] = 0.0
    elif kind in ("three_equal_points", "two_valid"):
        w[:] = 0.0
        on = [4, 9, 100] if kind == "three_equal_points" else [17, 300]
        w[on] = 1.0
        if kind == "three_equal_points":
            p[on], q[on] = p[4], q[4]
    return p, q, w


# unstaged_1500: more points than the kernel stages in shared memory;
# N<n>_B<b>: the edges of the warps' split of the sums (the lanes and the
# cascade's blocks: 8, 32, 64, 512 points and one on either side; 1024 =
# kStaged), each with 0/1 weights in one row, and in three rows the second
# all-zero
WEIGHTED = ["matches_512", "loop_closure_128", "unstaged_1500", "batch",
            "zero_weights", "three_equal_points", "collinear", "two_valid"] \
    + [f"N{N}_B{B}" for N in (1, 7, 8, 31, 32, 33, 64, 65, 511, 512, 513,
                              1024, 1025, 2051) for B in (1, 3)]


@pytest.mark.parametrize("kind", WEIGHTED)
def test_refit_equals_plain_bit_for_bit(cuda, kind):
    p, q, w = (torch.from_numpy(x).to(cuda)
               for x in _weighted(kind, 10 + WEIGHTED.index(kind)))
    kabsch._LIB.reset_launch_count()
    got = kabsch.weighted_kabsch(p, q, w)
    assert kabsch._LIB.launch_count() == 1
    ref = kabsch.plain_weighted_kabsch(p, q, w)
    torch.cuda.synchronize()
    assert got.shape == p.shape[:-2] + (7,)
    assert torch.equal(got, ref)
    assert bool(torch.isfinite(got).all())


def test_refuses_what_it_does_not_take(cuda):
    p, q, w = (torch.from_numpy(x).to(cuda)
               for x in _weighted("matches_512", 3))
    with pytest.raises(ValueError, match="float32"):
        kabsch.weighted_kabsch(p.double(), q.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        kabsch.weighted_kabsch(p.t().contiguous().t(), q, w)
    with pytest.raises(ValueError, match=r"w \(511,\)"):
        kabsch.weighted_kabsch(p, q, w[:-1])


def _capture(fn):
    """Warm ``fn`` up on a side stream (launches not counted), then capture
    it; returns the graph and what the capture returned."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), cuda_lib.uncounted():
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    body_pool = torch.cuda.MemPool()
    _capture.pools.append(body_pool)
    graph_cond.prepare("cuda", body_pool)
    with torch.cuda.graph(graph), control.branching("capture"):
        out = fn()
    return graph, out


_capture.pools = []      # each graph's body pool lives as long as the module


def test_replayed_from_a_graph_and_an_if_body(cuda):
    outer = [torch.from_numpy(x).to(cuda) for x in _weighted("batch", 5)]
    p, q, w = (torch.from_numpy(x).to(cuda)
               for x in _weighted("matches_512", 6))
    eager = (kabsch.weighted_kabsch(*outer), kabsch.weighted_kabsch(p, q, w))
    pred = torch.zeros((), dtype=torch.bool, device=cuda)
    direct = torch.zeros((3, 7), device=cuda)
    body = torch.zeros((7,), device=cuda)

    def frame():
        direct.copy_(kabsch.weighted_kabsch(*outer))
        control.cond(pred, lambda: kabsch.weighted_kabsch(p, q, w), body)

    kabsch._LIB.reset_launch_count()
    graph, _ = _capture(frame)
    assert kabsch._LIB.launch_count() == 0        # warm-up uncounted, capture
    for on in (False, True, True):           # records, runs nothing
        body.fill_(-1.0)
        direct.zero_()
        pred.fill_(on)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(direct, eager[0])
        if on:
            assert torch.equal(body, eager[1])
        else:
            assert torch.equal(body, torch.full_like(body, -1.0))
    # one launch a replay outside the body, one in each replay that ran it
    assert kabsch._LIB.launch_count() == 3 + 2


def test_estimate_repeats_itself_eager_and_replayed(cuda):
    """``ransac.estimate`` at the fr1 widths (1024 hypotheses, two refits,
    512 matches), twice eagerly and once replayed: the same bits, a refit
    launch a refit iteration (the sampled fit is ``csrc/ransac_score.cu``'s
    launch, ``tests/test_torch_ransac_score_cuda.py``)."""
    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.frontend import ransac

    cfg = tum_fr1_config().ransac
    rng = np.random.default_rng(7)
    p, q = (torch.from_numpy(x).to(cuda) for x in _scene(rng, 512))
    valid = torch.as_tensor(rng.uniform(size=512) > 0.1, device=cuda)
    u = torch.as_tensor(rng.uniform(size=(cfg.used_pairs, cfg.n_hypotheses)),
                        dtype=torch.float32, device=cuda)

    def call():
        return ransac.estimate(cfg, None, p, q, valid, u=u)

    kabsch._LIB.reset_launch_count()
    first = call()
    assert kabsch._LIB.launch_count() == cfg.refit_iterations
    graph, replayed = _capture(call)
    graph.replay()
    torch.cuda.synchronize()
    for res in (call(), replayed):
        for a, b in zip(first, res):
            assert torch.equal(a, b)
    assert bool(first.ok)
