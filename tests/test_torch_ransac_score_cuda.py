"""RANSAC's hypotheses and scores as the hand-written kernel
(``csrc/ransac_score.cu``) on the card.

The kernel against its plain version on the card, bit for bit: the
hypotheses mode (the sampled fit of 1024 hypotheses over 512 matches, the
inlier rows, counts and masked error sums) for each error model (0-4, and
3 with and without information matrices); with no valid match, all valid,
N not a multiple of 32, one, three and five hypotheses (fewer than a
block's warps), 4 samples a hypothesis (the run-time sample count), N at
and above the shared-memory stage; the score mode at B = 1 (the refit's),
3 and 8. One launch a call, counted by mode,
twice the same. Replayed from a CUDA graph it gives the eager bits, and a
launch inside a conditional node's body counts only where the card runs
the body. Wrong dtypes, shapes and non-contiguous input raise. Then
``ransac.estimate`` at the fr1 widths: one hypotheses launch and one score
launch a refit, the same bits eager, twice, and replayed.

Needs a CUDA card and skips without one. Imports no JAX, so on the machine
with the card it runs as:
python -m pytest tests/test_torch_ransac_score_cuda.py --noconftest -q"""

import dataclasses

import numpy as np
import pytest
import torch

from putslam_tpu_torch.config import tum_fr1_config
from putslam_tpu_torch.frontend import ransac
from putslam_tpu_torch.ops import kabsch, ransac_score
from putslam_tpu_torch.utils import control, cuda_lib, graph_cond

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _scene(rng, N, outliers=0.3):
    """(p, q, valid) numpy: N points about 2 m ahead, q a rigid motion of p
    plus noise, a share of the pairs moved off, 10 % invalid; a few depths
    at 0, where the reprojection models clamp them."""
    p = rng.uniform(-1, 1, (N, 3)) + [0.0, 0.0, 2.0]
    a = 0.05
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]])
    q = p @ R.T + [0.05, -0.02, 0.03] + rng.normal(0, 0.003, (N, 3))
    bad = rng.uniform(size=N) < outliers
    q[bad] += rng.uniform(-0.5, 0.5, (bad.sum(), 3))
    p[:2, 2] = 0.0
    q[2:4, 2] = 0.0
    return (p.astype(np.float32), q.astype(np.float32),
            rng.uniform(size=N) > 0.1)


def _infos(rng, N):
    Q, _ = np.linalg.qr(rng.normal(size=(N, 3, 3)))
    sig = rng.uniform(0.003, 0.01, (N, 3))
    info = np.einsum("nij,nj,nkj->nik", Q, 1.0 / sig ** 2, Q)
    return (0.5 * (info + np.swapaxes(info, -1, -2))).astype(np.float32)


# (error_version, information matrices, N, H, samples, valid: "some" /
# "none" / "all"); N 1025, 1500 and 2051 are above the stage (1024
# matches); fewer hypotheses than a block's 8 warps split the warps
# (1: all eight on it, 3: two each, 5: one each)
CASES = {
    "v0": (0, False, 512, 1024, 3, "some"),
    "v1": (1, False, 512, 1024, 3, "some"),
    "v2": (2, False, 512, 1024, 3, "some"),
    "v3": (3, False, 512, 1024, 3, "some"),
    "v3_info": (3, True, 512, 1024, 3, "some"),
    "v4": (4, False, 512, 1024, 3, "some"),
    "no_valid_match": (0, False, 512, 1024, 3, "none"),
    "all_valid": (0, False, 512, 1024, 3, "all"),
    "N_37": (0, False, 37, 1024, 3, "some"),
    "N_500": (4, False, 500, 1024, 3, "some"),
    "one_hypothesis": (0, False, 512, 1, 3, "some"),
    "three_hypotheses": (1, False, 512, 3, 3, "some"),
    "five_hypotheses": (4, False, 512, 5, 3, "some"),
    "four_samples": (0, False, 512, 1024, 4, "some"),
    "N_1024_staged": (0, False, 1024, 256, 3, "some"),
    "unstaged_1025": (2, False, 1025, 256, 3, "some"),
    "unstaged_1500": (0, False, 1500, 256, 3, "some"),
    "unstaged_2051_v3_info": (3, True, 2051, 64, 3, "some"),
}


def _case(kind, dev):
    """(model, p, q, valid, info, idx) of one case on ``dev``."""
    version, with_info, N, H, k, which = CASES[kind]
    rng = np.random.default_rng(sorted(CASES).index(kind))
    p, q, valid = _scene(rng, N)
    if which != "some":
        valid[:] = which == "all"
    info = torch.from_numpy(_infos(rng, N)).to(dev) if with_info else None
    cfg = dataclasses.replace(
        tum_fr1_config().ransac, error_version=version,
        inlier_threshold_mahalanobis=9.0 if with_info else 4e-4)
    model = ransac_score.model_of(cfg, tum_fr1_config().camera)
    idx = torch.from_numpy(rng.integers(0, N, (k, H))).to(dev)
    return (model,) + tuple(torch.from_numpy(x).to(dev)
                            for x in (p, q, valid)) + (info, idx)


def _equal(got, ref, what):
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        assert torch.equal(a, b), (what, float((a.float() - b.float())
                                               .abs().max()))


@pytest.mark.parametrize("kind", sorted(CASES))
def test_hypotheses_equal_plain_bit_for_bit(cuda, kind):
    model, p, q, valid, info, idx = _case(kind, cuda)
    ransac_score._LIB.reset_launch_count()
    got = ransac_score.hypotheses(p, q, valid, idx, model, info)
    again = ransac_score.hypotheses(p, q, valid, idx, model, info)
    assert ransac_score._LIB.launch_counts() == {
        "ransac_score.hypotheses": 2, "ransac_score.score": 0}
    ref = ransac_score.plain_hypotheses(p, q, valid, idx, model, info)
    torch.cuda.synchronize()
    _equal(got, ref, kind)
    _equal(again, got, kind)
    assert got[0].shape == (idx.shape[1], 7)
    assert bool(torch.isfinite(got[0]).all())
    if CASES[kind][5] == "none":
        assert int(got[2].max()) == 0


@pytest.mark.parametrize("kind", ["v0", "v2", "v3_info", "v4", "N_37",
                                  "unstaged_1500"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_score_equals_plain_bit_for_bit(cuda, kind, B):
    model, p, q, valid, info, idx = _case(kind, cuda)
    T = ransac_score.plain_hypotheses(p, q, valid, idx, model, info)[0][:B]
    T = T.contiguous()
    ransac_score._LIB.reset_launch_count()
    got = ransac_score.score(T, p, q, valid, model, info)
    assert ransac_score._LIB.launch_counts() == {
        "ransac_score.hypotheses": 0, "ransac_score.score": 1}
    _equal(got, ransac_score.plain_score(T, p, q, valid, model, info), kind)
    assert got[0].shape == (B, p.shape[0])


def test_refuses_what_it_does_not_take(cuda):
    model, p, q, valid, info, idx = _case("v0", cuda)
    with pytest.raises(ValueError, match="float32"):
        ransac_score.hypotheses(p.double(), q, valid, idx, model)
    with pytest.raises(ValueError, match="contiguous"):
        ransac_score.hypotheses(p.t().contiguous().t(), q, valid, idx, model)
    with pytest.raises(ValueError, match="bool"):
        ransac_score.hypotheses(p, q, valid.float(), idx, model)
    with pytest.raises(ValueError, match="int64"):
        ransac_score.hypotheses(p, q, valid, idx.int(), model)
    with pytest.raises(ValueError, match=r"q \(511, 3\)"):
        ransac_score.hypotheses(p, q[:-1], valid, idx, model)
    with pytest.raises(ValueError, match="info"):
        ransac_score.hypotheses(p, q, valid, idx, model,
                                torch.zeros((512, 9), device=cuda))
    with pytest.raises(ValueError, match=r"needs \(B, 7\)"):
        ransac_score.score(torch.zeros(7, device=cuda), p, q, valid, model)


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
    model, p, q, valid, info, idx = _case("v0", cuda)
    eager = ransac_score.hypotheses(p, q, valid, idx, model)
    T1 = eager[0][:1].contiguous()
    eager_score = ransac_score.score(T1, p, q, valid, model)
    pred = torch.zeros((), dtype=torch.bool, device=cuda)
    direct = torch.zeros_like(eager[2])
    body = torch.zeros_like(eager_score[1])

    def frame():
        direct.copy_(ransac_score.hypotheses(p, q, valid, idx, model)[2])
        control.cond(pred, lambda: ransac_score.score(T1, p, q, valid,
                                                      model)[1], body)

    ransac_score._LIB.reset_launch_count()
    graph, _ = _capture(frame)
    assert ransac_score._LIB.launch_count() == 0   # warm-up uncounted, capture
    for on in (False, True, True):            # records, runs nothing
        body.fill_(-1)
        direct.zero_()
        pred.fill_(on)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(direct, eager[2])
        if on:
            assert torch.equal(body, eager_score[1])
        else:
            assert torch.equal(body, torch.full_like(body, -1))
    # one launch a replay outside the body, one in each replay that ran it
    assert ransac_score._LIB.launch_counts() == {
        "ransac_score.hypotheses": 3, "ransac_score.score": 2}


def test_estimate_is_one_hypotheses_launch_and_a_score_a_refit(cuda):
    """``ransac.estimate`` at the fr1 widths (1024 hypotheses, two refits,
    512 matches): one hypotheses launch, one score launch and one refit a
    refit iteration, no sampled fit of ``kabsch_fit``; twice eagerly and
    once replayed, the same bits."""
    cfg = tum_fr1_config().ransac
    rng = np.random.default_rng(7)
    p, q, valid = (torch.from_numpy(x).to(cuda) for x in _scene(rng, 512))
    u = torch.as_tensor(rng.uniform(size=(cfg.used_pairs, cfg.n_hypotheses)),
                        dtype=torch.float32, device=cuda)

    def call():
        return ransac.estimate(cfg, None, p, q, valid, u=u)

    ransac_score._LIB.reset_launch_count()
    kabsch._LIB.reset_launch_count()
    first = call()
    assert ransac_score._LIB.launch_counts() == {
        "ransac_score.hypotheses": 1,
        "ransac_score.score": cfg.refit_iterations}
    assert kabsch._LIB.launch_count() == cfg.refit_iterations
    graph, replayed = _capture(call)
    graph.replay()
    torch.cuda.synchronize()
    for res in (call(), replayed):
        for a, b in zip(first, res):
            assert torch.equal(a, b)
    assert bool(first.ok)
