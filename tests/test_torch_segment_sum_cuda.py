"""The hand-written segment-sum kernel (``csrc/segment_sum.cu``) on the
card, and the solvers that sum through it.

The kernel against its plain version (``index_add_`` on the CPU, in
ascending row order) bit for bit at the fr1 shapes of the in-loop BA
(8192 observations into 64 keyframes, 2048 landmarks, and the 65 × 2049
coupling blocks); twice, the same bits; replayed from a CUDA graph and
from inside a conditional node's body, with its launches counted on the
card (a skipped body launches nothing; the warm-up under ``uncounted`` is
not counted). Then ``gauss_newton_mm`` on a keyframe-dense fr1 map with
63 free keyframes (where the bf16-rounded reduced system turns last-bit
differences into other steps, ROADMAP 3ac): run twice eagerly and once
replayed from a graph, three bit-equal results. And the two other
floating-point accumulations of the port that were measured for it:
``geometry/se2.py``'s ``index_put_(accumulate=True)`` and the RANSAC
sampler's ``cumsum`` with ``quality_tau > 0``, each run twice.

Needs a CUDA card and skips without one. Imports no JAX, so on the machine
with the card it runs as:
python -m pytest tests/test_torch_segment_sum_cuda.py --noconftest -q"""

import dataclasses

import numpy as np
import pytest
import torch

from putslam_tpu_torch.ops import segment
from putslam_tpu_torch.ops.segment import SegmentPlan
from putslam_tpu_torch.utils import control, graph_cond

pytestmark = pytest.mark.cuda

M = 8192
# (segments, trailing shape): the keyframe sums (H_cc_diag, b_c), the
# landmark sums (H_ll, b_l) and the coupling G of the fr1 in-loop BA
SHAPES = [(64, (6, 6)), (64, (6,)), (2048, (3, 3)), (2048, (3,)),
          (65 * 2049, (6, 3))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(n, trailing, seed):
    """(x, idx): M rows of mixed magnitude, a tenth of them dropped."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, M)
    idx[rng.uniform(size=M) < 0.1] = n
    x = (rng.standard_normal((M,) + trailing)
         * 10.0 ** rng.integers(-3, 4, (M,) + trailing)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(idx)


def _plain_cpu(x, idx, n):
    return segment.plain_segment_sum(x, SegmentPlan(idx, n))


@pytest.mark.parametrize("n,trailing", SHAPES, ids=str)
def test_kernel_equals_plain_bit_for_bit(cuda, n, trailing):
    x, idx = _rows(n, trailing, seed=n + len(trailing))
    plan = SegmentPlan(idx.to(cuda), n)
    got = plan.sum(x.to(cuda))
    again = plan.sum(x.to(cuda))
    torch.cuda.synchronize()
    ref = _plain_cpu(x, idx, n)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(again, got)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, idx = _rows(64, (6,), seed=1)
    plan = SegmentPlan(idx.to(cuda), 64)
    with pytest.raises(ValueError, match="float32"):
        plan.sum(x.to(cuda).double())
    with pytest.raises(ValueError, match="rows"):
        plan.sum(x[:-1].to(cuda))


def _capture(fn):
    """Warm ``fn`` up masked on a side stream (launches not counted), then
    capture it; returns the graph and what the capture returned."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), segment.uncounted():
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
    n, trailing = 2048, (3, 3)
    x, idx = _rows(n, trailing, seed=5)
    ref = _plain_cpu(x, idx, n)
    xs, ids = x.to(cuda), idx.to(cuda)
    pred = torch.zeros((), dtype=torch.bool, device=cuda)
    out = torch.zeros((n,) + trailing, device=cuda)
    direct = torch.zeros((n,) + trailing, device=cuda)

    def frame():
        direct.copy_(SegmentPlan(ids, n).sum(xs))
        # the plan built inside the body, as the BA builds its plans
        control.cond(pred, lambda: SegmentPlan(ids, n).sum(xs), out)

    segment.reset_launch_count()
    graph, _ = _capture(frame)
    assert segment.launch_count() == 0       # warm-up uncounted, capture
    for on in (False, True, True):           # records, runs nothing
        out.fill_(-1.0)
        direct.zero_()
        pred.fill_(on)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(direct.cpu(), ref)
        if on:
            assert torch.equal(out.cpu(), ref)
        else:
            assert torch.equal(out, torch.full_like(out, -1.0))
    # one launch a replay outside the body, one in each replay that ran it
    assert segment.launch_count() == 3 + 2
    SegmentPlan(ids, n).sum(xs)
    assert segment.launch_count() == 6


def _dense_map(cuda):
    """The port's own fr1 keyframe-dense map after 63 frames of the bench
    orbit, replayed from graphs (64 keyframes)."""
    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.models import slam as tslam

    cfg = tum_fr1_config()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map,
                                              min_keyframe_matches=10_000))
    poses = synthetic.orbit_trajectory(64, radius=0.10, yaw_amp=0.1,
                                       device=cuda)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    state = tslam.slam_init(cfg, grays[0], depths[0], poses[0])
    state, _ = tslam.slam_sequence(cfg, state, grays[1:], depths[1:],
                                   generator=torch.Generator(
                                       device=cuda).manual_seed(0))
    return cfg, state


def test_gauss_newton_mm_repeats_itself_with_63_free_keyframes(cuda):
    from putslam_tpu_torch.backend import optimize as topt

    cfg, state = _dense_map(cuda)
    m, g = state.map, state.graph
    seqs = torch.where(m.kf_valid, m.kf_seq,
                       torch.full_like(m.kf_seq, 2 ** 31 - 1))
    fixed = torch.zeros_like(m.kf_valid)
    fixed[torch.argmin(seqs)] = True
    assert int((m.kf_valid & ~fixed).sum()) == 63
    bcfg = dataclasses.replace(cfg.backend, ba_window=0, gn_iterations=6)

    def solve():
        return topt.gauss_newton_mm(bcfg, m.kf_pose, m.kf_valid, m.lm_pos,
                                    m.lm_valid, g, fixed, lm_gen=m.lm_gen,
                                    kf_gen=m.kf_gen, cam=cfg.camera)

    segment.reset_launch_count()
    eager = [solve(), solve()]
    assert segment.launch_count() > 0
    graph, replayed = _capture(solve)
    graph.replay()
    torch.cuda.synchronize()
    for res in (eager[1], replayed):
        for a, b in zip(eager[0], res):
            assert torch.equal(a, b)
    assert bool(torch.isfinite(eager[0].kf_pose).all())


def test_se2_and_ransac_accumulations_repeat_themselves(cuda):
    """The SE(2) pose graph's sort-based ``index_put_`` accumulation and the
    quality-weighted RANSAC sampler's ``cumsum``, each twice on the same
    inputs: the same bits."""
    from putslam_tpu_torch.config import RansacConfig
    from putslam_tpu_torch.frontend import ransac
    from putslam_tpu_torch.geometry import se2

    # a ring of 256 poses, odometry and closures across it (smoke 17e's)
    k = 256
    ang = torch.linspace(0.0, 2 * np.pi, k + 1, dtype=torch.float64)[:k]
    ring = torch.stack([torch.cos(ang), torch.sin(ang),
                        torch.atan2(torch.cos(ang), -torch.sin(ang))],
                       dim=-1).float().to(cuda)
    ri = torch.cat([torch.arange(k), torch.arange(0, k, 6)]).to(cuda)
    rj = torch.cat([(torch.arange(k) + 1) % k,
                    (torch.arange(0, k, 6) + k // 2) % k]).to(cuda)
    rng = np.random.default_rng(11)
    init = ring + torch.as_tensor(rng.normal(0.0, 0.05, (k, 3)),
                                  dtype=torch.float32, device=cuda)
    fixed = torch.zeros(k, dtype=torch.bool, device=cuda)
    fixed[0] = True
    edges = (ri, rj, se2.relative(ring[ri], ring[rj]),
             torch.full((len(ri),), 50.0, device=cuda))
    runs = [se2.optimize_pose_graph(init, edges, fixed, iterations=8)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)

    cfg = dataclasses.replace(RansacConfig(), quality_tau=0.3)
    N = 512
    valid = torch.as_tensor(rng.uniform(size=N) < 0.8, device=cuda)
    quality = torch.as_tensor(rng.uniform(0.0, 1.0, N), dtype=torch.float32,
                              device=cuda)
    u = torch.as_tensor(rng.uniform(size=(3, 1024)), dtype=torch.float32,
                        device=cuda)
    first = ransac.sample_indices(cfg, valid, u, quality)
    assert torch.equal(ransac.sample_indices(cfg, valid, u, quality), first)
