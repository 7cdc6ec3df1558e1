"""``utils/control.cond`` as a CUDA-graph conditional node, on the card.

A captured IF node replayed with its predicate true and then false gives
the body's result and then leaves ``out`` as it was; three nested levels
(the SLAM frame's is_keyframe → run_ba → Gauss-Newton iteration); a cuBLAS
matmul and the Cholesky factorisation and solve of the bundle adjustment
(and the batched 6×6 inverse of ``pcg``) inside a body; and a captured
tracking-VO step launches the FAST kernel once a replay. Needs a CUDA card
and skips without one. Imports no JAX, so on the machine with the card it
runs as: python -m pytest tests/test_torch_cond_cuda.py --noconftest -q"""

import dataclasses

import pytest
import torch

from putslam_tpu_torch.utils import control, graph_cond

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a conditional graph node has no CPU "
                    "mode)")
    return torch.device("cuda")


_BODY_POOLS = []     # each graph's body pool lives as long as the module


def _capture(fn, pool=None, body_pool=None):
    """Warm ``fn`` up masked on a side stream, then capture it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle() if pool is None else pool
    body_pool = torch.cuda.MemPool() if body_pool is None else body_pool
    _BODY_POOLS.append(body_pool)
    graph_cond.prepare("cuda", body_pool)
    with torch.cuda.graph(graph, pool=pool), control.branching("capture"):
        fn()
    return graph


def _pool_of(t):
    """The memory pool of the allocator segment that holds ``t``."""
    p = t.data_ptr()
    for seg in torch.cuda.memory_snapshot():
        if seg["address"] <= p < seg["address"] + seg["total_size"]:
            return tuple(seg["segment_pool_id"])
    raise AssertionError("no segment holds the tensor")


def test_if_node_runs_then_skips_its_body(cuda):
    pred = torch.zeros((), dtype=torch.bool, device=cuda)
    x = torch.arange(8, dtype=torch.float32, device=cuda)
    out = torch.zeros(8, device=cuda)

    def frame():
        control.cond(pred, lambda: x * 2.0 + 1.0, out)

    graph = _capture(frame)
    out.fill_(-1.0)
    pred.fill_(True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2.0 + 1.0)
    out.fill_(-1.0)
    x.add_(100.0)
    pred.fill_(False)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, -1.0))
    pred.fill_(True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2.0 + 1.0)


def test_allocations_stay_in_the_graph_pool(cuda):
    """Tensors made inside a body come from the body pool, those made in
    the capture after a node from the graph's pool: none from the pool that
    serves code outside the graphs."""
    pred = torch.ones((), dtype=torch.bool, device=cuda)
    x = torch.arange(1 << 16, dtype=torch.float32, device=cuda)
    out = torch.zeros_like(x)
    made = {}

    def frame():
        def body():
            made["in_body"] = x * 3.0
            return made["in_body"] + 1.0

        control.cond(pred, body, out)
        made["after"] = out * 2.0
        control.cond(~pred, lambda: made["after"] - 1.0, out)
        made["after_second"] = out + 5.0

    pool = torch.cuda.graph_pool_handle()
    body_pool = torch.cuda.MemPool()
    graph = _capture(frame, pool, body_pool)
    assert _pool_of(made["in_body"]) == tuple(body_pool.id)
    for name in ("after", "after_second"):
        assert _pool_of(made[name]) == tuple(pool), name
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 3.0 + 1.0)
    assert torch.equal(made["after_second"], out + 5.0)


def test_three_nested_levels(cuda):
    """is_kf → run_ba → each iteration's ~done, with a device carry as the
    Gauss-Newton loop has: every combination of the three predicates."""
    is_kf = torch.zeros((), dtype=torch.bool, device=cuda)
    run_ba = torch.zeros((), dtype=torch.bool, device=cuda)
    stop_at = torch.zeros((), device=cuda)
    src = torch.ones(4, device=cuda)
    out = torch.zeros(4, device=cuda)
    n_iter = 4

    def kf_body():
        acc = src * 10.0
        carry = (acc, torch.zeros((), device=cuda),
                 torch.zeros((), dtype=torch.bool, device=cuda))

        def ba_body():
            x = carry[0].clone()
            k = torch.zeros((), device=cuda)
            done = torch.zeros((), dtype=torch.bool, device=cuda)
            for _ in range(n_iter):
                control.cond(~done, lambda: (x + 1.0, k + 1.0, k + 1.0
                                             >= stop_at), (x, k, done))
            return x, k, done

        control.cond(run_ba, ba_body, carry)
        return carry[0] + carry[1]

    graph = _capture(lambda: control.cond(is_kf, kf_body, out))
    for kf in (False, True):
        for ba in (False, True):
            for stop in (1.0, 3.0, 9.0):
                out.fill_(-5.0)
                is_kf.fill_(kf)
                run_ba.fill_(ba)
                stop_at.fill_(stop)
                graph.replay()
                torch.cuda.synchronize()
                iters = min(stop, n_iter) if ba else 0.0
                want = -5.0 if not kf else 10.0 + 2.0 * iters
                assert torch.equal(out, torch.full_like(out, want)), \
                    (kf, ba, stop, out.tolist())


def test_linear_algebra_in_a_body(cuda):
    """A cuBLAS matmul, ``cholesky_ex`` and two triangular solves on a
    384×384 system (the fr1 reduced camera system of ``dense_schur_mm``, as
    ``backend/optimize.py::_solve_reduced`` solves it) and the batched 6×6
    ``inv_ex`` of ``pcg`` inside an IF body, replayed with the predicate on
    and off. (``torch.cholesky_solve`` is what a body cannot hold: its
    graph fails to instantiate with an invalid argument.)"""
    gen = torch.Generator(device=cuda).manual_seed(0)
    A = torch.randn((384, 384), generator=gen, device=cuda)
    b = torch.randn((384,), generator=gen, device=cuda)
    blocks = torch.randn((256, 6, 6), generator=gen, device=cuda)
    pred = torch.zeros((), dtype=torch.bool, device=cuda)
    out = (torch.zeros((384, 384), device=cuda), torch.zeros(384, device=cuda),
           torch.zeros((256, 6, 6), device=cuda))

    def body():
        S = A @ A.T + 384.0 * torch.eye(384, device=cuda)
        Lc, _ = torch.linalg.cholesky_ex(S)
        y = torch.linalg.solve_triangular(Lc, b[:, None], upper=False)
        x = torch.linalg.solve_triangular(Lc.T, y, upper=True)[:, 0]
        inv = torch.linalg.inv_ex(blocks @ blocks.transpose(1, 2)
                                  + torch.eye(6, device=cuda))[0]
        return S, x, inv

    graph = _capture(lambda: control.cond(pred, body, out))
    S, x, inv = body()
    for leaf in out:
        leaf.zero_()
    pred.fill_(True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], S)
    assert torch.allclose(out[1], x, rtol=1e-5, atol=1e-6)
    assert torch.allclose(out[2], inv, rtol=1e-4, atol=1e-5)
    assert torch.allclose(out[0] @ out[1], b, rtol=1e-3, atol=1e-3)
    for leaf in out:
        leaf.fill_(7.0)
    pred.fill_(False)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(leaf, torch.full_like(leaf, 7.0)) for leaf in out)


def _frames(cfg, n, cuda):
    from putslam_tpu_torch.io import synthetic

    poses = synthetic.orbit_trajectory(n, radius=0.10, yaw_amp=0.1)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    return grays.to(cuda), depths.to(cuda), poses.to(cuda)


def test_captured_tracking_step_launches_fast_once(cuda):
    """The tracking VO replayed from its graph equals the eager chain bit
    for bit, and each replay launches the FAST kernel once (the refill's
    level-0 detection); the warm-up before the capture is not counted."""
    from putslam_tpu_torch.config import tiny_test_config
    from putslam_tpu_torch.models import vo as tvo
    from putslam_tpu_torch.ops import fast_cuda

    cfg = tiny_test_config().replace(vo_version=1)
    grays, depths, poses = _frames(cfg, 6, cuda)
    gens = [torch.Generator(device=cuda).manual_seed(2) for _ in range(2)]
    p_eager, s_eager = tvo.vo_sequence_tracking(
        cfg, grays, depths, generator=gens[0], init_pose=poses[0],
        graph=False)
    before = fast_cuda.fast_score_nms.launches
    p_graph, s_graph = tvo.vo_sequence_tracking(
        cfg, grays, depths, generator=gens[1], init_pose=poses[0])
    torch.cuda.synchronize()
    # frame 0's detection eagerly, then one launch a replayed step
    assert fast_cuda.fast_score_nms.launches - before == grays.shape[0]
    assert torch.equal(p_eager, p_graph)
    for a, b in zip(s_eager, s_graph):
        assert torch.equal(a, b)


def test_captured_slam_frame_follows_eager(cuda):
    """The whole SLAM frame replayed from one graph (keyframes, the BA with
    its Gauss-Newton iterations) at fr1, keyframe-dense, over 10 frames of
    the bench orbit (BA at the 5th and 10th keyframe): the same keyframe
    and BA decisions as the eager step, poses bit-equal before the first BA
    and after it (the BA sums in a fixed order, ``ops/segment.py``)."""
    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.models import slam as tslam

    cfg = tum_fr1_config()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map,
                                              min_keyframe_matches=10_000))
    grays, depths, poses = _frames(cfg, 11, cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    draws = [tslam.frame_draws(cfg, gen, cuda) for _ in range(10)]
    outs = []
    for graph in (False, True):
        state = tslam.slam_init(cfg, grays[0], depths[0], poses[0])
        outs.append(tslam.slam_sequence(cfg, state, grays[1:], depths[1:],
                                        draws=draws, graph=graph)[1])
    eager, graph = outs
    assert torch.equal(eager.is_keyframe, graph.is_keyframe)
    assert torch.equal(eager.ba_ran, graph.ba_ran)
    first = int(torch.nonzero(graph.ba_ran.cpu())[0])
    assert first >= 1
    assert torch.equal(eager.pose[:first], graph.pose[:first])
    assert torch.equal(eager.pose, graph.pose)
