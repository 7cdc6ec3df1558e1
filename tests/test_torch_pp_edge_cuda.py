"""The pose-pose edge terms as the hand-written kernel (``csrc/pp_edge.cu``)
on the card.

The kernel against the ATen chain it replaces (``pp_edge.plain_terms`` run
on the card), bit for bit in r6, Ji, Jj, wpp and sq_pp: made graphs of 64
and 1,024 slots whose residuals lie inside and outside each Taylor window
and up to θ near π, keyframe and measured quaternions with w < 0, invalid
slots and stale generations, with ``kf_gen`` given and ``None``, each
robust kernel; every slot of a graph exactly at the identity. One counted
launch a call (none under ``cuda_lib.uncounted()``); replayed from a CUDA
graph it gives the eager bits; in the SLAM frame's and ``finalize``'s
graphs one launch a Gauss-Newton iteration run (the recorder's
``gn_iteration`` stamps). On a 702-frame fr1 walk of the bench: an
in-loop BA call and ``finalize`` on its graphs give the chain's bits, one
launch an iteration; three whole walks give the same outputs, maps and
poses with the kernel and with the chain. Wrong input raises
``ValueError``, and the card works on after it.

Needs a CUDA card and skips without one. Imports no JAX, so on the machine
with the card it runs as:
python -m pytest tests/test_torch_pp_edge_cuda.py --noconftest -q"""

import dataclasses

import pytest
import torch
from _pp_edge_cases import bits, make

from putslam_tpu_torch.ops import pp_edge
from putslam_tpu_torch.utils import control, cuda_lib

pytestmark = pytest.mark.cuda

FIELDS = ("r6", "Ji", "Jj", "wpp", "sq_pp")
ROBUST = (("cauchy", 1.0), ("huber", 0.7), ("none", 1.0))
FR1_STOPS = (233, 467)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def assert_same(got, ref, what):
    for name, x, y in zip(FIELDS, got, ref):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        diff = (bits(x) != bits(y)).reshape(-1)
        if diff.any():
            i = int(torch.nonzero(diff)[0])
            raise AssertionError(
                f"{what}: {name} differs at {int(diff.sum())} entries, first "
                f"{i}: {x.reshape(-1)[i].item()!r} against "
                f"{y.reshape(-1)[i].item()!r}")


@pytest.mark.parametrize("E, K, seed", [(64, 16, 1), (64, 4, 2),
                                        (1024, 256, 3), (1024, 64, 4)])
@pytest.mark.parametrize("kind, delta", ROBUST)
@pytest.mark.parametrize("with_gen", [True, False])
def test_kernel_equals_the_aten_chain(cuda, E, K, seed, kind, delta,
                                      with_gen):
    g, kf_pose, kf_gen = make(E, K, seed, device=cuda)
    kg = kf_gen if with_gen else None
    ref = pp_edge.plain_terms(g, kf_pose, kg, kind, delta)
    got = pp_edge.terms(g, kf_pose, kg, kind, delta)
    what = f"E {E} K {K} seed {seed} {kind} gen {with_gen}"
    assert_same(got, ref, what)
    assert_same(pp_edge.terms(g, kf_pose, kg, kind, delta), got,
                f"{what}, twice")
    live = pp_edge.gate(g, kg)
    assert 0 < int(live.sum()) < E


def test_every_slot_at_the_identity(cuda):
    """Poses and measurements all the identity: r = 0 exactly, every
    Taylor branch, the zeros' signs."""
    g, kf_pose, kf_gen = make(64, 8, 5, device=cuda)
    ident = torch.tensor([0, 0, 0, 1, 0, 0, 0.0], device=cuda)
    kf_pose = ident.expand(8, 7).contiguous()
    g = g._replace(pp_rel=ident.expand(64, 7).contiguous())
    for kind, delta in ROBUST:
        assert_same(pp_edge.terms(g, kf_pose, kf_gen, kind, delta),
                    pp_edge.plain_terms(g, kf_pose, kf_gen, kind, delta),
                    f"identity {kind}")


def test_one_counted_launch_a_call(cuda):
    g, kf_pose, kf_gen = make(64, 16, 6, device=cuda)
    pp_edge._LIB.reset_launch_count()
    pp_edge.terms(g, kf_pose, kf_gen, "cauchy", 1.0)
    pp_edge.terms(g, kf_pose, None, "huber", 1.0)
    with cuda_lib.uncounted():
        pp_edge.terms(g, kf_pose, kf_gen, "cauchy", 1.0)
    pp_edge.plain_terms(g, kf_pose, kf_gen, "cauchy", 1.0)
    assert pp_edge._LIB.launch_count() == 2
    assert cuda_lib.launch_counts()["pp_edge"] == 2


def test_replayed_from_a_graph(cuda):
    g0, kf0, gen0 = make(1024, 256, 7, device=cuda)
    buf = (type(g0)(*(t.clone() for t in g0)), kf0.clone(), gen0.clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), cuda_lib.uncounted():
        pp_edge.terms(*buf, "cauchy", 1.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pp_edge.terms(*buf, "cauchy", 1.0)
    pp_edge._LIB.reset_launch_count()
    for seed in (8, 9):
        g, kf_pose, kf_gen = make(1024, 256, seed, device=cuda)
        for dst, src in zip(buf[0], g):
            dst.copy_(src)
        buf[1].copy_(kf_pose)
        buf[2].copy_(kf_gen)
        graph.replay()
        torch.cuda.synchronize()
        assert_same(out, pp_edge.plain_terms(g, kf_pose, kf_gen, "cauchy",
                                             1.0), f"seed {seed} replayed")
    assert pp_edge._LIB.launch_count() == 2


def test_a_launch_a_gauss_newton_iteration_in_the_graphs(cuda):
    """The tiny recorder case from graphs, its ``finalize`` too: one launch
    for each ``gn_iteration`` stamp, in-loop and in ``finalize``."""
    from test_torch_recorder import S, recorder_case

    from putslam_tpu_torch.models import compiled, slam
    from putslam_tpu_torch.utils import timing

    cfg, poses, g, d = recorder_case()
    poses, g, d = poses.to(cuda), g.to(cuda), d.to(cuda)
    with timing.recording(timing.Recorder()) as rec:
        compiled.clear_cache()
        state = slam.slam_init(cfg, g[0], d[0], poses[0], device=cuda)
        pp_edge._LIB.reset_launch_count()
        gen = torch.Generator(device=cuda)
        gen.manual_seed(5)
        state, outs = compiled.run_sequence(cfg, state, g[1:], d[1:],
                                            generator=gen, capture=True)
        in_loop = pp_edge._LIB.launch_count()
        compiled.finalize_runner(cfg, state, True).run(state)
        launches = pp_edge._LIB.launch_count()
        snap = timing.snapshot(rec)
    compiled.clear_cache()
    c = snap["count"][snap["valid"]]
    root = snap["root"][snap["valid"]]
    gn = S["gn_iteration"]
    frames = root == S["frame"]
    assert in_loop == c[frames, gn].sum() > 0
    assert launches == c[:, gn].sum() > in_loop
    assert snap["launches"]["pp_edge"] == launches
    assert int(outs.ba_ran.sum()) > 0


def _fr1_walk(cuda, walk: int, texture: int):
    from test_torch_guided_cuda import _fr1_walk as walk_of

    return walk_of(cuda, walk, texture)


@pytest.fixture(scope="module")
def fr1_states(cuda):
    """The state after frames 233 and 467 of a 702-frame fr1 walk of the
    bench, run from the frame's graph."""
    from putslam_tpu_torch.models import compiled, slam

    cfg, grays, depths, gt = _fr1_walk(cuda, 1, 4321)
    compiled.clear_cache()
    state = slam.slam_init(cfg, grays[0], depths[0], gt[0])
    gen = torch.Generator(device=cuda).manual_seed(3)
    out, k0 = {}, 1
    for k in FR1_STOPS:
        state, _ = compiled.run_sequence(cfg, state, grays[k0:k + 1],
                                         depths[k0:k + 1], generator=gen)
        k0 = k + 1
        out[k] = state
    compiled.clear_cache()
    return cfg, out


class _Chain:
    """``pp_edge.terms`` replaced by the ATen chain inside the block; counts
    the calls."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        self.real = pp_edge.terms

        def chain(*a):
            self.calls += 1
            return pp_edge.plain_terms(*a)

        pp_edge.terms = chain
        return self

    def __exit__(self, *exc):
        pp_edge.terms = self.real


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a, b = (x.contiguous().view(torch.int32 if x.element_size() == 4
                                    else torch.int64) for x in (a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("stop", FR1_STOPS)
def test_an_in_loop_ba_call_on_a_fr1_map(cuda, fr1_states, stop):
    """``bundle_adjust`` on the walk's map and graph, its stop read on the
    host: the kernel's outputs are the chain's, one launch an iteration."""
    from putslam_tpu_torch.models import slam

    cfg, states = fr1_states
    state = states[stop]
    assert int(pp_edge.gate(state.graph, state.map.kf_gen).sum()) > 0
    with control.branching("host"):
        pp_edge._LIB.reset_launch_count()
        got = slam.bundle_adjust(cfg, state.map, state.graph)
        launches = pp_edge._LIB.launch_count()
        with _Chain() as chain:
            ref = slam.bundle_adjust(cfg, state.map, state.graph)
    assert launches == chain.calls >= 1
    for name, a, b in zip(("kf_pose", "lm_pos", "obs_valid", "chi2"), got,
                          ref):
        assert _same_bits(a, b), name


@pytest.mark.parametrize("solver", ["dense_schur_mm", "dense_schur", "pcg"])
def test_finalize_on_a_fr1_map(cuda, fr1_states, solver):
    """``finalize`` eager on the walk's state, each solver: the same bits
    as with the chain, one launch an iteration run."""
    from putslam_tpu_torch.models import slam

    cfg, states = fr1_states
    cfg = cfg.replace(backend=dataclasses.replace(cfg.backend,
                                                  solver=solver))
    state = states[FR1_STOPS[0]]
    pp_edge._LIB.reset_launch_count()
    got = slam.finalize(cfg, state, graph=False)
    launches = pp_edge._LIB.launch_count()
    with _Chain() as chain:
        ref = slam.finalize(cfg, state, graph=False)
    assert launches == chain.calls >= 2
    for name, a, b in zip(got.map._fields, got.map, ref.map):
        assert _same_bits(a, b), f"map.{name}"
    for name, a, b in zip(got.graph._fields, got.graph, ref.graph):
        assert _same_bits(a, b), f"graph.{name}"


def test_wrong_input_raises(cuda):
    g, kf_pose, kf_gen = make(64, 16, 10, device=cuda)
    for args in ((g, kf_pose.cpu(), kf_gen, "cauchy"),
                 (g._replace(pp_rel=g.pp_rel.t().contiguous().t()), kf_pose,
                  kf_gen, "cauchy"),
                 (g, kf_pose, kf_gen.long(), "cauchy"),
                 (g, kf_pose, kf_gen, "tukey")):
        with pytest.raises(ValueError):
            pp_edge.check_inputs(*args)
    with pytest.raises(ValueError):
        pp_edge.terms(g._replace(pp_w=g.pp_w[1:]), kf_pose, kf_gen,
                      "cauchy", 1.0)
    assert_same(pp_edge.terms(g, kf_pose, kf_gen, "cauchy", 1.0),
                pp_edge.plain_terms(g, kf_pose, kf_gen, "cauchy", 1.0),
                "after the refusals")


def _sequence(walk, chain: bool):
    from putslam_tpu_torch.models import compiled, slam

    cfg, grays, depths, gt = walk
    compiled.clear_cache()
    real = pp_edge.terms
    if chain:
        pp_edge.terms = pp_edge.plain_terms
    try:
        state = slam.slam_init(cfg, grays[0], depths[0], gt[0])
        gen = torch.Generator(device=grays.device).manual_seed(11)
        state, outs = compiled.run_sequence(cfg, state, grays[1:],
                                            depths[1:], generator=gen)
        final = slam.finalize(cfg, state)
        torch.cuda.synchronize()
    finally:
        pp_edge.terms = real
        compiled.clear_cache()
    return state, outs, final


@pytest.mark.parametrize("walk", [0, 1, 2])
def test_a_fr1_walk_is_the_same_with_the_chain(cuda, walk):
    """Every output of every frame, the state and the finalized map, bit
    for bit."""
    seq = _fr1_walk(cuda, walk, 777)
    pp_edge._LIB.reset_launch_count()
    state_k, outs_k, final_k = _sequence(seq, chain=False)
    launches = pp_edge._LIB.launch_count()
    state_c, outs_c, final_c = _sequence(seq, chain=True)
    assert pp_edge._LIB.launch_count() == launches
    assert launches > int(outs_k.ba_ran.sum()) > 10
    for name, a, b in zip(outs_k._fields, outs_k, outs_c):
        assert _same_bits(a, b), name
    for tag, x, y in (("map", state_k.map, state_c.map),
                      ("graph", state_k.graph, state_c.graph),
                      ("final map", final_k.map, final_c.map)):
        for name, a, b in zip(x._fields, x, y):
            assert _same_bits(a, b), f"{tag}.{name}"
    assert _same_bits(state_k.pose, state_c.pose)
    assert _same_bits(final_k.pose, final_c.pose)
