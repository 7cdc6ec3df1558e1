"""The pose-pose edge terms (``ops/pp_edge.py``) on the CPU: the plain
version is the solvers' former ATen chain bit for bit (on made graphs
across both Taylor windows, every robust kernel, with and without
generations, and on every call of a BA of the tiny slice), the CPU never
reaches the kernel, the wrapper refuses what the kernel does not take, and
the roofline's counts and metric. The kernel itself runs only on the card
(``test_torch_pp_edge_cuda.py``)."""

import dataclasses

import pytest
import torch
from _pp_edge_cases import bits, make

from putslam_tpu_torch.backend import factors
from putslam_tpu_torch.backend import optimize as opt
from putslam_tpu_torch.config import tiny_test_config, tum_fr1_config
from putslam_tpu_torch.io import synthetic
from putslam_tpu_torch.models import slam
from putslam_tpu_torch.ops import pp_edge

FIELDS = ("r6", "Ji", "Jj", "wpp", "sq_pp")
ROBUST = (("cauchy", 1.0), ("huber", 0.7), ("none", 1.0), ("cauchy", 0.3))


def former_pp_terms(bcfg, g, kf_pose, kf_gen):
    """``backend/optimize.py::_pp_terms`` and ``_pp_gate`` before the
    kernel, as they were."""
    pi = kf_pose[g.pp_i]
    pj = kf_pose[g.pp_j]
    r6 = factors.pp_residual(pi, pj, g.pp_rel)
    Ji, Jj = factors.pp_jacobians(pi, pj, g.pp_rel)
    gate = g.pp_valid
    if kf_gen is not None:
        gate = gate & (g.pp_gen_i == kf_gen[g.pp_i]) \
            & (g.pp_gen_j == kf_gen[g.pp_j])
    wpp_info = g.pp_w * gate
    sq_pp = wpp_info * torch.sum(r6 * r6, dim=-1)
    wpp = wpp_info * factors.robust_weight(sq_pp, bcfg.robust_kernel,
                                           bcfg.robust_delta)
    return r6, Ji, Jj, wpp, sq_pp


def assert_same(got, ref, what):
    for name, x, y in zip(FIELDS, got, ref):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        assert torch.equal(bits(x), bits(y)), f"{what}: {name}"


def bcfg_of(kind, delta):
    return dataclasses.replace(tiny_test_config().backend,
                               robust_kernel=kind, robust_delta=delta)


@pytest.mark.parametrize("E, K, seed", [(64, 16, 1), (1024, 256, 2)])
@pytest.mark.parametrize("kind, delta", ROBUST)
@pytest.mark.parametrize("with_gen", [True, False])
def test_plain_terms_is_the_former_chain(E, K, seed, kind, delta, with_gen):
    g, kf_pose, kf_gen = make(E, K, seed)
    kg = kf_gen if with_gen else None
    bcfg = bcfg_of(kind, delta)
    ref = former_pp_terms(bcfg, g, kf_pose, kg)
    assert_same(pp_edge.plain_terms(g, kf_pose, kg, kind, delta), ref,
                "plain_terms")
    assert_same(opt._pp_terms(bcfg, g, kf_pose, kg), ref, "_pp_terms")
    live = pp_edge.gate(g, kg)
    assert 0 < int(live.sum()) < E
    assert bool((ref[3][~live] == 0).all() and (ref[4][~live] == 0).all())


def test_cpu_takes_the_plain_version(monkeypatch):
    """On the CPU ``_pp_terms`` calls ``plain_terms`` and never ``terms``."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel's call on the CPU")

    calls = []
    real = pp_edge.plain_terms
    monkeypatch.setattr(pp_edge, "terms", no_kernel)
    monkeypatch.setattr(pp_edge, "_launch", no_kernel)
    monkeypatch.setattr(pp_edge, "plain_terms",
                        lambda *a: calls.append(a[3:]) or real(*a))
    g, kf_pose, kf_gen = make(64, 16, 3)
    bcfg = bcfg_of("huber", 0.5)
    assert_same(opt._pp_terms(bcfg, g, kf_pose, kf_gen),
                former_pp_terms(bcfg, g, kf_pose, kf_gen), "_pp_terms")
    assert calls == [("huber", 0.5)]


def test_terms_refuses_the_cpu():
    g, kf_pose, kf_gen = make(64, 16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pp_edge.terms(g, kf_pose, kf_gen, "cauchy", 1.0)


def test_the_slices_ba_meets_the_kernels_contract(monkeypatch):
    """Every pose-pose call of the tiny slice's in-loop BAs (every tracked
    frame a keyframe, BA every second keyframe), of one more BA and of
    ``finalize`` on its last state, one live edge added: its inputs pass
    ``check_inputs`` and the plain version gives the former chain's
    bits."""
    from putslam_tpu_torch.backend import graph as graph_mod
    from putslam_tpu_torch.geometry import se3

    cfg = tiny_test_config()
    cfg = cfg.replace(
        map=dataclasses.replace(cfg.map, min_keyframe_matches=10_000),
        backend=dataclasses.replace(cfg.backend, optimize_every_n_frames=2,
                                    final_gn_iterations=2))
    seen = []
    real = pp_edge.plain_terms

    def plain_terms(g, kf_pose, kf_gen, kind, delta):
        pp_edge.check_inputs(g, kf_pose, kf_gen, kind)
        out = real(g, kf_pose, kf_gen, kind, delta)
        assert_same(out, former_pp_terms(bcfg_of(kind, delta), g, kf_pose,
                                         kf_gen), f"call {len(seen)}")
        seen.append(int(pp_edge.gate(g, kf_gen).sum()))
        return out

    monkeypatch.setattr(pp_edge, "plain_terms", plain_terms)
    poses = synthetic.orbit_trajectory(8, radius=0.10, yaw_amp=0.1)
    gr, d = synthetic.render_sequence(cfg.camera, poses)
    state = slam.slam_init(cfg, gr[0], d[0], poses[0])
    gen = torch.Generator().manual_seed(2)
    for i in range(1, 8):
        state, _ = slam.slam_step(cfg, state, gr[i], d[i], generator=gen)
    m = state.map
    last = torch.remainder(m.n_kf - 1, m.kf_valid.shape[0]).to(torch.int32)
    first = torch.zeros((), dtype=torch.int32)
    g = graph_mod.add_pose_pose(
        state.graph, first, last,
        se3.relative(m.kf_pose[0], m.kf_pose[last.long()]),
        torch.full((), 100.0), True, gen_i=m.kf_gen[0],
        gen_j=m.kf_gen[last.long()])
    state = state._replace(graph=g)
    n = len(seen)
    slam.bundle_adjust(cfg, m, g)
    assert len(seen) == n + cfg.backend.gn_iterations
    slam.finalize(cfg, state, graph=False)
    assert len(seen) > n + cfg.backend.gn_iterations
    assert min(seen[n:]) > 0


def _bad_inputs():
    g, kf_pose, kf_gen = make(64, 16, 5)
    meta = torch.device("meta")
    yield "robust kind", (g, kf_pose, kf_gen, "tukey")
    yield "device", (g._replace(pp_w=g.pp_w.to(meta)), kf_pose, kf_gen,
                     "cauchy")
    yield "kf_gen device", (g, kf_pose, kf_gen.to(meta), "cauchy")
    yield "pose dtype", (g, kf_pose.double(), kf_gen, "cauchy")
    yield "index dtype", (g._replace(pp_i=g.pp_i.long()), kf_pose, kf_gen,
                          "cauchy")
    yield "generation dtype", (g, kf_pose, kf_gen.long(), "cauchy")
    yield "valid dtype", (g._replace(pp_valid=g.pp_valid.int()), kf_pose,
                          kf_gen, "cauchy")
    yield "pose shape", (g, kf_pose[:, :6].contiguous(), kf_gen, "cauchy")
    yield "no keyframe", (g, kf_pose[:0], kf_gen[:0], "cauchy")
    yield "weight shape", (g._replace(pp_w=g.pp_w[1:]), kf_pose, kf_gen,
                           "cauchy")
    yield "kf_gen shape", (g, kf_pose, kf_gen[1:], "cauchy")
    yield "no slot", (g._replace(pp_i=g.pp_i[:0]), kf_pose, kf_gen,
                      "cauchy")
    yield "relative contiguous", (g._replace(
        pp_rel=g.pp_rel.t().contiguous().t()), kf_pose, kf_gen, "cauchy")
    yield "pose contiguous", (g, torch.zeros((16, 8))[:, :7], kf_gen,
                              "cauchy")


@pytest.mark.parametrize("name, args", list(_bad_inputs()),
                         ids=[n for n, _ in _bad_inputs()])
def test_wrong_input_raises(name, args):
    with pytest.raises(ValueError):
        pp_edge.check_inputs(*args)


def test_good_input_passes():
    g, kf_pose, kf_gen = make(1024, 256, 6)
    pp_edge.check_inputs(g, kf_pose, kf_gen, "cauchy")
    pp_edge.check_inputs(g, kf_pose, None, "none")


def test_robust_floats():
    assert pp_edge.robust_floats(1.0) == (1.0, 1.0)
    delta, inv = pp_edge.robust_floats(0.1)
    assert delta == float(torch.tensor(0.1, dtype=torch.float32))
    d2 = torch.tensor(0.1 * 0.1, dtype=torch.float32)
    assert inv == float(torch.reciprocal(d2))


def test_roofline_counts():
    from slambench import spec

    roof = spec.load_module("roofline", "pp_edge")
    cfg = tum_fr1_config()
    ops, nbytes = roof.counts(cfg)
    E = cfg.backend.max_pose_pose_edges
    assert E == 1024
    assert nbytes == 443_392 == 433 * E
    assert (roof.READ_PER_SLOT, roof.WRITTEN_PER_SLOT) == (113, 320)
    assert ops == 1550 * E
    assert ops / 67e12 < nbytes / 3.35e12      # the bound is the bytes
    ops_t, bytes_t = roof.counts(tiny_test_config())
    assert bytes_t == 433 * tiny_test_config().backend.max_pose_pose_edges


class _Trace:
    def __init__(self, ops):
        self.ops = ops

    def kernel_durations_s(self, fragment):
        return [d * 1e-9 for n, _, d in self.ops if fragment in n]


def test_roofline_metric():
    from slambench import spec

    read = spec.load_module("metrics", "pp_edge_roofline").read
    cfg = tum_fr1_config()
    ops = [("(anonymous namespace)::pp_edge_kernel(Params)", 0, 4_000),
           ("(anonymous namespace)::pp_edge_kernel(Params)", 0, 6_000),
           ("guided_match_kernel(Params)", 0, 5_000)]
    want = 100 * 443_392 / 3.35e12 / 5e-6
    assert read(dict(trace=_Trace(ops), cfg=cfg)) == pytest.approx(
        want, rel=1e-12)
    assert read(dict(trace=_Trace(ops[2:]), cfg=cfg)) is None
