"""Guided map matching's kernel (``csrc/guided_match.cu``) written out on
the CPU: a plain model of its algorithm, held against the ATen chain that
``slam_map/features_map.py::guided_match`` runs on the CPU
(``ops/guided_match.py::plain_match``), bit for bit.

The model does what the kernel does, step by step: both descriptor sets
packed into two bit planes (elements > 0 and < 0, from each byte's low and
sign bits; bit j of word k is element 32k + j), the depth,
octave and sphere gates a (landmark, feature) pair, the dot product of the
planes by AND and popcount over the used slots, 0.5·(256 − dot), the
running first minimum and second value over the features in ascending
order, then the acceptance and the count. The sphere gate's norm is a
parameter: here the CPU's ``torch.linalg.vector_norm`` (the card's order is
the kernel's, which ``test_torch_guided_cuda.py`` holds against the card's
norm on 10^7 triples).

Also: the wrapper's contract (what raises), that the CPU never reaches the
kernel, that the slice's real inputs meet the
kernel's contract, the roofline's counts and both new metrics."""


import numpy as np
import pytest
import torch
from _guided_cases import N_SPECIAL, WIDTHS, gates, make

from putslam_tpu_torch.config import tiny_test_config
from putslam_tpu_torch.io import synthetic
from putslam_tpu_torch.models import slam
from putslam_tpu_torch.ops import guided_match as gops
from putslam_tpu_torch.slam_map import features_map as fm


def pack(desc: np.ndarray):
    """(R, 256) int8 ±1 / 0 → the kernel's two bit planes, (R, 8) uint32
    each: bit j of word k is element 32k + j, set in the first plane where
    the element's low bit is set and its sign bit is not (> 0), in the
    second where its sign bit is (< 0)."""
    b = desc.view(np.uint8).reshape(-1, 8, 32).astype(np.uint64)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    sign = b >> np.uint64(7)
    pos = ((b & np.uint64(1)) & (np.uint64(1) - sign)) * weights
    return (pos.sum(-1).astype(np.uint32),
            (sign * weights).sum(-1).astype(np.uint32))


def popc(x):
    return np.bitwise_count(x).astype(np.int64)


def cpu_norm(diff: np.ndarray) -> np.ndarray:
    return torch.linalg.vector_norm(torch.from_numpy(diff), dim=-1).numpy()


def card_norm(diff: np.ndarray) -> np.ndarray:
    """The kernel's norm: the squares rounded, (x² + z²) + y², the
    correctly rounded root (numpy's float32 arithmetic is IEEE)."""
    sq = diff.astype(np.float32) * diff.astype(np.float32)
    return np.sqrt((sq[..., 0] + sq[..., 2]) + sq[..., 1])


def model(lm_cam, lm, feat, g: gops.Gates, norm=cpu_norm):
    """The kernel's algorithm on numpy: (feat_idx, dist, valid,
    n_candidates)."""
    cam = lm_cam.numpy()
    lm_desc, used = lm.lm_desc.numpy(), lm.lm_slot_used.numpy()
    lm_valid, lm_oct = lm.lm_valid.numpy(), lm.lm_octave.numpy()
    xyz, dep = feat.xyz.numpy(), feat.has_depth.numpy()
    oct_, desc = feat.octave.numpy(), feat.desc.numpy()
    L, D, _ = lm_desc.shape
    N = xyz.shape[0]
    lp, ln = (p.reshape(L, D, 8) for p in pack(lm_desc.reshape(L * D, 256)))
    fp, fn = pack(desc)
    radius = np.float32(g.radius)
    inf = np.float32(np.inf)

    # the gates of every pair (the kernel: a lane a feature, a warp a
    # landmark; invalid landmarks and those with no used slot skip them)
    diff = (cam[:, None, :] - xyz[None, :, :]).astype(np.float32)
    gate = (dep[None, :] & (np.abs(lm_oct[:, None] - oct_[None, :])
                            <= g.octave_window)
            & (norm(diff) < radius)
            & (lm_valid & used.any(1))[:, None])
    # each candidate: the dot over a slot's 8 words, 0.5·(256 − dot), the
    # minimum over the used slots
    li, fi = np.nonzero(gate)
    dot = (popc(lp[li] & fp[fi][:, None]) + popc(ln[li] & fn[fi][:, None])
           - popc(lp[li] & fn[fi][:, None])
           - popc(ln[li] & fp[fi][:, None])).sum(-1)
    ham = np.float32(0.5) * (np.float32(256.0) - dot.astype(np.float32))
    ham = np.where(used[li], ham, inf).min(-1)
    d = np.full((L, N), inf, np.float32)
    d[li, fi] = ham
    # the warp's running first minimum and second value, features ascending
    m1 = np.full(L, inf, np.float32)
    m2 = np.full(L, inf, np.float32)
    i1 = np.zeros(L, np.int32)
    for n in range(N):
        x = d[:, n]
        lower = x < m1
        m2 = np.where(lower, m1, np.where(x < m2, x, m2))
        i1 = np.where(lower, n, i1).astype(np.int32)
        m1 = np.where(lower, x, m1)
    found = m1 < inf
    max_dist = np.float32(g.max_dist)
    if g.acceptance == "ratio":
        big = np.float32(1e9)
        best = np.where(found, m1, big)
        second = np.where(m2 < inf, m2, big)
        distinct = (best <= np.float32(g.accept_ratio) * second) \
            | (second >= big)
        ok = (best < big) & (best <= max_dist) & distinct
    else:
        best = m1
        ok = found & (best <= max_dist)
    return i1, np.where(ok, best, inf), ok, np.int32(found.sum())


def assert_equal(got, ref, what):
    names = ("feat_idx", "dist", "valid", "n_candidates")
    for name, x, y in zip(names, got, ref):
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        bad = np.flatnonzero(np.atleast_1d(x != y))
        assert not len(bad), (f"{what}: {name} differs at {len(bad)} "
                              f"landmarks, first {bad[0]}: "
                              f"{np.atleast_1d(x)[bad[0]]} against "
                              f"{np.atleast_1d(y)[bad[0]]}")


CASES = [(w, seed, scale, slack, acc, 0)
         for w, seed in (("tiny", 1), ("tiny", 2), ("fr1", 3))
         for scale, slack in ((1.0, 0.0), (2.0, 0.0), (4.0, 8.0))
         for acc in ("hamming", "ratio")] + [
    ("tiny", 1, 2.0, 0.0, "ratio", 2), ("tiny", 2, 2.0, 0.0, "ratio", 6)]


@pytest.mark.parametrize("width, seed, scale, slack, acceptance, views",
                         CASES)
def test_model_equals_the_aten_chain(width, seed, scale, slack, acceptance,
                                     views):
    lm_cam, lm, feat = make(width, seed, scale=scale, slack=slack,
                            views=views)
    g = gates(scale, slack, acceptance)
    ref = gops.plain_match(lm_cam, lm, feat, g)
    got = model(lm_cam, lm, feat, g)
    assert_equal(got, ref, f"{width} seed {seed} x{scale} +{slack}")
    # the inputs reach what they are there for
    found = np.isfinite(ref[1].numpy())
    assert 0 < int(ref[2].sum()) < len(found)
    assert int(ref[3]) > int(ref[2].sum())


@pytest.mark.parametrize("acceptance", ["hamming", "ratio"])
@pytest.mark.parametrize("scale", [1.0, 2.0, 4.0])
def test_the_hand_placed_landmarks(scale, acceptance):
    """Landmarks 0-5: the only candidate at the Hamming gate − 1, at it,
    + 1 (accepted, accepted, refused); 6-11: a distance-0 feature at the
    radius − 1 ulp, at it, + 1 ulp (inside, outside, outside); 12-23: the
    octave one past the window (no candidate). The card's norm decides
    these the same way."""
    lm_cam, lm, feat = make("tiny", 7, scale=scale)
    g = gates(scale, 0.0, acceptance)
    idx, dist, ok, _ = gops.plain_match(lm_cam, lm, feat, g)
    ok = ok.numpy()
    dist = dist.numpy()
    if acceptance == "hamming":    # the ratio test may refuse 63 or 64
        assert ok[:4].all() and not ok[4:6].any()
        assert (dist[:2] == 63).all() and (dist[2:4] == 64).all()
    assert ok[6:8].all() and (dist[6:8] == 0).all() and not ok[8:12].any()
    assert not ok[12:N_SPECIAL].any()
    assert_equal(model(lm_cam, lm, feat, g, norm=card_norm),
                 gops.plain_match(lm_cam, lm, feat, g),
                 f"card norm x{scale}")


def test_ties_go_to_the_first_feature():
    """Duplicate features (same point, octave and descriptor) tie at a
    distance of 20; the first index wins in both, and the ratio test
    refuses the pair (20 > 0.55 · 20)."""
    lm_cam, lm, feat = make("tiny", 4)
    xyz = feat.xyz.clone()
    desc = feat.desc.clone()
    xyz[11] = xyz[10]
    desc[11] = desc[10]
    feat = feat._replace(xyz=xyz, desc=desc,
                         octave=feat.octave.clone().index_fill_(
                             0, torch.tensor([11]), int(feat.octave[10])),
                         has_depth=feat.has_depth.clone().index_fill_(
                             0, torch.tensor([10, 11]), True))
    cam = lm_cam.clone()
    cam[30] = xyz[10]
    lm_desc = lm.lm_desc.clone()
    lm_desc[30, 0] = desc[10]
    lm_desc[30, 0, :20] *= -1          # both at distance 20
    lm = lm._replace(lm_desc=lm_desc, lm_valid=lm.lm_valid.clone()
                     .index_fill_(0, torch.tensor([30]), True),
                     lm_slot_used=lm.lm_slot_used.clone().index_fill_(
                         0, torch.tensor([30]), True),
                     lm_octave=lm.lm_octave.clone().index_fill_(
                         0, torch.tensor([30]), int(feat.octave[10])))
    for acceptance in ("hamming", "ratio"):
        g = gates(acceptance=acceptance)
        ref = gops.plain_match(cam, lm, feat, g)
        assert int(ref[0][30]) == 10
        assert bool(ref[2][30]) == (acceptance == "hamming")
        assert_equal(model(cam, lm, feat, g), ref, acceptance)


def test_all_landmarks_valid():
    lm_cam, lm, feat = make("fr1", 5, all_valid=True)
    g = gates()
    assert_equal(model(lm_cam, lm, feat, g), gops.plain_match(lm_cam, lm,
                                                              feat, g),
                 "every landmark valid")


def test_packing_counts_the_differing_bits():
    """The plane product is the dot of ±1 / 0 rows (for ±1 rows 256 −
    2·Hamming): the planes hold every element once, in order."""
    rng = np.random.default_rng(0)
    a = rng.choice(np.array([-1, 1], np.int8), (64, 256))
    b = rng.choice(np.array([-1, 0, 1], np.int8), (64, 256))
    (ap, an), (bp, bn) = pack(a), pack(b)
    dot = (popc(ap & bp) + popc(an & bn) - popc(ap & bn)
           - popc(an & bp)).sum(-1)
    assert np.array_equal(dot, (a.astype(np.int64) * b).sum(-1))
    assert np.array_equal(popc(ap ^ pack(-a)[0]).sum(-1), np.full(64, 256))
    assert np.array_equal(popc(ap).sum(-1), (a > 0).sum(-1))


def test_card_norm_is_exact_on_one_axis():
    """A difference along one axis has the norm of that axis in any
    order: the radius ± 1 ulp cases do not depend on the order."""
    r = np.float32(0.12)
    for x in (np.nextafter(r, np.float32(0)), r, np.nextafter(r, np.float32(1))):
        for k in range(3):
            v = np.zeros((1, 3), np.float32)
            v[0, k] = x
            assert card_norm(v)[0] == x == cpu_norm(v)[0]


def test_cpu_takes_the_aten_chain(monkeypatch):
    """On the CPU ``match`` is ``plain_match`` and never the launch; the
    map's ``guided_match`` makes one call of ``match``."""
    def no_launch(*a, **k):
        raise AssertionError("the kernel's launch on the CPU")

    monkeypatch.setattr(gops, "_launch", no_launch)
    lm_cam, lm, feat = make("tiny", 6)
    g = gates()
    assert_equal(gops.match(lm_cam, lm, feat, g),
                 gops.plain_match(lm_cam, lm, feat, g), "match on the CPU")
    calls = []
    real = gops.plain_match
    monkeypatch.setattr(gops, "plain_match",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(gops, "match", lambda *a: calls.append(2) or real(*a))
    cfg = tiny_test_config()
    m = fm.init_map(cfg, "cpu")
    f = feat_of(cfg)
    fm.guided_match(cfg, m, torch.tensor([0, 0, 0, 1, 0, 0, 0.0]), f)
    assert calls == [2]


def feat_of(cfg):
    from putslam_tpu_torch.frontend import detector

    poses = synthetic.orbit_trajectory(2, radius=0.10, yaw_amp=0.1)
    g, d = synthetic.render_sequence(cfg.camera, poses)
    return detector.detect_and_describe(cfg, g[0], d[0])


def _bad_inputs():
    lm_cam, lm, feat = make("tiny", 8)
    g = gates()
    L, D, N = WIDTHS["tiny"]
    yield "acceptance", (lm_cam, lm, feat, g._replace(acceptance="band"))
    yield "slots", (lm_cam, lm._replace(
        lm_desc=torch.zeros((L, 9, 256), dtype=torch.int8),
        lm_slot_used=torch.zeros((L, 9), dtype=torch.bool)), feat, g)
    yield "features", (lm_cam, lm, feat._replace(
        xyz=torch.zeros((2049, 3)), has_depth=torch.zeros(2049, dtype=bool),
        octave=torch.zeros(2049, dtype=torch.int32),
        desc=torch.zeros((2049, 256), dtype=torch.int8)), g)
    yield "dtype", (lm_cam.double(), lm, feat, g)
    yield "shape", (lm_cam, lm._replace(lm_valid=lm.lm_valid[:-1]), feat, g)
    yield "contiguous", (lm_cam, lm, feat._replace(
        xyz=feat.xyz.t().contiguous().t()), g)
    yield "aligned", (lm_cam, lm, feat._replace(
        desc=torch.zeros(N * 256 + 1, dtype=torch.int8)[1:].view(N, 256)),
        g)
    # 8 bytes past a 16-byte boundary: the kernel's uint4 loads would fault
    yield "aligned 16", (lm_cam, lm, feat._replace(
        desc=torch.zeros(N * 256 + 8, dtype=torch.int8)[8:].view(N, 256)),
        g)
    yield "map aligned 16", (lm_cam, lm._replace(
        lm_desc=torch.zeros(L * D * 256 + 8, dtype=torch.int8)[8:]
        .view(L, D, 256)), feat, g)
    yield "desc width", (lm_cam, lm._replace(
        lm_desc=lm.lm_desc[..., :128].contiguous()), feat, g)


@pytest.mark.parametrize("name, args", list(_bad_inputs()),
                         ids=[n for n, _ in _bad_inputs()])
def test_wrong_input_raises(name, args):
    with pytest.raises(ValueError):
        gops.check_inputs(*args)


def test_good_input_passes():
    gops.check_inputs(*make("fr1", 9), gates())


def test_the_slice_meets_the_kernels_contract(monkeypatch):
    """The tiny slice's guided matches, through the frame runner without
    graphs (the first pass and the rungs): every call's inputs pass
    ``check_inputs`` and the model gives the chain's bits on them."""
    cfg = tiny_test_config()
    poses = synthetic.orbit_trajectory(6, radius=0.10, yaw_amp=0.1)
    g, d = synthetic.render_sequence(cfg.camera, poses)
    g = g.clone()
    g[4] = 0.5                         # no features: the retry ladder runs
    seen = []
    real = gops.match

    def match(lm_cam, lm, feat, gates_):
        gops.check_inputs(lm_cam, lm, feat, gates_)
        out = real(lm_cam, lm, feat, gates_)
        assert_equal(model(lm_cam, lm, feat, gates_), out,
                     f"call {len(seen)}")
        seen.append((float(gates_.radius), int(out[3])))
        return out

    monkeypatch.setattr(gops, "match", match)
    state = slam.slam_init(cfg, g[0], d[0], poses[0])
    for i in range(1, 6):
        state, _ = slam.slam_step(cfg, state, g[i], d[i])
    radii = {r for r, _ in seen}
    assert len(seen) >= 5 and len(radii) > 1, seen
    assert any(n > 0 for _, n in seen)


def test_roofline_counts():
    from putslam_tpu_torch.config import tum_fr1_config
    from slambench import spec

    roof = spec.load_module("roofline", "guided_match")
    ops, nbytes = roof.counts(tum_fr1_config())
    assert nbytes == 8_774_148 and ops == 9 * 8192 * 512
    L, D, N = WIDTHS["fr1"]
    assert nbytes > L * D * 256 + N * 256     # the descriptors alone


class _Trace:
    def __init__(self, ops):
        self.ops = ops

    def kernel_durations_s(self, fragment):
        return [d * 1e-9 for n, _, d in self.ops if fragment in n]


def test_roofline_metric():
    from putslam_tpu_torch.config import tum_fr1_config
    from slambench import spec

    read = spec.load_module("metrics", "guided_match_roofline").read
    cfg = tum_fr1_config()
    ops = [("guided_match_kernel(Params)", 0, 10_000),
           ("guided_match_kernel(Params)", 0, 30_000),
           ("ransac_score_kernel<true>", 0, 5_000)]
    want = 100 * 8_774_148 / 3.35e12 / 20e-6
    assert read(dict(trace=_Trace(ops), cfg=cfg)) == pytest.approx(
        want, rel=1e-12)
    assert read(dict(trace=_Trace(ops[2:]), cfg=cfg)) is None
