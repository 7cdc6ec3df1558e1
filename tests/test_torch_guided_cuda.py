"""Guided map matching as the hand-written kernel (``csrc/guided_match.cu``)
on the card.

The kernel against the ATen chain it replaces (``guided_match.plain_match``
run on the card), bit for bit in the feature index, the distance, the
acceptance and the count: random maps at the tiny and fr1 widths with both
acceptances, radius scales 1, 2 and 4 and a Hamming slack, ties, invalid
landmarks and unused slots, distances at the Hamming gate ± 1 and points
at the radius ± 1 ulp, a map with every landmark valid, and the maps of a
702-frame fr1 walk at three points. The gate's norm equals the card's
``torch.linalg.vector_norm`` bit for bit on 10^7 random triples and on a
whole (L, N, 3) difference. One counted launch a call (none under
``cuda_lib.uncounted()``); replayed from a CUDA graph it gives the eager
bits; in the SLAM frame's graph one launch a replayed frame and rung,
inside a ``guided`` stage of ``track``; the map's ``guided_match`` is one
launch with the chain's bits. Three 702-frame walks of one seed give the
same poses, flags, inliers, landmarks and final map with the kernel and
with the ATen chain. Wrong input raises ``ValueError``, an int8 tensor 8
bytes past a 16-byte boundary too, and the card works on after it.

Needs a CUDA card and skips without one. Imports no JAX, so on the machine
with the card it runs as:
python -m pytest tests/test_torch_guided_cuda.py --noconftest -q"""

import json
from pathlib import Path

import pytest
import torch
from _guided_cases import gates, make

from putslam_tpu_torch.ops import guided_match as gops
from putslam_tpu_torch.utils import cuda_lib

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("feat_idx", "dist", "valid", "n_candidates")
FR1_STOPS = (233, 467, 700)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_same(got, ref, what):
    for name, x, y in zip(FIELDS, got, ref):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        diff = (_bits(x) != _bits(y)).reshape(-1)
        if diff.any():
            i = int(torch.nonzero(diff)[0])
            raise AssertionError(
                f"{what}: {name} differs at {int(diff.sum())} landmarks, "
                f"first {i}: {x.reshape(-1)[i].item()} against "
                f"{y.reshape(-1)[i].item()}")


def test_norm_order_equals_vector_norm(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    n = 10_000_000
    x = (torch.rand((n, 3), generator=gen, device=cuda) * 2 - 1) \
        * torch.pow(10.0, torch.rand((n, 3), generator=gen, device=cuda)
                    * 5 - 3)
    ref = torch.linalg.vector_norm(x, dim=-1)
    assert torch.equal(_bits(gops.norm3(x)), _bits(ref))
    lm_cam, lm, feat = make("fr1", 3, device=cuda)
    diff = lm_cam[:, None, :] - feat.xyz[None, :, :]
    ref = torch.linalg.norm(diff, dim=-1).reshape(-1)
    got = gops.norm3(diff.reshape(-1, 3).contiguous())
    assert torch.equal(_bits(got), _bits(ref))


CASES = [(w, seed, scale, slack, acc, False, 0)
         for w, seed in (("tiny", 1), ("fr1", 3))
         for scale, slack in ((1.0, 0.0), (2.0, 0.0), (4.0, 8.0))
         for acc in ("hamming", "ratio")] + [
    ("fr1", 5, 1.0, 0.0, "hamming", True, 0),
    ("fr1", 5, 1.0, 0.0, "ratio", True, 0),
    # fewer slots than a group's four, and a second group (D 5 to 8)
    ("tiny", 1, 2.0, 0.0, "ratio", False, 2),
    ("tiny", 2, 2.0, 0.0, "ratio", False, 6),
    ("fr1", 3, 1.0, 0.0, "hamming", True, 8)]


@pytest.mark.parametrize(
    "width, seed, scale, slack, acceptance, all_valid, views", CASES)
def test_kernel_equals_the_aten_chain(cuda, width, seed, scale, slack,
                                      acceptance, all_valid, views):
    lm_cam, lm, feat = make(width, seed, scale=scale, slack=slack,
                            all_valid=all_valid, views=views, device=cuda)
    g = gates(scale, slack, acceptance)
    ref = gops.plain_match(lm_cam, lm, feat, g)
    got = gops.match(lm_cam, lm, feat, g)
    what = f"{width} seed {seed} x{scale} +{slack} {acceptance} D {views}"
    assert_same(got, ref, what)
    assert_same(gops.match(lm_cam, lm, feat, g), got, f"{what}, twice")
    assert 0 < int(ref[2].sum()) < int(ref[3])


def _fr1_walk(cuda, walk: int, texture: int):
    """One 702-frame walk of the offline traffic at fr1, on the card:
    (cfg, grays, depths, ground truth)."""
    from slambench import spec
    from slambench.gen import render, walks
    from slambench.run import handoff

    conf = json.loads((ROOT / "slambench/configs/fr1_desk.json").read_text())
    traffic = json.loads(
        (ROOT / "slambench/traffic/handheld_offline.json").read_text())
    cfg = spec.slam_config(conf.get("slam", {}))
    n = int(round(conf["duration_s"] * conf["fps"]))
    gt = walks.walk(n, walk, device=cuda, **traffic["walk"])
    g8, d16 = render.render_wire(cfg.camera, gt, cfg.camera.depth_image_scale,
                                 texture, False)
    grays, depths = handoff(cfg, g8, d16, cuda)
    return cfg, grays, depths, gt


@pytest.fixture(scope="module")
def fr1_maps(cuda):
    """The map, pose and next frame's features after frames 233, 467 and
    700 of a 702-frame fr1 walk run from the frame's graph."""
    from putslam_tpu_torch.frontend import detector
    from putslam_tpu_torch.models import compiled, slam
    from putslam_tpu_torch.slam_map import features_map as fm

    cfg, grays, depths, gt = _fr1_walk(cuda, 0, 12345)
    compiled.clear_cache()
    state = slam.slam_init(cfg, grays[0], depths[0], gt[0])
    gen = torch.Generator(device=cuda).manual_seed(5)
    out, k0 = [], 1
    for k in FR1_STOPS:
        state, _ = compiled.run_sequence(cfg, state, grays[k0:k + 1],
                                         depths[k0:k + 1], generator=gen)
        k0 = k + 1
        feat = detector.detect_and_describe(cfg, grays[k + 1], depths[k + 1])
        out.append((cfg, fm._landmarks_in_camera(state.map, state.pose),
                    state.map, feat))
    compiled.clear_cache()
    return dict(zip(FR1_STOPS, out))


@pytest.mark.parametrize("stop", FR1_STOPS)
def test_kernel_on_the_maps_of_a_fr1_walk(cuda, fr1_maps, stop):
    cfg, lm_cam, m, feat = fr1_maps[stop]
    mc = cfg.matcher
    assert int(m.lm_valid.sum()) > 500
    for scale in (1.0, 2.0, 4.0):
        for acceptance in ("hamming", "ratio"):
            g = gops.Gates(mc.matching_xyz_sphere_radius * scale,
                           mc.octave_window, mc.max_hamming, acceptance,
                           mc.matching_xyz_acceptance_ratio)
            ref = gops.plain_match(lm_cam, m, feat, g)
            assert_same(gops.match(lm_cam, m, feat, g), ref,
                        f"frame {stop} x{scale} {acceptance}")
            assert int(ref[2].sum()) > 20


def test_one_counted_launch_a_call(cuda):
    lm_cam, lm, feat = make("tiny", 2, device=cuda)
    g = gates()
    gops._LIB.reset_launch_count()
    gops.match(lm_cam, lm, feat, g)
    gops.match(lm_cam, lm, feat, g)
    with cuda_lib.uncounted():
        gops.match(lm_cam, lm, feat, g)
    gops.plain_match(lm_cam, lm, feat, g)
    assert gops._LIB.launch_count() == 2


def test_replayed_from_a_graph(cuda):
    lm_cam, lm, feat = make("fr1", 6, device=cuda)
    bufs = [lm_cam.clone(), type(lm)(*(t.clone() for t in lm)),
            type(feat)(*(t.clone() for t in feat))]
    g = gates(2.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), cuda_lib.uncounted():
        gops.match(*bufs, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gops.match(*bufs, g)
    gops._LIB.reset_launch_count()
    for seed in (6, 7):
        lm_cam, lm, feat = make("fr1", seed, scale=2.0, device=cuda)
        bufs[0].copy_(lm_cam)
        for dst, src in zip(bufs[1], lm):
            dst.copy_(src)
        for dst, src in zip(bufs[2], feat):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert_same(out, gops.plain_match(lm_cam, lm, feat, g),
                    f"seed {seed} replayed")
    assert gops._LIB.launch_count() == 2


def test_a_launch_a_replayed_frame_and_rung(cuda):
    from test_torch_recorder import S, recorder_case

    from putslam_tpu_torch.models import compiled, slam
    from putslam_tpu_torch.utils import timing

    cfg, poses, g, d = recorder_case()
    poses, g, d = poses.to(cuda), g.to(cuda), d.to(cuda)
    with timing.recording(timing.Recorder()) as rec:
        compiled.clear_cache()
        state = slam.slam_init(cfg, g[0], d[0], poses[0], device=cuda)
        gops._LIB.reset_launch_count()
        gen = torch.Generator(device=cuda)
        gen.manual_seed(5)
        compiled.run_sequence(cfg, state, g[1:], d[1:], generator=gen,
                              capture=True)
        launches = gops._LIB.launch_count()
        snap = timing.snapshot(rec)
    compiled.clear_cache()
    frames = snap["valid"] & (snap["root"] == S["frame"])
    assert frames.sum() == len(g) - 1
    c, b, e = (snap[f][frames] for f in ("count", "begin", "end"))
    gd, trk = S["guided"], S["track"]
    assert (c[:, gd] == 1 + c[:, S["map_retry"]]).all()
    assert c[:, S["map_retry"]].sum() > 0      # the flat frame's rungs
    assert launches == c[:, gd].sum()
    assert snap["launches"]["guided_match"] == launches
    assert (b[:, trk] <= b[:, gd]).all() and (e[:, gd] <= e[:, trk]).all()


def test_the_map_match_is_one_launch(cuda):
    from putslam_tpu_torch.config import tiny_test_config
    from putslam_tpu_torch.frontend.detector import Features
    from putslam_tpu_torch.slam_map import features_map as fm

    cfg = tiny_test_config()
    lm_cam, lm, feat = make("tiny", 3, device=cuda)
    m = fm.init_map(cfg, cuda)
    m = m._replace(lm_desc=lm.lm_desc, lm_slot_used=lm.lm_slot_used,
                   lm_valid=lm.lm_valid, lm_octave=lm.lm_octave,
                   lm_pos=lm_cam)
    n = feat.xyz.shape[0]
    f = Features(uv=torch.zeros((n, 2), device=cuda),
                 uv_undist=torch.zeros((n, 2), device=cuda), xyz=feat.xyz,
                 response=torch.zeros(n, device=cuda), octave=feat.octave,
                 angle=torch.zeros(n, device=cuda), desc=feat.desc,
                 valid=feat.has_depth, has_depth=feat.has_depth)
    pose = torch.tensor([0, 0, 0, 1, 0, 0, 0.0], device=cuda)
    gops._LIB.reset_launch_count()
    one = fm.guided_match(cfg, m, pose, f)
    assert gops._LIB.launch_count() == 1
    ref = gops.plain_match(fm._landmarks_in_camera(m, pose), m, f,
                           fm._gates(cfg, 1.0, 0.0))
    assert_same(one, ref, "the map's guided_match")


def test_wrong_input_raises(cuda):
    lm_cam, lm, feat = make("tiny", 4, device=cuda)
    g = gates()
    for args in ((lm_cam.cpu(), lm, feat, g),
                 (lm_cam, lm, feat._replace(xyz=feat.xyz.t().contiguous()
                                            .t()), g),
                 (lm_cam, lm._replace(lm_octave=lm.lm_octave.long()), feat,
                  g),
                 (lm_cam, lm, feat, g._replace(acceptance="band"))):
        with pytest.raises(ValueError):
            gops.check_inputs(*args)
    with pytest.raises(ValueError):
        gops.match(lm_cam, lm._replace(lm_valid=lm.lm_valid[1:]), feat, g)
    n = feat.desc.numel()
    off = torch.zeros(n + 8, dtype=torch.int8, device=cuda)[8:]
    off.copy_(feat.desc.reshape(-1))
    assert off.data_ptr() % 16 == 8
    with pytest.raises(ValueError):
        gops.match(lm_cam, lm, feat._replace(desc=off.view_as(feat.desc)), g)
    assert_same(gops.match(lm_cam, lm, feat, g),
                gops.plain_match(lm_cam, lm, feat, g), "after the refusals")


def _sequence(walk, chain: bool):
    from putslam_tpu_torch.models import compiled, slam

    cfg, grays, depths, gt = walk
    compiled.clear_cache()
    real = gops.match
    if chain:
        gops.match = gops.plain_match
    try:
        state = slam.slam_init(cfg, grays[0], depths[0], gt[0])
        gen = torch.Generator(device=grays.device).manual_seed(11)
        state, outs = compiled.run_sequence(cfg, state, grays[1:],
                                            depths[1:], generator=gen)
        torch.cuda.synchronize()
    finally:
        gops.match = real
        compiled.clear_cache()
    return state, outs


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a, b = (x.contiguous().view(torch.int32 if x.element_size() == 4
                                    else torch.int64) for x in (a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("walk", [0, 1, 2])
def test_a_fr1_walk_is_the_same_with_the_chain(cuda, walk):
    """Every output of every frame and the final state, bit for bit."""
    seq = _fr1_walk(cuda, walk, 777)
    gops._LIB.reset_launch_count()
    state_k, outs_k = _sequence(seq, chain=False)
    launches = gops._LIB.launch_count()
    state_c, outs_c = _sequence(seq, chain=True)
    assert gops._LIB.launch_count() == launches >= len(outs_k.pose)
    for name, a, b in zip(outs_k._fields, outs_k, outs_c):
        assert _same_bits(a, b), name
    for name, a, b in zip(state_k.map._fields, state_k.map, state_c.map):
        assert _same_bits(a, b), f"map.{name}"
    assert _same_bits(state_k.pose, state_c.pose)
    assert int(outs_k.map_ok.sum()) > 350
