"""The detector's keypoint chain as the hand-written kernel
(``csrc/keypoints.cu``) on the card.

The kernel against the ATen chain it replaces (``keypoints.plain_chain``
run on the card), bit for bit in every output and in the bfloat16 patch
matrix: rendered fr1 frames (both descriptor kinds), a frame with no
corner, one with a few, equal corners on a grid (tied scores), corners
inside the border, depth at 0, at the gate and beyond it, and the tiny
config's two levels; the same input twice gives the same bits; so does
``detect_and_describe``'s every field. One counted launch a call (none
under ``cuda_lib.uncounted()``); replayed from a CUDA graph it gives the
eager bits, on new inputs too, and counts a launch a replay. In the SLAM
frame's graph: one launch a replayed frame and a ``detect`` stage inside
``track`` in every row. ``grid_policy="exact"`` takes the ATen chain on the
card and launches nothing. Wrong input raises ``ValueError``.

Needs a CUDA card and skips without one. Imports no JAX, so on the machine
with the card it runs as:
python -m pytest tests/test_torch_keypoints_cuda.py --noconftest -q"""

import dataclasses

import pytest
import torch
from _keypoints_cases import CASES, chain_inputs, make

from putslam_tpu_torch.frontend import detector
from putslam_tpu_torch.ops import brief, keypoints
from putslam_tpu_torch.utils import cuda_lib

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bits(x):
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16)
    return x


def assert_same(got, ref, what, names=keypoints.Chain._fields):
    for name, x, y in zip(names, got, ref):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        diff = _bits(x) != _bits(y)
        if diff.any():
            rows = torch.nonzero(diff.reshape(len(x), -1).any(-1))[:, 0]
            i = int(rows[0])
            raise AssertionError(
                f"{what}: {name} differs in {len(rows)} of {len(x)} rows, "
                f"first row {i}: {x[i].tolist()} against {y[i].tolist()}")


@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_the_aten_chain(cuda, case):
    args = chain_inputs(*make(case, cuda))
    ref = keypoints.plain_chain(*args)
    got = keypoints.chain(*args)
    assert_same(got, ref, case)
    assert_same(keypoints.chain(*args), got, f"{case}, twice")
    print(f"{case}: {int(ref.valid.sum())} valid, "
          f"{int(ref.has_depth.sum())} with depth of {len(ref.valid)}")
    if case.startswith("fr1"):
        assert int(ref.valid.sum()) > 200
    if case == "no_corner":
        assert not ref.valid.any()


@pytest.mark.parametrize("case", ["fr1_1", "fr1_ldb", "tied"])
def test_detect_and_describe_equals_the_aten_chain(cuda, case):
    cfg, g, d = make(case, cuda)
    feat = detector.detect_and_describe(cfg, g, d)
    ref = keypoints.plain_chain(*chain_inputs(cfg, g, d))
    desc, ang = brief.describe_patches(ref.patches, cfg.detector.descriptor)
    desc = torch.where(ref.valid[:, None], desc, torch.zeros_like(desc))
    names = ("uv", "uv_undist", "xyz", "response", "octave", "valid",
             "has_depth", "angle", "desc")
    assert_same([getattr(feat, n) for n in names],
                [getattr(ref, n) for n in names[:-2]] + [ang, desc], case,
                names)


def test_one_counted_launch_a_call(cuda):
    args = chain_inputs(*make("fr1_0", cuda))
    keypoints.chain(*args)
    keypoints._LIB.reset_launch_count()
    for _ in range(3):
        keypoints.chain(*args)
    assert keypoints._LIB.launch_count() == 3
    with cuda_lib.uncounted():
        keypoints.chain(*args)
    assert keypoints._LIB.launch_count() == 3


def test_replayed_equals_eager(cuda):
    det, cam, shapes, budgets, levels, maps, depth = chain_inputs(
        *make("fr1_0", cuda))
    stream = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side), cuda_lib.uncounted():
        keypoints.chain(det, cam, shapes, budgets, levels, maps, depth)
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    keypoints._LIB.reset_launch_count()
    with torch.cuda.graph(graph):
        out = keypoints.chain(det, cam, shapes, budgets, levels, maps, depth)
    for case in ("fr1_1", "fr1_2"):
        _, _, _, _, lv, mp, dp = chain_inputs(*make(case, cuda))
        for dst, src in zip(levels + [m for pair in maps for m in pair]
                            + [depth], lv + [m for pair in mp for m in pair]
                            + [dp]):
            dst.copy_(src)
        eager = keypoints.chain(det, cam, shapes, budgets, levels, maps,
                                depth)
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert_same(out, eager, f"{case} replayed")
    assert keypoints._LIB.launch_count() == 2 * 3   # an eager call, 2 replays


def test_one_launch_a_replayed_slam_frame(cuda):
    from test_torch_recorder import S, recorder_case

    from putslam_tpu_torch.models import compiled, slam
    from putslam_tpu_torch.utils import timing

    cfg, poses, g, d = recorder_case()
    poses, g, d = poses.to(cuda), g.to(cuda), d.to(cuda)
    with timing.recording(timing.Recorder()) as rec:
        compiled.clear_cache()
        state = slam.slam_init(cfg, g[0], d[0], poses[0], device=cuda)
        keypoints._LIB.reset_launch_count()
        gen = torch.Generator(device=cuda)
        gen.manual_seed(5)
        compiled.run_sequence(cfg, state, g[1:], d[1:], generator=gen,
                              capture=True)
        launches = keypoints._LIB.launch_count()
        snap = timing.snapshot(rec)
    compiled.clear_cache()
    frames = snap["valid"] & (snap["root"] == S["frame"])
    assert frames.sum() == len(g) - 1
    assert launches == len(g) - 1
    assert snap["launches"]["keypoints"] == launches
    c, b, e = (snap[f][frames] for f in ("count", "begin", "end"))
    det, trk = S["detect"], S["track"]
    assert (c[:, det] == 1).all()
    assert (b[:, trk] <= b[:, det]).all() and (b[:, det] <= e[:, det]).all()
    assert (e[:, det] <= e[:, trk]).all()


def test_wrong_input_raises(cuda):
    det, cam, shapes, budgets, levels, maps, depth = chain_inputs(
        *make("tiny", cuda))

    def call(**over):
        a = dict(det=det, cam=cam, shapes=shapes, budgets=budgets,
                 levels=levels, maps=maps, depth=depth)
        a.update(over)
        return keypoints.chain(**a)

    wide = torch.zeros((levels[0].shape[0], 2 * levels[0].shape[1]),
                       device=cuda)
    for over in (dict(depth=depth.double()), dict(depth=depth.cpu()),
                 dict(levels=[wide[:, ::2]] + levels[1:]),
                 dict(maps=[(m[1], m[0].t()) for m in maps])):
        with pytest.raises(ValueError):
            call(**over)


@pytest.mark.parametrize("case", ["fr1_0", "tied", "tiny"])
def test_exact_policy_takes_the_aten_chain(cuda, case):
    det, *rest = chain_inputs(*make(case, cuda))
    det = dataclasses.replace(det, grid_policy="exact")
    keypoints._LIB.reset_launch_count()
    got = keypoints.chain(det, *rest)
    ref = keypoints.plain_chain(det, *rest)
    torch.cuda.synchronize()
    assert keypoints._LIB.launch_count() == 0
    assert_same(got, ref, f"{case}, exact cap")
