"""The flight recorder's stamps on the card (``csrc/stamp.cu``): the replayed
frame of the tiny case of ``test_torch_recorder.py``, on one seed, records
the stage counts of the runner without graphs on the same card, row by
row, and those of its own ``SlamOutputs``; a second run of the graphs
repeats them; every stamp of a row lies in order; the frame's time holds
its parts; the card's clock, put on the host's by the recorder's offset,
starts each frame after the host began its replay; the card's ring keeps
its last rows; a profiler sees the spans. Needs a CUDA card (``-m cuda``):
``python -m pytest tests/test_torch_recorder_cuda.py --noconftest -q``."""

import numpy as np
import pytest
import torch
from test_torch_recorder import S, recorder_case

from putslam_tpu_torch.models import compiled, slam
from putslam_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda
SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(card):
    cfg, poses, g, d = recorder_case()
    return cfg, poses.to(card), g.to(card), d.to(card)


def _sequence(cfg, poses, g, d, capture):
    gen = torch.Generator(device=g.device)
    gen.manual_seed(SEED)
    state = slam.slam_init(cfg, g[0], d[0], poses[0], device=g.device)
    state, outs = compiled.run_sequence(cfg, state, g[1:], d[1:],
                                        generator=gen, capture=capture)
    compiled.finalize_runner(cfg, state, capture).run(state)
    return outs


@pytest.fixture(scope="module")
def runs(card):
    """The runner without graphs (its own recorder), then the graphs twice
    (one recorder: captured under it, the second run replays them)."""
    cfg, poses, g, d = _inputs(card)
    with timing.recording(timing.Recorder()) as rec:
        host_outs = _sequence(cfg, poses, g, d, False)
        host = timing.snapshot(rec)
    with timing.recording(timing.Recorder()) as rec:
        compiled.clear_cache()           # capture under this recorder
        outs = [_sequence(cfg, poses, g, d, True) for _ in range(2)]
        torch.cuda.synchronize()
        graph = timing.snapshot(rec)
    compiled.clear_cache()
    return cfg, host, host_outs, graph, outs


def test_card_counts_equal_the_runner_and_the_outputs(runs):
    cfg, host, host_outs, graph, outs = runs
    n = len(host["replay"])
    assert graph["on_device"].all() and graph["valid"].all()
    assert len(graph["replay"]) == 2 * n
    assert np.array_equal(graph["root"][:n], host["root"])
    assert np.array_equal(graph["count"][:n], host["count"])
    frames = graph["root"][:n] == S["frame"]
    c = graph["count"][:n][frames]
    for o in (host_outs, outs[0]):
        kf, ba = o.is_keyframe.cpu().numpy(), o.ba_ran.cpu().numpy()
        assert (c[:, S["keyframe"]] == kf).all()
        assert (c[:, S["tail"]] == ~kf).all()
        assert (c[:, S["ba"]] == ba).all()
        assert (c[:, S["gn_iteration"]]
                <= cfg.backend.gn_iterations * ba).all()
    assert c[:, S["keyframe"]].any() and c[:, S["ba"]].any()


def test_card_counts_repeat(runs):
    _, _, _, graph, outs = runs
    n = len(graph["replay"]) // 2
    assert np.array_equal(graph["count"][:n], graph["count"][n:])
    assert torch.equal(outs[0].is_keyframe, outs[1].is_keyframe)


def test_card_stamps_in_order(runs):
    graph = runs[3]
    b, e, c = graph["begin"], graph["end"], graph["count"]
    for i, root in enumerate(graph["root"]):
        b0, e0 = b[i, root], e[i, root]
        ran = np.flatnonzero(c[i] > 0)
        assert (b0 <= b[i, ran]).all() and (b[i, ran] <= e[i, ran]).all()
        assert (e[i, ran] <= e0).all()
        if root != S["frame"]:
            continue
        after = S["tail"] if c[i, S["tail"]] else S["keyframe"]
        assert e[i, S["track"]] <= b[i, after]
        if c[i, S["ba"]]:
            k, ba, gn = S["keyframe"], S["ba"], S["gn_iteration"]
            assert b[i, k] <= b[i, ba] <= b[i, gn] <= e[i, gn] <= e[i, ba] \
                <= e[i, k]


def test_card_frame_holds_its_parts(runs):
    graph = runs[3]
    frames = graph["root"] == S["frame"]
    t = graph["total"][frames]
    parts = t[:, S["track"]] + t[:, S["tail"]] + t[:, S["keyframe"]]
    rest = t[:, S["frame"]] - parts
    print(f"frame ns {t[:, S['frame']].tolist()}, outside its parts "
          f"{rest.tolist()}")
    assert (rest >= 0).all()
    # the first replay after the capture spends ~0.9 ms more inside the
    # frame but outside its stages (the card's first run of the graph):
    # every later one at most 2 % (the flags, set-condition kernels, IF
    # nodes and stamps between the stages)
    assert (rest[1:] <= 0.02 * t[1:, S["frame"]]).all()


def test_card_clock_on_the_hosts(runs):
    graph = runs[3]
    err = next(iter(graph["clock"].values()))["error_ns"]
    sp = graph["spans"]
    start = {r: s for n, r, s in zip(sp["name"], sp["replay"], sp["start"])
             if n == "replay"}
    for i in np.flatnonzero(graph["root"] == S["frame"]):
        r = graph["replay"][i]
        assert graph["begin"][i, S["frame"]] >= start[r] - err
    print(f"clock: {graph['clock']}")


def test_card_ring_keeps_the_last_rows(card):
    cfg, poses, g, d = _inputs(card)
    gen = torch.Generator(device=card)
    gen.manual_seed(SEED)
    with timing.recording(timing.Recorder(capacity=4)) as rec:
        state = slam.slam_init(cfg, g[0], d[0], poses[0], device=card)
        runner = compiled.SlamGraphs(cfg, state, g.shape[1:])
        outs = [runner.step(g[i], d[i], generator=gen)
                for i in range(1, len(g))]
        snap = timing.snapshot(rec)
    n = len(outs)
    assert list(snap["replay"]) == list(range(n - 4, n))
    assert snap["valid"].all()
    kf = torch.stack([o.is_keyframe for o in outs[-4:]]).cpu().numpy()
    assert list(snap["count"][:, S["keyframe"]]) == list(kf)
    assert list(snap["count"][:, S["frame"]]) == [1] * 4


def test_card_spans_on_the_profilers_trace(card):
    from torch.profiler import ProfilerActivity, profile

    cfg, poses, g, d = _inputs(card)
    with timing.recording(timing.Recorder()) as rec:
        compiled.clear_cache()
        _sequence(cfg, poses, g[:4], d[:4], True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _sequence(cfg, poses, g[:4], d[:4], True)
            torch.cuda.synchronize()
        snap = timing.snapshot(rec)
    compiled.clear_cache()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"putslam.step", "putslam.load", "putslam.inputs",
            "putslam.draws", "putslam.replay", "putslam.clone"} <= names
    assert list(snap["profiled"]) == [False] * 4 + [True] * 4
    # the spans are host operations: none of them is on the card's timeline
    on_card = {e.name() for e in prof.profiler.kineto_results.events()
               if "CUDA" in str(e.device_type())}
    assert not {n for n in on_card if n.startswith("putslam.")}
