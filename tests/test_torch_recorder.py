"""The flight recorder (``utils/timing.py``) on the CPU: the runner with
``capture=False`` writes the rows that the CUDA graph's stamps write on
the card, from the host's clock, so its stage counts must equal what the
frame's ``SlamOutputs`` say it did, and repeat for a seed; the host spans
nest, with their replay numbers; the rings keep the last rows and spans;
the masked (eager) path records nothing; spans sit on a profiler's trace;
``times.txt`` carries the recorder's lines; and each per-layer metric of
``slambench/metrics`` that reads the recorder gives the value expected on
a snapshot made by hand, and None where nothing was recorded. The card's
own stamps are ``test_torch_recorder_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from putslam_tpu_torch.config import tiny_test_config
from putslam_tpu_torch.io import synthetic
from putslam_tpu_torch.models import compiled, slam
from putslam_tpu_torch.utils import control, timing

SEEDS = (3, 11, 2 ** 31 + 7)
S = {name: k for k, name in enumerate(timing.STAGES)}


def recorder_case():
    """The tiny config with the BA every second keyframe, and an orbit of 12
    frames whose frame 8 is flat (no features: the map retry ladder)."""
    cfg = tiny_test_config()
    cfg = cfg.replace(backend=dataclasses.replace(
        cfg.backend, solver="dense_schur_mm", ba_window=2, ba_lm_block=128,
        optimize_every_n_frames=2))
    poses = synthetic.orbit_trajectory(12, radius=0.10, yaw_amp=0.1)
    g, d = synthetic.render_sequence(cfg.camera, poses)
    g = g.clone()
    g[8] = 0.5
    return cfg, poses, g, d


@pytest.fixture(scope="module")
def case():
    return recorder_case()


def _run(case, seed):
    """(snapshot, outputs, final state) of a runner without graphs over the
    case and of finalize's runner without graphs, in a fresh recorder."""
    cfg, poses, g, d = case
    gen = torch.Generator()
    gen.manual_seed(seed)
    with timing.recording(timing.Recorder()) as rec:
        state = slam.slam_init(cfg, g[0], d[0], poses[0])
        state, outs = compiled.run_sequence(cfg, state, g[1:], d[1:],
                                            generator=gen, capture=False)
        compiled.FinalizeGraphs(cfg, state, capture=False).run(state)
        return timing.snapshot(rec), outs, state


@pytest.mark.parametrize("seed", SEEDS)
def test_counts_equal_the_outputs(case, seed):
    cfg = case[0]
    snap, outs, _ = _run(case, seed)
    count = snap["count"]
    frames = snap["root"] == S["frame"]
    assert snap["valid"].all() and not snap["on_device"].any()
    assert frames.sum() == len(outs.pose) and frames[:-1].all()
    kf, ba = outs.is_keyframe.numpy(), outs.ba_ran.numpy()
    assert kf.any() and ba.any()          # the case reaches both
    c = count[frames]
    assert (c[:, S["frame"]] == 1).all() and (c[:, S["track"]] == 1).all()
    assert (c[:, S["detect"]] == 1).all()
    assert (c[:, S["guided"]] == 1 + c[:, S["map_retry"]]).all()
    assert (c[:, S["keyframe"]] == kf).all()
    assert (c[:, S["tail"]] == ~kf).all()
    assert (c[:, S["ba"]] == ba).all()
    gn = c[:, S["gn_iteration"]]
    assert (gn <= cfg.backend.gn_iterations * ba).all() and (gn >= ba).all()
    assert c[:, S["map_retry"]].sum() > 0
    assert c[:, S["map_retry"]].max() <= cfg.matcher.retries
    assert (c[:, S["finalize"]] == 0).all() and (c[:, S["vo_retry"]] == 0).all()
    # the totals: counts a stage adds up, whatever the rows
    assert count[:, S["frame"]].sum() == len(outs.pose)
    assert count[:, S["keyframe"]].sum() == kf.sum()
    assert count[:, S["tail"]].sum() == len(kf) - kf.sum()
    assert count[:, S["ba"]].sum() == ba.sum()
    # finalize's row: its two solves' iterations, nothing of a frame
    f = count[-1]
    assert snap["root"][-1] == S["finalize"] and f[S["finalize"]] == 1
    assert 2 <= f[S["gn_iteration"]] <= 2 * cfg.backend.final_gn_iterations
    assert f[[S[n] for n in ("frame", "track", "tail", "keyframe",
                             "ba", "detect", "guided")]].sum() == 0
    # a stage's summed time lies inside its replay's root, child in parent
    tot = snap["total"]
    assert (tot[frames, S["frame"]] >= tot[frames, S["track"]]
            + tot[frames, S["tail"]] + tot[frames, S["keyframe"]]).all()
    assert (tot[:, S["keyframe"]] >= tot[:, S["ba"]]).all()
    assert (tot[frames, S["track"]] >= tot[frames, S["detect"]]
            + tot[frames, S["guided"]]).all()
    assert (tot[frames, S["ba"]] >= tot[frames, S["gn_iteration"]]).all()


def test_counts_repeat_for_a_seed(case):
    a, outs_a, _ = _run(case, SEEDS[0])
    b, outs_b, _ = _run(case, SEEDS[0])
    assert np.array_equal(a["count"], b["count"])
    assert np.array_equal(a["root"], b["root"])
    assert np.array_equal(a["replay"], b["replay"])
    assert torch.equal(outs_a.is_keyframe, outs_b.is_keyframe)


def test_spans_nest_with_their_replays(case):
    snap, outs, _ = _run(case, SEEDS[1])
    sp = snap["spans"]
    name = list(sp["name"])
    step = sp["index"][name.index("step")]
    at = {i: k for k, i in enumerate(sp["index"])}
    assert name.count("step") == 1 and sp["parent"][at[step]] == -1
    s0, s1 = sp["start"][at[step]], sp["end"][at[step]]
    kids = [k for k in range(len(name)) if sp["parent"][k] == step]
    assert {name[k] for k in kids} == {"load", "inputs", "draws", "replay",
                                       "clone"}
    for k in kids:
        assert s0 <= sp["start"][k] <= sp["end"][k] <= s1
    frames = np.flatnonzero(snap["root"] == S["frame"])
    assert (snap["call"][frames] == step).all()
    for i in frames:
        r = snap["replay"][i]
        mine = {name[k]: k for k in kids if sp["replay"][k] == r
                and name[k] != "load"}
        assert sorted(mine) == ["clone", "draws", "inputs", "replay"]
        assert sp["end"][mine["inputs"]] <= sp["start"][mine["draws"]]
        assert sp["end"][mine["draws"]] <= sp["start"][mine["replay"]]
        assert sp["end"][mine["replay"]] <= sp["start"][mine["clone"]]
        # the row's stamps, on the host's clock here, inside its replay
        k = mine["replay"]
        b, e = snap["begin"][i, S["frame"]], snap["end"][i, S["frame"]]
        assert sp["start"][k] <= b <= e <= sp["end"][k]
    first = snap["replay"][frames[0]]
    assert sp["replay"][name.index("load")] == first
    assert len(frames) == len(outs.pose)


def _toy_replays(n, kf=lambda r: r % 2 == 1):
    """``n`` host-mode rows of a frame whose keyframe branch runs where
    ``kf(r)``, its BA every third replay, through ``control.cond``."""
    out = torch.zeros(())
    with control.branching("host"):
        for r in range(n):
            with timing.span("step"), timing.span("replay"), \
                    timing.stage("frame"):
                with timing.stage("track"):
                    pass
                control.cond(torch.tensor(not kf(r)), lambda: out, out,
                             name="tail")

                def keyframe(r=r):
                    control.cond(torch.tensor(r % 3 == 0), lambda: out, out,
                                 name="ba")
                    return out

                control.cond(torch.tensor(kf(r)), keyframe, out,
                             name="keyframe")


def test_rings_keep_the_last_rows_and_spans():
    with timing.recording(timing.Recorder(capacity=4, span_capacity=8)) as rec:
        _toy_replays(10)
        snap = timing.snapshot(rec)
    assert list(snap["replay"]) == [6, 7, 8, 9]
    assert snap["valid"].all()
    c = snap["count"]
    assert list(c[:, S["frame"]]) == [1, 1, 1, 1]
    assert list(c[:, S["keyframe"]]) == [0, 1, 0, 1]
    assert list(c[:, S["tail"]]) == [1, 0, 1, 0]
    assert list(c[:, S["ba"]]) == [0, 0, 0, 1]      # replay 9: 9 % 3 == 0
    assert list(snap["spans"]["index"]) == list(range(12, 20))
    assert snap["span_totals"]["step"]["count"] == 10
    assert snap["span_totals"]["replay"]["count"] == 10


def test_nothing_recorded_masked_or_outside_a_root():
    out = torch.zeros(())
    with timing.recording(timing.Recorder()) as rec:
        with timing.stage("frame"):               # masked: the eager step
            control.cond(torch.tensor(True), lambda: out, out, name="tail")
        with control.branching("host"):
            control.cond(torch.tensor(True), lambda: out, out, name="tail")
            with timing.stage("track"):
                pass
        snap = timing.snapshot(rec)
    assert rec.n_replays == 0 and len(snap["replay"]) == 0


def test_spans_on_the_profilers_trace():
    from torch.profiler import ProfilerActivity, profile

    with timing.recording(timing.Recorder()) as rec:
        _toy_replays(2)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _toy_replays(3)
        snap = timing.snapshot(rec)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("putslam.step") == 3
    assert names.count("putslam.replay") == 3
    assert list(snap["profiled"]) == [False, False, True, True, True]
    steps = snap["spans"]["name"] == "step"
    assert list(snap["spans"]["profiled"][steps]) == [False, False, True,
                                                       True, True]


def test_times_txt_has_the_recorder(tmp_path):
    with timing.recording(timing.Recorder()):
        timer = timing.StageTimer()
        with timer.stage("dataset"):
            pass
        _toy_replays(4)
        timer.write_times_txt(str(tmp_path / "times.txt"))
    text = (tmp_path / "times.txt").read_text()
    assert text.startswith("dataset: mean")
    assert "span step: mean" in text and "span replay: mean" in text
    assert "span dataset" not in text
    assert "stage frame: mean" in text and "over 4 runs in 4 of 4 replays, " \
        "host clock" in text
    assert "stage keyframe: mean" in text and "stage ba:" in text


# ---- the per-layer metrics that read the recorder --------------------------

def _hand_made():
    """Four frames (the last profiled; replays 10-11 one call, 12-13
    another) and a finalize, on the card's clock; spans of four steps (one
    profiled, one that captured a graph) and 2.5 s of captures."""
    n = 5
    snap = {"stages": timing.STAGES,
            "replay": np.arange(10, 15),
            "root": np.array([S["frame"]] * 4 + [S["finalize"]]),
            "call": np.array([7, 7, 8, 8, -1]),
            "profiled": np.array([False, False, False, True, False]),
            "valid": np.ones(n, bool), "on_device": np.ones(n, bool)}
    for f in timing.FIELDS:
        snap[f] = np.zeros((n, len(timing.STAGES)), np.int64)
    ms = 1_000_000

    def put(stage, field, values):
        snap[field][:, S[stage]] = np.asarray(values) * ms

    put("frame", "total", [4, 5, 6, 100, 0])
    put("frame", "begin", [1000, 1005.1, 1012, 1020, 0])
    snap["end"][:, S["frame"]] = (snap["begin"][:, S["frame"]]
                                  + snap["total"][:, S["frame"]])
    snap["count"][:4, S["frame"]] = 1
    put("track", "total", [2, 3, 3, 50, 0])
    put("detect", "total", [1, 1.5, 2, 20, 0])
    put("guided", "total", [0.25, 0.5, 0.75, 10, 0])
    put("keyframe", "total", [0, 2, 2.5, 40, 0])
    snap["count"][:, S["keyframe"]] = [0, 1, 1, 1, 0]
    put("ba", "total", [0, 0, 1.5, 30, 0])
    snap["count"][:, S["ba"]] = [0, 0, 1, 1, 0]
    snap["count"][:, S["map_retry"]] = [1, 0, 2, 5, 0]
    put("finalize", "total", [0, 0, 0, 0, 15])
    snap["count"][4, S["finalize"]] = 1
    snap["spans"] = {"index": np.arange(6),
                     "name": np.array(["step", "capture", "step", "step",
                                       "step", "replay"], dtype=object),
                     "start": np.array([-9000, -8999, 0, 10, 20, 30]) * ms,
                     "end": np.array([-1, -2, 1, 13, 70, 31]) * ms,
                     "parent": np.array([-1, 0, -1, -1, -1, 4]),
                     "replay": np.array([9, 9, 10, 11, 13, 13]),
                     "profiled": np.array([False, False, False, False, True,
                                           True])}
    snap["span_totals"] = {"capture": {"count": 2,
                                       "total_ns": 2_500_000_000}}
    snap["clock"], snap["launches"] = {}, {}
    return snap


EXPECTED = {
    "frame_device_ms.offline": 5.0,          # mean of 4, 5, 6
    "track_device_ms.offline": 8.0 / 3,
    "detect_device_ms.offline": 1.5,         # mean of 1, 1.5, 2
    "guided_device_ms.offline": 0.5,         # mean of 0.25, 0.5, 0.75
    "keyframe_device_ms.offline": 1.5,       # (2 - 0) and (2.5 - 1.5)
    "ba_device_ms.offline": 1.5,
    "between_frames_ms.offline": 1.1,        # 1005.1 - 1004, replays 10-11
    "finalize_device_ms.offline": 15.0,
    "map_retries_per_frame.offline": 1.0,    # 3 rungs in 3 frames
    "step_host_ms.live": 2.0,                # 1 and 3 ms: no profile, capture
    "frame_device_ms_p95.live": 5.9,
    "capture_s": 2.5,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_metric_reads_the_recorder(metric):
    from slambench import recorder, spec

    read = spec.load_module("metrics", metric).read
    assert read({recorder.KEY: _hand_made()}) == pytest.approx(
        EXPECTED[metric], rel=1e-12)
    with timing.recording(timing.Recorder()) as rec:
        empty = timing.snapshot(rec)
    assert read({recorder.KEY: empty}) is None
    assert read({recorder.KEY: None}) is None


def test_detect_metric_without_the_stage():
    """A recorder without the ``detect`` stage (an older port) gives the
    metric nothing to read: None, and no error."""
    from slambench import recorder, spec

    snap = _hand_made()
    k = S["detect"]
    snap["stages"] = snap["stages"][:k] + snap["stages"][k + 1:]
    for f in timing.FIELDS:
        snap[f] = np.delete(snap[f], k, axis=1)
    read = spec.load_module("metrics", "detect_device_ms.offline").read
    assert read({recorder.KEY: snap}) is None
    track = spec.load_module("metrics", "track_device_ms.offline").read
    assert track({recorder.KEY: snap}) == pytest.approx(8.0 / 3, rel=1e-12)


def test_guided_metric_without_the_stage():
    """A recorder without the ``guided`` stage (an older port) gives the
    metric nothing to read: None, and no error."""
    from slambench import recorder, spec

    snap = _hand_made()
    k = S["guided"]
    snap["stages"] = snap["stages"][:k] + snap["stages"][k + 1:]
    for f in timing.FIELDS:
        snap[f] = np.delete(snap[f], k, axis=1)
    read = spec.load_module("metrics", "guided_device_ms.offline").read
    assert read({recorder.KEY: snap}) is None
    track = spec.load_module("metrics", "track_device_ms.offline").read
    assert track({recorder.KEY: snap}) == pytest.approx(8.0 / 3, rel=1e-12)
