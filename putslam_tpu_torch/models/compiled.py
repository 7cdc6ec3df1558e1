"""The compiled frame: the SLAM and VO steps replayed from CUDA graphs.

The counterpart of the JAX package's ``jax.jit(slam_step)`` under
``lax.scan`` (``putslam_tpu/models/slam.py:213``, ``:615-622``). A JAX frame
is one device program that never returns to the host, its data-dependent
branches ``lax.cond``s. Here a frame is ``slam.slam_frame`` captured once
per (config, shapes) with ``torch.cuda.CUDAGraph`` and replayed, one replay
a frame: every ``utils/control.cond`` on its path (the VO retry, each
widening of the map retry ladder, the sorted observation slots, the
loop-closure verification, the keyframe bookkeeping, the bundle adjustment
and each of its Gauss-Newton iterations) is a conditional IF node, so the
card skips what the frame does not need and the host reads nothing:

    track → IF(not a keyframe){tail} → IF(keyframe){bookkeeping →
    IF(run_ba){BA: IF(~done){iteration} × gn_iterations} → finish}

The state, the frame's inputs and its ``SlamOutputs`` live in static
buffers that every replay reads and writes; ``step`` returns a device copy
of the outputs. The RANSAC uniforms are drawn into static buffers from the
caller's generator outside the graph, in the order the eager step draws
them (``slam.frame_draws``), so both paths see the same stream. The graphs
of one runner share one memory pool, and their IF bodies a second one
(``utils/graph_cond.py``), and replay in one order on one stream.

The VO paths are one graph a step as well: ``VoGraphs`` (matching VO:
detection + ``vo_step`` with its retry node + the pose update) and
``TrackGraphs`` (tracking VO, ``vo_version=1``: KLT, patch refine, RANSAC,
the masked refill with its level-0 FAST launch, the pose update). So is
the end of the run, as the JAX package jits ``finalize`` and
``gauss_newton_mm`` (``putslam_tpu/models/slam.py:789-896``,
``putslam_tpu/slam_map/archive.py:372-383``): ``FinalizeGraphs`` replays
``slam.finalize_map`` (both solves' Gauss-Newton iterations IF nodes, the
chi² prune and ``check_trajectory`` inside) and ``WindowGraphs`` one window
solve of the global BA, once per window. These end-of-run runners have a
cache of their own, so that they never evict a frame runner.

Before a capture the step runs once, masked (``control.branching
("masked")``: every branch, for the lazy initialisation of both sides) on a
side stream, under ``control.checking()``, which raises where a branch body
writes to a tensor it did not make. A capture or replay that fails raises:
there is no fallback to the eager step. ``capture=False`` runs the same
step on the same static buffers without graphs (on any device), each
``cond`` a host read of its predicate (``control.branching("host")``): the
CPU tests hold that against the eager step. ``fast_score_nms.launches``
counts one launch per replay of a graph that holds the FAST kernel (the
kernel launch a capture records); the warm-up pass is not counted. The
segment-sum kernel of the solvers counts its own launches on the card
(``ops/segment.py::launch_count``: those in an IF body run only where the
card takes the branch); the warm-up's are not counted either.
"""

from __future__ import annotations

import gc
import time
from collections import OrderedDict
from typing import Optional

import torch

from putslam_tpu_torch.backend import graph as graph_mod
from putslam_tpu_torch.backend import optimize as opt_mod
from putslam_tpu_torch.frontend import ransac as ransac_mod
from putslam_tpu_torch.frontend.detector import detect_and_describe
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.models import slam as slam_mod
from putslam_tpu_torch.models import vo as vo_mod
from putslam_tpu_torch.ops import fast_cuda, segment
from putslam_tpu_torch.utils import control, graph_cond
from putslam_tpu_torch.utils.control import assign as _assign
from putslam_tpu_torch.utils.control import clone as _clone
from putslam_tpu_torch.utils.control import leaves as _leaves
from putslam_tpu_torch.utils.device import as_tensor

# runners kept, each with its buffers and graph pools: the frame runners
# (SLAM, VO, tracking) and the end-of-run runners (finalize, the global
# BA's window solve) in caches of their own, so that the end of a run never
# evicts the frame runner that the next run of the same config replays
MAX_CACHED = 4
MAX_END_CACHED = 4
_RUNNERS: "OrderedDict[tuple, object]" = OrderedDict()
_END_RUNNERS: "OrderedDict[tuple, object]" = OrderedDict()


def graph_pool_bytes(pool) -> Optional[int]:
    """Bytes of device memory the caching allocator holds in ``pool`` (a
    ``CUDAGraph.pool()`` handle), or None where the snapshot does not say."""
    total, seen = 0, False
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            return None
        if tuple(seg["segment_pool_id"]) == tuple(pool):
            total += seg["total_size"]
            seen = True
    return total if seen else 0


def _draw_buffers(cfg, names, device) -> dict:
    """Static inputs for the RANSAC uniforms of the named calls."""
    shape = (cfg.ransac.used_pairs, cfg.ransac.n_hypotheses)
    return {n: torch.zeros(shape, device=device) for n in names}


def _abandon_capture(runner, stream) -> None:
    """Undo what a capture that raised leaves behind: where its end fails
    (a host read or another operation the capture refused),
    ``torch.cuda.graph`` leaves the capture stream current and the caching
    allocator routing into the graph's pool, and the allocator then aborts
    the process when a pool is freed. The error propagates."""
    torch.cuda.set_stream(stream)
    idx = runner.device.index
    if idx is None:
        idx = torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(idx, runner.pool)
    except RuntimeError:
        pass                 # the capture's own end released the routing


class _Segment:
    """One step ``fn(commit)`` of a runner: run with its branches read on
    the host (``capture`` False), or warmed up once on a side stream,
    captured into a CUDA graph in the runner's pool and replayed."""

    def __init__(self, runner, fn):
        self.runner = runner
        self.fn = fn
        self.graph = None
        self.out = None
        self.fast_launches = 0

    def _capture(self):
        r = self.runner
        t0 = time.perf_counter()
        side = torch.cuda.Stream(r.device)
        side.wait_stream(torch.cuda.current_stream(r.device))
        counted = fast_cuda.fast_score_nms.launches
        with torch.cuda.stream(side), control.branching("masked"), \
                control.checking(), segment.uncounted():
            self.fn(commit=False)          # lazy initialisation, not a step
        fast_cuda.fast_score_nms.launches = counted
        torch.cuda.current_stream(r.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        recorded = fast_cuda.fast_score_nms.recorded
        graph_cond.prepare(r.device, r.body_pool)
        stream = torch.cuda.current_stream(r.device)
        # a runner dropped earlier is freed by the cycle collector, which
        # may run at any allocation: its body pool destroyed during a
        # capture aborts the process (the allocator asserts that no
        # capture is under way), so collect before this one begins
        gc.collect()
        try:
            with torch.cuda.graph(graph, pool=r.pool), \
                    control.branching("capture"):
                self.out = self.fn(commit=True)
        except BaseException:
            _abandon_capture(r, stream)
            raise
        self.fast_launches = fast_cuda.fast_score_nms.recorded - recorded
        self.graph = graph
        r.captured = True
        r.capture_s += time.perf_counter() - t0

    def run(self):
        if not self.runner.capture:
            with control.branching("host"):
                self.out = self.fn(commit=True)
            return self.out
        if self.graph is None:
            self._capture()
        self.graph.replay()
        fast_cuda.fast_score_nms.launches += self.fast_launches
        return self.out


class _Runner:
    def __init__(self, device, capture: bool):
        self.device = torch.device(device)
        self.capture = capture
        self.pool = None
        self.captured = False
        self.capture_s = 0.0
        if capture:
            if self.device.type != "cuda":
                raise ValueError(f"CUDA graphs need a CUDA device, not "
                                 f"{self.device}")
            backend = torch.cuda.memory.get_allocator_backend()
            if backend != "native":
                # a conditional node's body may hold no allocation node
                raise RuntimeError(f"the graph runners need the caching "
                                   f"allocator's native backend, not "
                                   f"{backend!r}")
            self.pool = torch.cuda.graph_pool_handle()
            self.body_pool = torch.cuda.MemPool()

    def pool_mib(self) -> Optional[float]:
        """MiB of the graphs' memory pools, the graph's own and its IF
        bodies' (None before a capture, or where the allocator does not
        say)."""
        if not self.captured:
            return None
        b = [graph_pool_bytes(p) for p in (self.pool, self.body_pool.id)]
        return None if None in b else sum(b) / 2 ** 20


def _outputs_like(cfg, device) -> slam_mod.SlamOutputs:
    """Static buffers for a frame's SlamOutputs."""
    def z(shape=(), dtype=torch.bool):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    return slam_mod.SlamOutputs(
        pose=z((7,), f32), vo_ok=z(), map_ok=z(), n_map_matches=z((), i32),
        n_map_inliers=z((), i32), is_keyframe=z(), ba_ran=z(),
        chi2=z((cfg.backend.gn_iterations,), f32), n_landmarks=z((), i32),
        anchor_ring=z((), i32), anchor_seq=z((), i32),
        anchor_pose=z((7,), f32))


class SlamGraphs(_Runner):
    """The SLAM step (``playback`` or not) of one config and frame shape as
    one graph (``slam.slam_frame``) on static buffers: ``load`` a state,
    ``step`` frames; ``state`` holds the state after the last step
    (overwritten by the next one: clone what must outlive it), and
    ``frame.out`` the last frame's ``slam.Track``."""

    def __init__(self, cfg, state: slam_mod.SlamState, frame_shape,
                 playback: bool = False, capture: bool = True):
        super().__init__(state.pose.device, capture)
        self.cfg, self.playback = cfg, playback
        dev = self.device
        self.state = _clone(state)
        self.outs = _outputs_like(cfg, dev)
        self.gray = torch.zeros(tuple(frame_shape), device=dev)
        self.depth = torch.zeros(tuple(frame_shape), device=dev)
        self.gt_pose = se3.identity(device=dev) if playback else None
        self.draws = _draw_buffers(cfg, slam_mod.draw_names(cfg, playback),
                                   dev)
        self.frame = _Segment(self, self._frame)

    def _frame(self, commit):
        out = (self.state, self.outs)
        return slam_mod.slam_frame(self.cfg, self.state, self.gray,
                                   self.depth, self.draws,
                                   out if commit else _clone(out),
                                   self.gt_pose, self.playback)

    def load(self, state: slam_mod.SlamState) -> None:
        _assign(self.state, state)

    def step(self, gray, depth, draws: Optional[dict] = None,
             generator: Optional[torch.Generator] = None, gt_pose=None):
        """One frame. Returns its SlamOutputs (fresh tensors)."""
        self.gray.copy_(gray)
        self.depth.copy_(depth)
        if self.playback:
            self.gt_pose.copy_(as_tensor(gt_pose, self.device, torch.float32))
        if draws is None:
            slam_mod.frame_draws(self.cfg, generator, self.device,
                                 self.playback, out=self.draws)
        else:
            for name, buf in self.draws.items():
                buf.copy_(draws[name])
        self.frame.run()
        return _clone(self.outs)


class VoGraphs(_Runner):
    """The matching VO step of one config and frame shape as one segment:
    detect the frame, ``vo_step`` against the previous frame's features,
    advance the pose; ``load`` the first frame's features and pose."""

    def __init__(self, cfg, feat0, pose0, frame_shape, capture: bool = True):
        super().__init__(pose0.device, capture)
        self.cfg = cfg
        dev = self.device
        self.prev_feat = _clone(feat0)
        self.pose = pose0.clone()
        self.gray = torch.zeros(tuple(frame_shape), device=dev)
        self.depth = torch.zeros(tuple(frame_shape), device=dev)
        self.draws = _draw_buffers(cfg, vo_mod.vo_draw_names(cfg), dev)
        self.segment = _Segment(self, self._step)

    def _step(self, commit):
        feat = detect_and_describe(self.cfg, self.gray, self.depth)
        res = vo_mod.vo_step(self.cfg, self.prev_feat, feat,
                             u=self.draws["vo"],
                             u_retry=self.draws.get("vo_retry"))
        pose = se3.compose(self.pose, res.rel_pose)
        if commit:
            _assign((self.prev_feat, self.pose), (feat, pose))
        return res, pose

    def load(self, feat0, pose0) -> None:
        _assign((self.prev_feat, self.pose), (feat0, pose0))

    def step(self, gray, depth, u: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        """One step. Returns (VOStepResult, pose) (fresh tensors)."""
        self.gray.copy_(gray)
        self.depth.copy_(depth)
        if u is None:
            vo_mod.vo_draws(self.cfg, generator, self.device, out=self.draws)
        else:
            # the step's given uniforms; the retry's from the generator,
            # as the eager vo_step draws them
            self.draws["vo"].copy_(u)
            if "vo_retry" in self.draws:
                ransac_mod.draw_uniforms(self.cfg.ransac, generator,
                                         self.device,
                                         out=self.draws["vo_retry"])
        return _clone(self.segment.run())


class TrackGraphs(_Runner):
    """The tracking VO step (``vo_version=1``) of one config and frame
    shape as one graph: ``vo_step_tracking`` (KLT, patch refine, RANSAC,
    the masked refill with its level-0 FAST launch) and the pose update;
    ``load`` the first frame's tracks and pose."""

    def __init__(self, cfg, ts0: vo_mod.TrackState, pose0, frame_shape,
                 capture: bool = True):
        super().__init__(pose0.device, capture)
        self.cfg = cfg
        dev = self.device
        self.ts = _clone(ts0)
        self.pose = pose0.clone()
        self.gray = torch.zeros(tuple(frame_shape), device=dev)
        self.depth = torch.zeros(tuple(frame_shape), device=dev)
        self.draws = _draw_buffers(cfg, ["vo"], dev)
        self.segment = _Segment(self, self._step)

    def _step(self, commit):
        ts, res = vo_mod.vo_step_tracking(self.cfg, self.ts, self.gray,
                                          self.depth, u=self.draws["vo"])
        pose = se3.compose(self.pose, res.rel_pose)
        if commit:
            _assign((self.ts, self.pose), (ts, pose))
        return res, pose

    def load(self, ts0: vo_mod.TrackState, pose0) -> None:
        _assign((self.ts, self.pose), (ts0, pose0))

    def step(self, gray, depth, u: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        """One step. Returns (VOStepResult, pose) (fresh tensors)."""
        self.gray.copy_(gray)
        self.depth.copy_(depth)
        if u is None:
            ransac_mod.draw_uniforms(self.cfg.ransac, generator, self.device,
                                     out=self.draws["vo"])
        else:
            self.draws["vo"].copy_(u)
        return _clone(self.segment.run())


class FinalizeGraphs(_Runner):
    """``slam.finalize_map`` (the end-of-run polish: release, BA, chi²
    prune, BA, ``check_trajectory``) of one config and map / graph layout
    as one graph on static buffers, each Gauss-Newton iteration of both
    solves an IF node on ``~done``: ``run(state)`` loads the state's map
    and graph, replays and returns the polished state; ``chi2`` holds the
    two solves' chi² (2, final_gn_iterations) of the last run."""

    def __init__(self, cfg, state: slam_mod.SlamState, capture: bool = True):
        super().__init__(state.pose.device, capture)
        self.cfg = cfg
        self.map = _clone(state.map)
        self.graph = _clone(state.graph)
        self.chi2 = None
        self.segment = _Segment(self, self._polish)

    def _polish(self, commit):
        return slam_mod.finalize_map(self.cfg, self.map, self.graph)

    def run(self, state: slam_mod.SlamState) -> slam_mod.SlamState:
        """The finalized state (fresh tensors for the map and graph)."""
        _assign((self.map, self.graph), (state.map, state.graph))
        m, g, self.chi2 = _clone(self.segment.run())
        return state._replace(map=m, graph=g)


class WindowGraphs(_Runner):
    """One window solve of ``archive.global_bundle_adjust`` (``gauss_newton_mm``
    on the window's padded arrays) for one backend config, camera and set
    of caps as one graph on static buffers, each Gauss-Newton iteration an
    IF node on ``~done``: ``solve`` loads a window and replays."""

    def __init__(self, bcfg, cam, kf_cap: int, lm_cap: int, device,
                 capture: bool = True):
        super().__init__(device, capture)
        self.bcfg, self.cam = bcfg, cam
        dev = self.device
        kf_sub = se3.identity((kf_cap,), device=dev)
        lm_sub = torch.zeros((lm_cap, 3), device=dev)
        g = graph_mod.init_graph(bcfg.max_observations,
                                 bcfg.max_pose_pose_edges, dev)

        def flags(n):
            return torch.zeros((n,), dtype=torch.bool, device=dev)

        # kf_sub, kf_valid, lm_sub, lm_valid, graph, frozen
        self.args = (kf_sub, flags(kf_cap), lm_sub, flags(lm_cap), g,
                     flags(kf_cap))
        self.segment = _Segment(self, self._solve)

    def _solve(self, commit):
        res = opt_mod.gauss_newton_mm(self.bcfg, *self.args, cam=self.cam)
        return res.kf_pose, res.lm_pos

    def solve(self, kf_sub, kf_valid, lm_sub, lm_valid, g, frozen):
        """The window's (kf_pose, lm_pos) after the solve (fresh tensors);
        the arguments may lie on the host."""
        _assign(self.args, (kf_sub, kf_valid, lm_sub, lm_valid, g, frozen))
        return _clone(self.segment.run())


def _signature(tree):
    return tuple((tuple(x.shape), x.dtype) for x in _leaves(tree))


def _cached(key, make, cache=None, limit=None):
    """The runner of ``key`` in ``cache`` (the frame runners' by default),
    made by ``make`` on first use; the least recently used beyond
    ``limit`` are dropped."""
    if cache is None:
        cache, limit = _RUNNERS, MAX_CACHED
    runner = cache.get(key)
    if runner is None:
        runner = cache[key] = make()
        while len(cache) > limit:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    return runner


def clear_cache() -> None:
    """Drop the cached runners and free their buffers, graphs and pools
    now (a runner and its segments form a reference cycle)."""
    _RUNNERS.clear()
    _END_RUNNERS.clear()
    gc.collect()


def finalize_runner(cfg, state, capture: bool = True) -> FinalizeGraphs:
    """The cached finalize runner of this config, state layout and mode,
    made on first use; its graph is captured on its first run."""
    key = ("finalize", cfg, capture, state.pose.device,
           _signature((state.map, state.graph)))
    return _cached(key, lambda: FinalizeGraphs(cfg, state, capture),
                   _END_RUNNERS, MAX_END_CACHED)


def window_runner(bcfg, cam, kf_cap: int, lm_cap: int, device,
                  capture: bool = True) -> WindowGraphs:
    """The cached window-solve runner of this backend config (its
    ``max_observations`` and ``max_pose_pose_edges`` are the window's
    observation and edge caps), camera, caps and mode."""
    dev = torch.device(device)
    key = ("window", bcfg, cam, kf_cap, lm_cap, capture, dev)
    return _cached(key, lambda: WindowGraphs(bcfg, cam, kf_cap, lm_cap, dev,
                                             capture),
                   _END_RUNNERS, MAX_END_CACHED)


def slam_runner(cfg, state, frame_shape, playback: bool = False,
                capture: bool = True) -> SlamGraphs:
    """The cached runner of this config, state layout, frame shape and
    mode, made on first use. Its graphs are captured on its first frames."""
    key = ("slam", cfg, playback, capture, state.pose.device,
           tuple(frame_shape), _signature(state))
    return _cached(key, lambda: SlamGraphs(cfg, state, frame_shape,
                                           playback, capture))


def run_sequence(cfg, state, grays, depths, draws=None,
                 generator: Optional[torch.Generator] = None, gt_poses=None,
                 capture: bool = True):
    """``slam_sequence`` (or, with ``gt_poses``, ``slam_sequence_playback``)
    through a runner. Returns (state, stacked outputs); the state is the
    runner's, cloned."""
    playback = gt_poses is not None
    runner = slam_runner(cfg, state, grays.shape[1:], playback, capture)
    runner.load(state)
    outs = [runner.step(grays[i], depths[i],
                        draws=None if draws is None else draws[i],
                        generator=generator,
                        gt_pose=None if gt_poses is None else gt_poses[i])
            for i in range(grays.shape[0])]
    return _clone(runner.state), slam_mod._stack_outputs(outs)


def _run_steps(kind, make, carry0, cfg, grays, depths, init_pose, draws,
               generator, capture):
    """A VO sequence through the cached runner ``make(carry0)`` of ``kind``:
    frame 0 eagerly (``carry0``), every later frame one replay. Returns
    (poses (T, 7), stacked per-step results or None)."""
    key = (kind, cfg, capture, init_pose.device, tuple(grays.shape[1:]),
           init_pose.dtype)
    runner = _cached(key, lambda: make(cfg, carry0, init_pose,
                                       grays.shape[1:], capture))
    runner.load(carry0, init_pose)
    steps, poses = [], [init_pose]
    for i in range(1, grays.shape[0]):
        res, pose = runner.step(grays[i], depths[i],
                                u=None if draws is None else draws[i - 1],
                                generator=generator)
        steps.append(res)
        poses.append(pose)
    stats = vo_mod.VOStepResult(*(torch.stack(x) for x in zip(*steps))) \
        if steps else None
    return torch.stack(poses), stats


def vo_run_sequence(cfg, grays, depths, init_pose, draws=None,
                    generator: Optional[torch.Generator] = None,
                    capture: bool = True):
    """``vo_sequence`` through a runner: frame 0 detected eagerly, every
    later frame one replay. Returns (poses (T, 7) before the final
    normalisation, stacked per-step results or None)."""
    feat0 = detect_and_describe(cfg, grays[0], depths[0])
    return _run_steps("vo", VoGraphs, feat0, cfg, grays, depths, init_pose,
                      draws, generator, capture)


def track_run_sequence(cfg, grays, depths, init_pose, draws=None,
                       generator: Optional[torch.Generator] = None,
                       capture: bool = True):
    """``vo_sequence_tracking`` through a runner: frame 0's tracks detected
    eagerly, every later frame one replay. Returns (poses (T, 7), stacked
    per-step results or None)."""
    ts0 = vo_mod.init_tracking(cfg, grays[0], depths[0])
    return _run_steps("track", TrackGraphs, ts0, cfg, grays, depths,
                      init_pose, draws, generator, capture)
