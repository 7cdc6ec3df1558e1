"""The compiled frame: the SLAM and VO steps replayed from CUDA graphs.

The counterpart of the JAX package's ``jax.jit(slam_step)`` under
``lax.scan`` (``putslam_tpu/models/slam.py:213``, ``:615-622``). A JAX frame
is one device program; here a frame is split into the fixed-shape segments
of ``models/slam.py``, each captured once per (config, shapes) with
``torch.cuda.CUDAGraph`` and replayed:

* **track** (``slam_track``): detection with the FAST kernel, VO, guided
  matching with the whole retry ladder, the correction gate, the keyframe
  and BA decisions and the frame as it ends if it is no keyframe (the
  masked loop-closure pop and verification included). It commits that end
  into the state masked by the keyframe flag, so a keyframe's segments
  still read the frame's start.
* one packed host read of [is_keyframe, run_ba] (``slam.read_flags``);
* **keyframe** (``slam_keyframe``): the map, graph and loop-closure
  bookkeeping; then the bundle adjustment, eager, on its cadence (its chi²
  stop test reads the card), written into the segment's outputs;
* **finish** (``slam_finish``): compression, re-anchor, smoothing, EKF and
  the state update.

A frame that is no keyframe is one replay and one host read. The state and
the frame's inputs live in static buffers that every replay reads and
writes; the RANSAC uniforms are drawn into static buffers from the caller's
generator outside the graphs, in the order the eager step draws them
(``slam.frame_draws``), so both paths see the same stream. The graphs of one
runner share one memory pool and replay in one order on one stream.

The VO-only path (``vo_sequence``) captures detection + ``vo_step`` + the
pose update as one segment and reads nothing on the host.

A capture or replay that fails raises: there is no fallback to the eager
step. ``capture=False`` runs the same segments on the same static buffers
without graphs (on any device): the CPU tests hold that against the eager
step. ``fast_score_nms.launches`` counts one launch per replay of a
segment that holds the FAST kernel (the kernel launch a capture records);
the warm-up pass before a capture is not counted.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional

import torch

from putslam_tpu_torch.frontend import ransac as ransac_mod
from putslam_tpu_torch.frontend.detector import detect_and_describe
from putslam_tpu_torch.geometry import se3
from putslam_tpu_torch.models import slam as slam_mod
from putslam_tpu_torch.models import vo as vo_mod
from putslam_tpu_torch.ops import fast_cuda
from putslam_tpu_torch.utils.device import as_tensor

MAX_CACHED = 4      # runners kept, each with its buffers and graph pool
_RUNNERS: "OrderedDict[tuple, object]" = OrderedDict()


def _leaves(tree):
    """The tensors of a tree of NamedTuples, tuples, lists and dicts, in
    order; None leaves are skipped."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


def _clone(tree):
    if tree is None or torch.is_tensor(tree):
        return None if tree is None else tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    items = [_clone(x) for x in tree]
    if hasattr(tree, "_fields"):           # a NamedTuple
        return type(tree)(*items)
    return type(tree)(items)


def _assign(dst, src, where=None):
    """Copy every leaf of ``src`` into the leaf of ``dst`` at its place
    (``where``: a 0-d bool, True keeps ``dst``). Leaves that are ``dst``'s
    own are skipped; a source that shares storage with a destination is
    read before any destination is written."""
    pairs = [(d, s) for d, s in zip(_leaves(dst), _leaves(src)) if s is not d]
    if where is not None:
        pairs = [(d, torch.where(where, d, s)) for d, s in pairs]
    held = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in held else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


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


class _Segment:
    """One segment ``fn(commit)`` of a runner: run eagerly (``capture``
    False), or warmed up once on a side stream, captured into a CUDA graph
    in the runner's pool and replayed."""

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
        with torch.cuda.stream(side):
            self.fn(commit=False)          # lazy initialisation, not a frame
        fast_cuda.fast_score_nms.launches = counted
        torch.cuda.current_stream(r.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        recorded = fast_cuda.fast_score_nms.recorded
        with torch.cuda.graph(graph, pool=r.pool):
            self.out = self.fn(commit=True)
        self.fast_launches = fast_cuda.fast_score_nms.recorded - recorded
        if r.pool is None:
            r.pool = graph.pool()
        self.graph = graph
        r.capture_s += time.perf_counter() - t0

    def run(self):
        if not self.runner.capture:
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
        if capture and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        self.capture = capture
        self.pool = None
        self.capture_s = 0.0

    def pool_mib(self) -> Optional[float]:
        """MiB of the graphs' memory pool (None before a capture, or where
        the allocator does not say)."""
        if self.pool is None:
            return None
        b = graph_pool_bytes(self.pool)
        return None if b is None else b / 2 ** 20


class SlamGraphs(_Runner):
    """The SLAM step (``playback`` or not) of one config and frame shape as
    three segments on static buffers: ``load`` a state, ``step`` frames,
    ``state`` holds the state after the last step (overwritten by the next
    one: clone what must outlive it)."""

    def __init__(self, cfg, state: slam_mod.SlamState, frame_shape,
                 playback: bool = False, capture: bool = True):
        super().__init__(state.pose.device, capture)
        self.cfg, self.playback = cfg, playback
        dev = self.device
        self.state = _clone(state)
        self.gray = torch.zeros(tuple(frame_shape), device=dev)
        self.depth = torch.zeros(tuple(frame_shape), device=dev)
        self.gt_pose = se3.identity(device=dev) if playback else None
        self.draws = _draw_buffers(cfg, slam_mod.draw_names(cfg, playback),
                                   dev)
        self.track = _Segment(self, self._track)
        self.keyframe = _Segment(self, self._keyframe)
        self.finish = _Segment(self, self._finish)

    def _track(self, commit):
        tr = slam_mod.slam_track(self.cfg, self.state, self.gray, self.depth,
                                 self.draws, self.gt_pose, self.playback)
        if commit:
            # a frame that is no keyframe ends here; on a keyframe the state
            # stays as the frame found it, for the keyframe segments
            _assign(self.state, tr.tail_state, where=tr.flags[0])
        return tr

    def _keyframe(self, commit):
        kb = slam_mod.slam_keyframe(self.cfg, self.state, self.track.out,
                                    self.draws)
        # the bundle adjustment writes into these between the replays: they
        # must be the segment's own
        state_leaves = {id(x) for x in _leaves(self.state)}
        own = [kb.map.kf_pose, kb.map.lm_pos, kb.graph.obs_valid, kb.chi2]
        if any(id(x) in state_leaves for x in own):
            raise RuntimeError("keyframe segment returned a state buffer "
                               "for a BA output")
        return kb

    def _finish(self, commit):
        state, outs = slam_mod.slam_finish(self.cfg, self.state,
                                           self.track.out, self.keyframe.out,
                                           self.playback)
        if commit:
            _assign(self.state, state)
        return outs

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
        tr = self.track.run()
        is_kf, do_ba = slam_mod.read_flags(tr)
        if not is_kf:
            return _clone(tr.tail_outs)
        kb = self.keyframe.run()
        if do_ba:
            kf_pose, lm_pos, obs_valid, chi2 = slam_mod.bundle_adjust(
                self.cfg, kb.map, kb.graph)
            kb.map.kf_pose.copy_(kf_pose)
            kb.map.lm_pos.copy_(lm_pos)
            kb.graph.obs_valid.copy_(obs_valid)
            kb.chi2.copy_(chi2)
        return _clone(self.finish.run())


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


def _signature(tree):
    return tuple((tuple(x.shape), x.dtype) for x in _leaves(tree))


def _cached(key, make):
    runner = _RUNNERS.get(key)
    if runner is None:
        runner = _RUNNERS[key] = make()
        while len(_RUNNERS) > MAX_CACHED:
            _RUNNERS.popitem(last=False)
    else:
        _RUNNERS.move_to_end(key)
    return runner


def clear_cache() -> None:
    """Drop the cached runners (their buffers, graphs and pools)."""
    _RUNNERS.clear()


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


def vo_run_sequence(cfg, grays, depths, init_pose, draws=None,
                    generator: Optional[torch.Generator] = None,
                    capture: bool = True):
    """``vo_sequence`` through a runner: frame 0 detected eagerly, every
    later frame one replay. Returns (poses (T, 7) before the final
    normalisation, stacked per-step results or None)."""
    feat0 = detect_and_describe(cfg, grays[0], depths[0])
    key = ("vo", cfg, capture, init_pose.device, tuple(grays.shape[1:]),
           init_pose.dtype)
    runner = _cached(key, lambda: VoGraphs(cfg, feat0, init_pose,
                                           grays.shape[1:], capture))
    runner.load(feat0, init_pose)
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
