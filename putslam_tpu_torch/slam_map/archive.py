"""Host-side map archive and offline global bundle adjustment, the port's
counterpart of ``putslam_tpu/slam_map/archive.py:39-388``.

The engine runs on fixed-capacity device rings (keyframes K, landmarks L,
observations M); on long sequences the rings wrap and evicted history is
gone from the device state.

* ``MapArchive.absorb(state)``, called once per streamed chunk, snapshots
  every live keyframe and landmark and the edges appended since the last
  absorb. Slot recycling is undone by keying on (slot, generation): each
  generation of a ring slot is its own global vertex. The 25 small ring
  stores are fetched with one device synchronisation (``_fetch``).
* ``global_bundle_adjust`` polishes the full archived graph by overlapping
  windowed sweeps of ``backend.optimize.gauss_newton_mm`` (or, over a mesh,
  of ``parallel.dist_ba.dist_gauss_newton``): each window's
  subproblem (free keyframes plus the frozen keyframes and the landmarks
  that anchor it) is assembled on the host into fixed-shape padded arrays.
  Back-to-front sweeps with 50 % overlap carry corrections along the
  trajectory without ever forming a (6·K_total)² system.

The archive itself is numpy on the host, as in the JAX package; the two
archives hold equal arrays after absorbing equal states.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from putslam_tpu_torch.backend import optimize as opt_mod
from putslam_tpu_torch.backend.graph import GraphState
from putslam_tpu_torch.parallel import dist_ba
from putslam_tpu_torch.utils.device import resolve_device

_GEN_BASE = np.int64(1) << 24  # (slot, gen) -> slot * _GEN_BASE + gen codes


class _CodeMap:
    """Vectorised (slot, gen) → dense-id mapper
    (``putslam_tpu/slam_map/archive.py:39``): codes are int64 slot·2²⁴+gen;
    ``lookup`` resolves arrays of codes in bulk, ``assign`` allocates
    consecutive ids for unseen codes in bulk."""

    def __init__(self):
        self._map: Dict[int, int] = {}

    def __len__(self):
        return len(self._map)

    def assign(self, codes: np.ndarray) -> np.ndarray:
        """codes (R,) int64 → ids (R,), allocating new ids for new codes."""
        uniq = np.unique(codes)
        new = [c for c in uniq.tolist() if c not in self._map]
        base = len(self._map)
        for off, c in enumerate(new):
            self._map[c] = base + off
        lut = np.array([self._map[c] for c in uniq.tolist()], np.int64)
        return lut[np.searchsorted(uniq, codes)]

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        """codes (R,) int64 → ids (R,), -1 for unknown codes."""
        uniq, inv = np.unique(codes, return_inverse=True)
        lut = np.array([self._map.get(c, -1) for c in uniq.tolist()],
                       np.int64)
        return lut[inv]


def _fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as numpy arrays. CUDA tensors are copied into pinned host
    buffers without blocking and the stream is synchronised once, so one
    absorb costs one host sync, not one per array (the counterpart of the
    reference's single ``jax.device_get``)."""
    if not tensors[0].is_cuda:
        return [t.detach().numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t.detach(), non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


class MapArchive:
    """Append-only host archive of the SLAM graph across ring evictions
    (``putslam_tpu/slam_map/archive.py:71``). Storage is chunked numpy, one
    batch of arrays per ``absorb``; ``dense()`` concatenates the chunks."""

    def __init__(self):
        self.kf_pose: Dict[int, np.ndarray] = {}     # seq -> (7,)
        self._kf_seq_of_code: Dict[int, int] = {}    # code -> seq
        self._lm_codes = _CodeMap()                  # (slot, gen) code -> id
        self._lm_pos_arr = np.zeros((0, 3), np.float32)  # by dense lm id
        self.obs_chunks: List[Tuple[np.ndarray, ...]] = []
        self.pp_chunks: List[Tuple[np.ndarray, ...]] = []
        self._n_obs = 0
        self._n_pp_edges = 0
        self._n_obs_seen = 0
        self._n_pp_seen = 0

    @property
    def obs(self):
        """Sized view for callers doing ``len(archive.obs)``."""
        return range(self._n_obs)

    def absorb(self, state) -> None:
        """Snapshot the live vertices and the newly appended edges of a
        ``SlamState`` (``putslam_tpu/slam_map/archive.py:97``)."""
        m, g = state.map, state.graph
        (kf_seq, kf_gen, kf_valid, kf_pose, lm_valid, lm_gen, lm_pos,
         obs_seq, n_obs_d, obs_valid_d, obs_kf_d, obs_kfgen_d, obs_lm_d,
         obs_gen_d, obs_xyz_d, obs_w_d, obs_info_d,
         n_pp_d, pp_i_d, pp_j_d, pp_gi_d, pp_gj_d, pp_rel_d, pp_w_d,
         pp_valid_d) = _fetch(
            (m.kf_seq, m.kf_gen, m.kf_valid, m.kf_pose, m.lm_valid,
             m.lm_gen, m.lm_pos, g.obs_seq, g.n_obs, g.obs_valid, g.obs_kf,
             g.obs_kfgen, g.obs_lm, g.obs_gen, g.obs_xyz, g.obs_w,
             g.obs_info, g.n_pp, g.pp_i, g.pp_j, g.pp_gen_i, g.pp_gen_j,
             g.pp_rel, g.pp_w, g.pp_valid))
        # slots and generations are int32 on the device: widen before the
        # slot·2²⁴ multiply
        kf_gen = kf_gen.astype(np.int64)
        live = np.nonzero(kf_valid)[0]
        live_codes = live.astype(np.int64) * _GEN_BASE + kf_gen[live]
        for slot, code in zip(live.tolist(), live_codes.tolist()):
            seq = int(kf_seq[slot])
            self.kf_pose[seq] = kf_pose[slot].copy()
            self._kf_seq_of_code[code] = seq

        lm_gen = lm_gen.astype(np.int64)
        lslots = np.nonzero(lm_valid)[0]
        if len(lslots):
            lcodes = lslots.astype(np.int64) * _GEN_BASE + lm_gen[lslots]
            gids = self._lm_codes.assign(lcodes)
            need = len(self._lm_codes)
            if need > len(self._lm_pos_arr):
                grow = np.zeros((max(need, 2 * len(self._lm_pos_arr) + 64), 3),
                                np.float32)
                grow[:len(self._lm_pos_arr)] = self._lm_pos_arr
                self._lm_pos_arr = grow
            self._lm_pos_arr[gids] = lm_pos[lslots]

        # new observations since the last absorb, by append sequence number
        n_now = int(n_obs_d)
        fresh = (obs_seq >= self._n_obs_seen) & obs_valid_d
        if fresh.any():
            idx = np.nonzero(fresh)[0]
            idx = idx[np.argsort(obs_seq[idx], kind="stable")]
            o_kf = obs_kf_d[idx].astype(np.int64)
            o_kfg = obs_kfgen_d[idx].astype(np.int64)
            o_lm = obs_lm_d[idx].astype(np.int64)
            o_g = obs_gen_d[idx].astype(np.int64)
            seqs = self._kf_seqs(o_kf * _GEN_BASE + o_kfg)
            keep = seqs >= 0
            if keep.any():
                gids = self._lm_codes.assign(
                    (o_lm * _GEN_BASE + o_g)[keep])
                self.obs_chunks.append((
                    seqs[keep].astype(np.int32), gids.astype(np.int32),
                    obs_xyz_d[idx][keep].copy(),
                    obs_w_d[idx][keep].copy(),
                    obs_info_d[idx][keep].copy()))
                self._n_obs += int(keep.sum())
        self._n_obs_seen = n_now

        # new pose-pose edges (plain cursor ring): a bulk slice of the ring
        n_pp = int(n_pp_d)
        E = g.pp_capacity
        if n_pp > self._n_pp_seen:
            lo = max(self._n_pp_seen, n_pp - E)
            s = np.arange(lo, n_pp) % E
            s = s[pp_valid_d[s]]
            if len(s):
                ci = pp_i_d[s].astype(np.int64) * _GEN_BASE + pp_gi_d[s]
                cj = pp_j_d[s].astype(np.int64) * _GEN_BASE + pp_gj_d[s]
                both = self._kf_seqs(np.concatenate([ci, cj])).reshape(2, -1)
                keep = (both >= 0).all(axis=0)
                if keep.any():
                    self.pp_chunks.append((
                        both[0][keep].astype(np.int32),
                        both[1][keep].astype(np.int32),
                        pp_rel_d[s][keep].copy(),
                        pp_w_d[s][keep].copy()))
                    self._n_pp_edges += int(keep.sum())
        self._n_pp_seen = n_pp

    def _kf_seqs(self, codes: np.ndarray) -> np.ndarray:
        """Keyframe (slot, gen) codes → sequence numbers, -1 where unknown:
        one dict look-up per unique code."""
        uniq, inv = np.unique(codes, return_inverse=True)
        lut = np.array([self._kf_seq_of_code.get(c, -1)
                        for c in uniq.tolist()], np.int64)
        return lut[inv.reshape(-1)]

    # -- dense views ------------------------------------------------------
    def n_keyframes(self) -> int:
        return len(self.kf_pose)

    def dense(self):
        """(kf_pose (N,7) by seq, lm_pos, obs arrays, pp arrays) as numpy
        (``putslam_tpu/slam_map/archive.py:201``)."""
        n = self.n_keyframes()
        kf = np.zeros((n, 7), np.float32)
        kf[:, 3] = 1.0
        for seq, p in self.kf_pose.items():
            if 0 <= seq < n:
                kf[seq] = p
        L = len(self._lm_codes)
        lm = self._lm_pos_arr[:L].copy()
        if self.obs_chunks:
            obs = tuple(np.concatenate([c[k] for c in self.obs_chunks])
                        for k in range(5))
        else:
            obs = (np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                   np.zeros((0, 3), np.float32), np.zeros((0,), np.float32),
                   np.zeros((0, 3, 3), np.float32))
        if self.pp_chunks:
            pp = tuple(np.concatenate([c[k] for c in self.pp_chunks])
                       for k in range(4))
        else:
            pp = (np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                  np.zeros((0, 7), np.float32), np.zeros((0,), np.float32))
        return kf, lm, obs, pp


def _pad_to(x: np.ndarray, n: int, fill=0):
    """First ``n`` rows of ``x``, padded with ``fill`` to ``n`` rows
    (``putslam_tpu/slam_map/archive.py:237``)."""
    out = np.full((n,) + x.shape[1:], fill, x.dtype)
    out[:len(x)] = x[:n]
    return out


def global_bundle_adjust(cfg, archive: MapArchive,
                         window: int = 192, kf_cap: int = 384,
                         lm_cap: int = 4096, obs_cap: int = 32768,
                         pp_cap: int = 2048, sweeps: int = 2,
                         gn_iterations: int = 8, mesh=None, device="cuda"):
    """Offline full-graph polish by overlapping windowed sweeps
    (``putslam_tpu/slam_map/archive.py:243``).

    Returns kf_pose_polished (N,7) numpy, indexed by keyframe sequence
    number. Each sweep walks windows back to front with 50 % overlap; a
    window's subproblem is its free keyframes plus every observation of any
    landmark they observe (also from frozen keyframes, the anchors), padded
    to fixed shapes. The solves run on ``device``.

    The reference maps archive ids to window ids with a Python dict per
    observation; here a look-up table and ``searchsorted`` give the same
    arrays.

    A window whose reduced system is not positive definite takes a zero step
    in every iteration and leaves its keyframes where they were.

    ``mesh``: a ``parallel.mesh.Mesh`` of more than one rank runs each
    window's solve through the landmark-sharded BA
    (``parallel/dist_ba.py``; ``putslam_tpu/slam_map/archive.py:265-270,
    362-377``); every rank calls this with the same archive, and
    ``lm_cap`` must divide the mesh size. A window whose owner partition
    would drop observations is solved again by ``gauss_newton_mm`` (on every
    rank alike). A mesh of one rank takes the single-device path."""
    if mesh is not None and mesh.size > 1:
        if lm_cap % mesh.size:
            raise ValueError(f"lm_cap {lm_cap} must divide the mesh size "
                             f"{mesh.size} for the sharded solver")
    else:
        mesh = None
    dev = resolve_device(device)

    kf, lm, (obs_kf, obs_lm, obs_xyz, obs_w, obs_info), \
        (pp_i, pp_j, pp_rel, pp_w) = archive.dense()
    N = len(kf)
    if N == 0 or len(obs_kf) == 0:
        return kf
    lm = lm.copy()

    bcfg = dataclasses.replace(
        cfg.backend, gn_iterations=gn_iterations, ba_window=window,
        ba_lm_block=0, max_observations=obs_cap, max_pose_pose_edges=pp_cap)

    starts: List[int] = []
    a = max(0, N - window)
    while True:
        starts.append(a)
        if a == 0:
            break
        a = max(0, a - window // 2)

    def up(x):
        return torch.as_tensor(x, device=dev)

    K = kf_cap
    zeros_obs = np.zeros((obs_cap,), np.int32)
    for _ in range(sweeps):
        for a in starts:
            b = min(a + window, N)
            in_win = (obs_kf >= a) & (obs_kf < b)
            lm_set = np.unique(obs_lm[in_win])[:lm_cap]
            sel = np.isin(obs_lm, lm_set)
            sel_idx = np.nonzero(sel)[0][:obs_cap]
            if len(sel_idx) == 0:
                continue
            kf_used = np.unique(obs_kf[sel_idx])
            # pose-pose edges touching the window drag their far endpoint in
            # as a frozen anchor: long-range loop-closure constraints must
            # reach across windows
            if len(pp_i):
                touch = ((pp_i >= a) & (pp_i < b)) | ((pp_j >= a) & (pp_j < b))
                kf_used = np.unique(np.concatenate(
                    [kf_used, pp_i[touch], pp_j[touch]]))
            # free window keyframes first, then frozen anchors, cap kf_cap
            free_k = kf_used[(kf_used >= a) & (kf_used < b)]
            froz_k = kf_used[(kf_used < a) | (kf_used >= b)]
            if len(free_k) == 0:
                continue
            kf_list = np.concatenate([free_k, froz_k])[:kf_cap]
            free_k = free_k[:kf_cap]
            kf_of = np.full((N,), -1, np.int32)     # archive seq -> window row
            kf_of[kf_list] = np.arange(len(kf_list), dtype=np.int32)
            sel_idx = sel_idx[kf_of[obs_kf[sel_idx]] >= 0]
            if len(sel_idx) == 0:
                continue

            o_n = len(sel_idx)
            n_valid = np.arange(obs_cap) < o_n
            pp_keep = (kf_of[pp_i] >= 0) & (kf_of[pp_j] >= 0)
            pn = min(int(pp_keep.sum()), pp_cap)
            ident = np.zeros((pp_cap, 7), np.float32)
            ident[:, 3] = 1.0
            ident[:pn] = pp_rel[pp_keep][:pn]
            zeros_pp = np.zeros((pp_cap,), np.int32)
            g = GraphState(
                obs_kf=up(_pad_to(kf_of[obs_kf[sel_idx]], obs_cap)),
                obs_lm=up(_pad_to(np.searchsorted(
                    lm_set, obs_lm[sel_idx]).astype(np.int32), obs_cap)),
                obs_xyz=up(_pad_to(obs_xyz[sel_idx], obs_cap)),
                obs_w=up(_pad_to(obs_w[sel_idx], obs_cap)),
                obs_gen=up(zeros_obs), obs_kfgen=up(zeros_obs),
                obs_seq=up(zeros_obs), obs_valid=up(n_valid),
                n_obs=up(np.int32(o_n)),
                obs_info=up(_pad_to(obs_info[sel_idx], obs_cap)),
                pp_i=up(_pad_to(kf_of[pp_i[pp_keep]], pp_cap)),
                pp_j=up(_pad_to(kf_of[pp_j[pp_keep]], pp_cap)),
                pp_rel=up(ident),
                pp_w=up(_pad_to(pp_w[pp_keep], pp_cap)),
                pp_gen_i=up(zeros_pp), pp_gen_j=up(zeros_pp),
                pp_valid=up(np.arange(pp_cap) < pn), n_pp=up(np.int32(pn)))

            kf_sub = _pad_to(kf[kf_list], K)
            kf_sub[len(kf_list):, 3] = 1.0
            kf_valid = np.arange(K) < len(kf_list)
            frozen = np.ones((K,), bool)
            frozen[:len(free_k)] = False
            if a == 0:
                frozen[0] = True  # gauge: fix keyframe 0 in the oldest window
            lm_sub = _pad_to(lm[lm_set], lm_cap)
            lm_valid = np.arange(lm_cap) < len(lm_set)

            args = (up(kf_sub), up(kf_valid), up(lm_sub), up(lm_valid), g,
                    up(frozen))
            overflow = 0
            if mesh is not None:
                kf_o, lm_o, _, overflow = dist_ba.dist_gauss_newton(
                    bcfg, mesh, *args, up(np.zeros((lm_cap,), np.int32)),
                    cam=cfg.camera)
            if mesh is None or int(overflow) > 0:
                res = opt_mod.gauss_newton_mm(bcfg, *args, cam=cfg.camera)
                kf_o, lm_o = res.kf_pose, res.lm_pos
            kf_out = kf_o.cpu().numpy()
            lm_out = lm_o.cpu().numpy()
            kf[free_k] = kf_out[:len(free_k)]
            lm[lm_set] = lm_out[:len(lm_set)]
    return kf
