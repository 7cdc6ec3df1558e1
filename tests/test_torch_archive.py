"""The host map archive and the offline global bundle adjustment against the
JAX package's. The same states, made by the JAX engine on rings small
enough to wrap and converted with ``convert.from_numpy``, are absorbed chunk
by chunk into both archives: ``dense()`` and the code maps are exact (host
integer bookkeeping and copies of the same float32 arrays). The global BA at
the reference test's small sizes (tests/test_round4.py:239-242) on the same
archive agrees within 1e-5 (float32 Gauss-Newton in two libraries)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import port_cfg

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu.slam_map import archive as jarchive
from putslam_tpu_torch import convert
from putslam_tpu_torch.eval import ate as tate
from putslam_tpu_torch.models import slam as tslam
from putslam_tpu_torch.slam_map import archive as tarchive

T, CHUNK = 28, 8
GBA = dict(window=8, kf_cap=32, lm_cap=512, obs_cap=1024, pp_cap=64,
           sweeps=2, gn_iterations=4)


def wrap_config():
    """A 16-keyframe ring and a 256-observation store, a keyframe on every
    frame: both wrap within 28 frames."""
    cfg = tiny_test_config()
    return cfg.replace(
        map=dataclasses.replace(cfg.map, max_keyframes=16,
                                covisibility_keyframe=2.0),
        backend=dataclasses.replace(cfg.backend, max_observations=256,
                                    optimize_every_n_frames=4))


def _frames(cfg):
    poses = np.asarray(jsyn.orbit_trajectory(T, radius=0.06, yaw_amp=0.08))
    g, d = jsyn.render_sequence(cfg.camera, jnp.asarray(poses))
    return np.asarray(g), np.asarray(d), poses


@pytest.fixture(scope="module")
def archives():
    """Both archives after absorbing the JAX engine's state at every chunk
    boundary, with the per-chunk comparison already made."""
    cfg = wrap_config()
    g, d, poses = _frames(cfg)
    js = jslam.slam_init(cfg, g[0], d[0], poses[0])
    ja, ta = jarchive.MapArchive(), tarchive.MapArchive()
    n_absorbs = 0
    for i in range(1, T):
        js, _ = jslam.slam_step(cfg, js, g[i], d[i])
        if i % CHUNK == 0 or i == T - 1:
            ja.absorb(js)
            ta.absorb(convert.from_numpy(jax.tree.map(np.asarray, js), "cpu"))
            n_absorbs += 1
            _assert_archives_equal(ta, ja)
    assert n_absorbs == 4
    return cfg, js, ja, ta, poses


def _flat(dense):
    kf, lm, obs, pp = dense
    return [kf, lm, *obs, *pp]


def _assert_archives_equal(ta, ja):
    for a, b in zip(_flat(ta.dense()), _flat(ja.dense())):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    assert ta.n_keyframes() == ja.n_keyframes()
    assert len(ta.obs) == len(ja.obs)
    assert ta._lm_codes._map == ja._lm_codes._map
    assert ta._kf_seq_of_code == ja._kf_seq_of_code
    assert (ta._n_obs_seen, ta._n_pp_seen, ta._n_pp_edges) == \
        (ja._n_obs_seen, ja._n_pp_seen, ja._n_pp_edges)


def test_absorb_keeps_what_the_rings_evict(archives):
    cfg, js, ja, ta, _ = archives
    n_kf = int(js.map.n_kf)
    assert n_kf > cfg.map.max_keyframes                 # the ring wrapped
    assert int(js.graph.n_obs) > cfg.backend.max_observations
    assert ta.n_keyframes() == n_kf
    kf, lm, (obs_kf, obs_lm, _, obs_w, obs_info), (pp_i, pp_j, _, _) = \
        ta.dense()
    assert kf.shape == (n_kf, 7) and len(obs_kf) == len(ta.obs) > 256
    # every archived edge points at an archived vertex
    assert obs_kf.min() >= 0 and obs_kf.max() < n_kf
    assert obs_lm.min() >= 0 and obs_lm.max() < len(lm)
    assert len(pp_i) and max(pp_i.max(), pp_j.max()) < n_kf
    assert obs_kf.dtype == np.int32 and obs_info.shape[1:] == (3, 3)
    # absorbing the same state again adds nothing
    before = _flat(ta.dense())
    ta.absorb(convert.from_numpy(jax.tree.map(np.asarray, js), "cpu"))
    for a, b in zip(before, _flat(ta.dense())):
        assert np.array_equal(a, b)
    ja.absorb(js)
    _assert_archives_equal(ta, ja)


def test_code_map_equal():
    rng = np.random.default_rng(0)
    jm, tm = jarchive._CodeMap(), tarchive._CodeMap()
    assert int(tarchive._GEN_BASE) == int(jarchive._GEN_BASE) == 1 << 24
    for _ in range(4):
        slots = rng.integers(0, 40, 200).astype(np.int32)
        gens = rng.integers(0, 5, 200).astype(np.int32)
        codes = slots.astype(np.int64) * tarchive._GEN_BASE + gens
        assert np.array_equal(tm.assign(codes), jm.assign(codes))
        probe = np.concatenate([codes[:50], codes[:5] + (1 << 40)])
        assert np.array_equal(tm.lookup(probe), jm.lookup(probe))
        assert len(tm) == len(jm) and tm._map == jm._map
    assert (tm.lookup(np.array([7 * (1 << 24) + 99], np.int64)) == -1).all()
    big = np.array([8191 * (1 << 24) + 70000], np.int64)   # no int32 overflow
    assert tm.assign(big)[0] == len(tm) - 1


def test_pad_to_equal():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for size in (2, 4, 7):
        assert np.array_equal(tarchive._pad_to(x, size, 5),
                              jarchive._pad_to(x, size, 5))
    assert tarchive._pad_to(x[:, 0].astype(np.int32), 6).dtype == np.int32


def test_empty_archive():
    cfg = port_cfg(wrap_config())
    empty = tarchive.MapArchive()
    for a, b in zip(_flat(empty.dense()),
                    _flat(jarchive.MapArchive().dense())):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert tarchive.global_bundle_adjust(cfg, empty,
                                         device="cpu").shape == (0, 7)


def test_global_bundle_adjust_agrees(archives, monkeypatch):
    cfg, js, ja, ta, poses = archives
    ref = jarchive.global_bundle_adjust(cfg, ja, **GBA)
    # one record per windowed solve: free keyframes, observations, moved
    windows = []
    real_solve = tarchive.opt_mod.gauss_newton_mm

    def solve(bcfg, kf_pose, kf_valid, lm_pos, lm_valid, g, fixed, **kw):
        res = real_solve(bcfg, kf_pose, kf_valid, lm_pos, lm_valid, g, fixed,
                         **kw)
        free = kf_valid & ~fixed
        windows.append(dict(
            n_free=int(free.sum()), n_obs=int(g.n_obs),
            moved=not torch.equal(res.kf_pose[free], kf_pose[free])))
        return res

    monkeypatch.setattr(tarchive.opt_mod, "gauss_newton_mm", solve)
    out = tarchive.global_bundle_adjust(port_cfg(cfg), ta, device="cpu",
                                        **GBA)
    assert out.shape == ref.shape == (ta.n_keyframes(), 7)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # the polish moved keyframes, and the archive itself is left as it was
    before = ta.dense()[0]
    assert np.abs(out - before).max() > 1e-5
    assert np.array_equal(ta.dense()[0], ja.dense()[0])
    # windows of 8 with 50 % overlap over N keyframes, two sweeps; the
    # oldest window of each sweep holds the gauge
    n_kf = ta.n_keyframes()
    per_sweep = 1 + -(-(n_kf - 8) // 4)
    assert len(windows) == 2 * per_sweep
    assert all(w["n_free"] <= 8 and w["n_obs"] > 0 for w in windows)
    assert windows[per_sweep - 1]["n_free"] <= 7
    assert sum(w["moved"] for w in windows) >= len(windows) // 2


def test_global_bundle_adjust_mesh_not_ported(archives):
    cfg, _, _, ta, _ = archives
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tarchive.global_bundle_adjust(port_cfg(cfg), ta, mesh=object(),
                                      device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present")
        tarchive.global_bundle_adjust(port_cfg(cfg), ta)


def test_run_slam_global_wraps_the_ring():
    """The port alone, end to end: every keyframe ever made is archived
    though the 16-slot ring wrapped, and the polished trajectory is finite
    and no worse than 1.2 × the unpolished + 1e-4
    (tests/test_round4.py:244-251)."""
    cfg = wrap_config()
    g, d, poses = _frames(cfg)
    pb, pa, outs, st, archive = tslam.run_slam_global(
        port_cfg(cfg), g, d, init_pose=poses[0], chunk_size=CHUNK,
        device="cpu", **GBA)
    n_kf = int(st.map.n_kf)
    assert n_kf > 16 and archive.n_keyframes() == n_kf
    assert pb.shape == pa.shape == (T, 7) and np.isfinite(pa).all()
    assert np.array_equal(pa[0], pb[0])
    assert outs.pose.shape == (T - 1, 7)
    err_before = tate.ate_rmse_aligned_frames(poses, pb)
    err_after = tate.ate_rmse_aligned_frames(poses, pa)
    assert err_after < err_before * 1.2 + 1e-4, (err_before, err_after)
    assert err_after < 0.15
    # the archive took the state at each of the four chunk boundaries and
    # run_slam without one returns the same trajectory
    pb2, _, _ = tslam.run_slam(port_cfg(cfg), g, d, init_pose=poses[0],
                               chunk_size=CHUNK, device="cpu")
    assert np.array_equal(pb2, pb)
