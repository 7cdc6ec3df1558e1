"""The engine-integrated distributed finalize (models/slam.py::
finalize_dist) against the port's single-device ``finalize`` and the JAX
package's ``finalize_dist`` on the same state: the JAX engine's state after
a few frames (tests/test_round5.py:19-27, every tracked frame a keyframe so
that several are free), converted with ``convert.from_numpy``. Keyframe poses within 5e-3
(tests/test_round5.py:44: the bf16-rounded Schur coupling against the f32
scatter path bends the step direction)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu.parallel import mesh as jmesh
from putslam_tpu_torch import convert
from putslam_tpu_torch.models import slam as tslam
from putslam_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(scope="module")
def small_run():
    cfg = tiny_test_config()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map,
                                              min_keyframe_matches=10_000))
    poses = jsyn.orbit_trajectory(8, radius=0.05, yaw_amp=0.05)
    g, d = jsyn.render_sequence(cfg.camera, poses)
    st = jslam.slam_init(cfg, g[0], d[0])
    for i in range(1, 8):
        st, _ = jslam.slam_step(cfg, st, g[i], d[i])
    return cfg, st, convert.from_numpy(jax.tree.map(np.asarray, st), "cpu")


@pytest.mark.parametrize("size", [1, 8])
def test_finalize_dist_matches_finalize_and_jax(small_run, size):
    cfg, jst, tst = small_run
    kv = n(tst.map.kf_valid)
    assert kv.sum() >= 4
    got = tslam.finalize_dist(port_cfg(cfg), tst,
                              tmesh.make_mesh(size, axis="lm", device="cpu"))
    single = tslam.finalize(port_cfg(cfg), tst)
    ref = jslam.finalize_dist(cfg, jst, jmesh.make_mesh(size, axis="lm"))
    a = n(got.map.kf_pose)[kv]
    np.testing.assert_allclose(a, n(single.map.kf_pose)[kv], atol=5e-3)
    np.testing.assert_allclose(a, np.asarray(ref.map.kf_pose)[kv], atol=5e-3)
    # the same release / prune contract: landmarks kept, edges pruned
    np.testing.assert_array_equal(n(got.map.lm_valid),
                                  np.asarray(ref.map.lm_valid))
    np.testing.assert_array_equal(n(got.graph.obs_valid),
                                  np.asarray(ref.graph.obs_valid))
    assert np.isfinite(n(got.map.kf_pose)).all()
    # the polish moved the free keyframes and held the gauge
    moved = np.abs(a - n(tst.map.kf_pose)[kv]).max(axis=1)
    assert moved.max() > 1e-6
    gauge = int(np.argmin(np.where(kv, n(tst.map.kf_seq), 2 ** 31 - 1)))
    np.testing.assert_array_equal(n(got.map.kf_pose)[gauge],
                                  n(tst.map.kf_pose)[gauge])


def test_finalize_dist_overflow_falls_back_to_finalize(small_run):
    """A 256-rank mesh gives each rank 2M/256 slots, fewer than the keyframe
    set's observations of landmarks 0..1 after a remap: the partition
    overflows and the single-device finalize runs, with a warning."""
    cfg, _, tst = small_run
    L = tst.map.lm_pos.shape[0]
    g = tst.graph._replace(obs_lm=tst.graph.obs_lm % 2)
    st = tst._replace(graph=g)
    with pytest.warns(UserWarning, match="single-device finalize"):
        got = tslam.finalize_dist(port_cfg(cfg), st,
                                  tmesh.make_mesh(L // 2, axis="lm",
                                                  device="cpu"))
    ref = tslam.finalize(port_cfg(cfg), st)
    assert torch.equal(got.map.kf_pose, ref.map.kf_pose)
