"""The end of the run: ``check_trajectory`` and ``finalize`` against the
JAX package.

``check_trajectory`` (models/slam.py) walks no keyframe on the host: the
repair tests of all keyframes at once, then the prefix product of the
increments. It is held against the JAX ``check_trajectory``
(``lax.scan``) on maps made here from a seed: a clean trajectory (no
repair), corrupted keyframes (two repairs and more), invalid slots in the
ring, sequence numbers out of ring order (a ring that wrapped),
loop-closure, stale-generation and invalid edges, and duplicate odometry
edges of which the newest by ring order must win. ``n_repaired`` equal,
poses within ``CT_TOL``: the prefix product composes in another
association than the scan (measured 1.19e-7 at most over these cases).
And against the numbers the host walk it replaces gave on one map,
kept here as numbers.

``finalize`` (release, BA, chi² prune, BA, repair) against the JAX
``finalize`` on the JAX engine's state after a few frames with every
tracked frame a keyframe (as tests/test_torch_finalize_dist.py makes it),
with ``dense_schur``, ``dense_schur_mm`` and ``pcg``: the pruned masks
equal, keyframe poses within ``FINALIZE_TOL`` and landmarks within
``FINALIZE_LM_TOL`` (measured at most 3.61e-7 and 2.38e-7: the float32
differences of the two packages' sums over the 24 robust iterations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, port_trajectory_map, trajectory_map
from test_torch_compiled_step import NoHostRead

from putslam_tpu.backend import graph as jgraph
from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu.slam_map import features_map as jfm
from putslam_tpu_torch import convert
from putslam_tpu_torch.models import slam as tslam

CT_TOL = 1e-5
FINALIZE_TOL = 1e-5
FINALIZE_LM_TOL = 1e-5


def _cfg(K):
    cfg = tiny_test_config()
    return cfg.replace(map=dataclasses.replace(cfg.map, max_keyframes=K))


def both_maps(cfg, arrays):
    """(JAX map, JAX graph, port map, port graph) holding ``arrays``."""
    E = cfg.backend.max_pose_pose_edges
    mk = ("kf_pose", "kf_valid", "kf_seq", "kf_gen")
    jm = jfm.init_map(cfg)._replace(**{k: jnp.asarray(arrays[k]) for k in mk})
    jg = jgraph.init_graph(64, E)._replace(
        **{k: jnp.asarray(v) for k, v in arrays.items() if k not in mk})
    tm, tg = port_trajectory_map(port_cfg(cfg), arrays, "cpu")
    return jm, jg, tm, tg


# (name, keyframe slots, seed, keyframes, corrupt, invalid, shift, duplicates)
CASES = {
    "clean": (32, 0, 12, (), (), 0, False),
    "repairs": (32, 1, 12, (4, 9), (), 0, False),
    "invalid_slots_wrapped_ring": (32, 2, 20, (6,), (3, 11), 25, False),
    "duplicate_odometry": (32, 3, 10, (), (), 7, True),
    "full_ring": (32, 4, 32, (5, 17, 30), (), 13, False),
}
MIN_REPAIRS = {"clean": 0, "repairs": 2, "invalid_slots_wrapped_ring": 2,
               "duplicate_odometry": 1, "full_ring": 4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_trajectory_matches_jax(case):
    K, seed, n_kf, corrupt, invalid, shift, dup = CASES[case]
    cfg = _cfg(K)
    arrays = trajectory_map(K, cfg.backend.max_pose_pose_edges, seed, n_kf,
                            corrupt, invalid, shift, dup)
    jm, jg, tm, tg = both_maps(cfg, arrays)
    ref, n_ref = jslam.check_trajectory(cfg, jm, jg)
    with NoHostRead():
        got, n_got = tslam.check_trajectory(port_cfg(cfg), tm, tg)
    assert got.dtype == torch.float32 and n_got.dtype == torch.int32
    assert int(n_got) == int(n_ref)
    if MIN_REPAIRS[case]:
        assert int(n_got) >= MIN_REPAIRS[case]
    else:
        assert int(n_got) == 0
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=CT_TOL, rtol=0)
    # invalid slots keep their pose exactly
    np.testing.assert_array_equal(n(got)[~arrays["kf_valid"]],
                                  arrays["kf_pose"][~arrays["kf_valid"]])


def test_duplicate_odometry_edge_newest_wins():
    """Pair 1 → 2 has an older wrong edge and a newer right one: no repair
    there; pair 3 → 4 a newer wrong one: keyframe 4 is re-composed from it
    (and keyframe 5, whose increment from 4 no longer matches, too)."""
    cfg = _cfg(32)
    arrays = trajectory_map(32, cfg.backend.max_pose_pose_edges, 3, 10,
                            duplicates=True)
    _, _, tm, tg = both_maps(cfg, arrays)
    got, n_rep = tslam.check_trajectory(port_cfg(cfg), tm, tg)
    got = n(got)
    order = np.argsort(np.where(arrays["kf_valid"], arrays["kf_seq"],
                                2 ** 31 - 1), kind="stable")
    moved = np.abs(got - arrays["kf_pose"]).max(axis=1)[order[:10]]
    assert (moved[:4] < 1e-5).all(), moved
    assert (moved[4:] > 0.1).all(), moved
    assert int(n_rep) == 1


# The host walk this module's check_trajectory replaced (a Python loop over
# the keyframes in sequence order, one bool() a step), run on
# trajectory_map(8, 64, 5, 7, corrupt=(2,), invalid=(5,), shift=3): the 0.3 m
# threshold of tiny_test_config, 2 keyframes repaired, these poses (slot 0
# holds the invalid keyframe's random pose, slot 2 no keyframe)
HOST_WALK_N = 2
HOST_WALK_POSES = [
    [0.41137287, 1.2411859, -0.6212833, 0.77611667, 0.34104717, -0.50783235,
     -0.15308863],
    [-0.29454815, 0.015803955, -0.1220042, 0.99617845, 0.00061641354,
     -0.015920173, -0.08587688],
    [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
    [-0.06441479, -0.10592129, -0.01915531, 0.9995377, 0.0105095105,
     0.028396785, 0.0027422372],
    [-0.10653359, -0.17051557, 0.03929901, 0.99766755, 0.050363522,
     0.03572841, -0.029094882],
    [-0.17121169, -0.036799565, 0.06672018, 0.9977711, 0.0053948443,
     0.035707723, -0.056113407],
    [-0.22986266, -0.067537874, 0.012597762, 0.99672097, 0.018581783,
     0.033430114, -0.07130628],
]


def test_check_trajectory_matches_the_host_walk():
    cfg = _cfg(8)
    arrays = trajectory_map(8, cfg.backend.max_pose_pose_edges, 5, 7,
                            corrupt=(2,), invalid=(5,), shift=3)
    _, _, tm, tg = both_maps(cfg, arrays)
    got, n_rep = tslam.check_trajectory(port_cfg(cfg), tm, tg)
    assert int(n_rep) == HOST_WALK_N
    np.testing.assert_allclose(n(got), np.array(HOST_WALK_POSES, np.float32),
                               atol=CT_TOL, rtol=0)


def test_check_trajectory_off_and_on_the_device_layout():
    """A threshold of 0 turns the repair off; the outputs stay on the map's
    device as tensors (no host copy)."""
    cfg = _cfg(32)
    arrays = trajectory_map(32, cfg.backend.max_pose_pose_edges, 1, 12,
                            corrupt=(4,))
    _, _, tm, tg = both_maps(cfg, arrays)
    off = port_cfg(cfg.replace(backend=dataclasses.replace(
        cfg.backend, trajectory_repair_threshold=0.0)))
    got, n_rep = tslam.check_trajectory(off, tm, tg)
    assert got is tm.kf_pose and int(n_rep) == 0
    got, n_rep = tslam.check_trajectory(port_cfg(cfg), tm, tg)
    assert torch.is_tensor(n_rep) and n_rep.dim() == 0
    assert got.device == tm.kf_pose.device


@pytest.fixture(scope="module")
def small_run():
    """The JAX engine's state after 8 orbit frames, every tracked frame a
    keyframe (tests/test_round5.py:19-27), and the port's copy."""
    cfg = tiny_test_config()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map,
                                              min_keyframe_matches=10_000))
    poses = jsyn.orbit_trajectory(8, radius=0.05, yaw_amp=0.05)
    g, d = jsyn.render_sequence(cfg.camera, poses)
    st = jslam.slam_init(cfg, g[0], d[0])
    for i in range(1, 8):
        st, _ = jslam.slam_step(cfg, st, g[i], d[i])
    return cfg, st


@pytest.mark.parametrize("solver", ["dense_schur", "dense_schur_mm", "pcg"])
def test_finalize_matches_jax(small_run, solver):
    cfg, jst = small_run
    cfg = cfg.replace(backend=dataclasses.replace(cfg.backend, solver=solver))
    tst = convert.from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    kv = n(tst.map.kf_valid)
    assert kv.sum() >= 4
    ref = jslam.finalize(cfg, jst)
    got = tslam.finalize(port_cfg(cfg), tst)
    np.testing.assert_array_equal(n(got.map.lm_valid),
                                  np.asarray(ref.map.lm_valid))
    np.testing.assert_array_equal(n(got.graph.obs_valid),
                                  np.asarray(ref.graph.obs_valid))
    np.testing.assert_allclose(n(got.map.kf_pose)[kv],
                               np.asarray(ref.map.kf_pose)[kv],
                               atol=FINALIZE_TOL, rtol=0)
    lv = n(got.map.lm_valid)
    np.testing.assert_allclose(n(got.map.lm_pos)[lv],
                               np.asarray(ref.map.lm_pos)[lv],
                               atol=FINALIZE_LM_TOL, rtol=0)
    # the polish moved the free keyframes and held the gauge
    moved = np.abs(n(got.map.kf_pose) - n(tst.map.kf_pose))[kv].max(axis=1)
    assert moved.max() > 1e-6
    gauge = int(np.argmin(np.where(kv, n(tst.map.kf_seq), 2 ** 31 - 1)))
    np.testing.assert_array_equal(n(got.map.kf_pose)[gauge],
                                  n(tst.map.kf_pose)[gauge])
