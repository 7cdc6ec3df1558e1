"""The text bridges between the packages: a g2o or RGB-D SLAM file that one
package exports, the other imports to the same arrays (exact: both parse the
same text into float32), both ways; full upper-triangular information kept;
malformed lines raise. The g2o text carries 6 significant digits of an
information value and Python's shortest repr of a float32 pose."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, t

from putslam_tpu.backend import graph as jgraph
from putslam_tpu.io import g2o as jg2o
from putslam_tpu.io import rgbdslam as jrgbd
from putslam_tpu_torch.backend import graph as tgraph
from putslam_tpu_torch.io import g2o as tg2o
from putslam_tpu_torch.io import rgbdslam as trgbd

K, L, M, E = 8, 16, 64, 8
GRAPH_FIELDS = tgraph.GraphState._fields


def _poses(rng, k):
    q = rng.normal(size=(k, 4))
    return np.concatenate([rng.normal(size=(k, 3)),
                           q / np.linalg.norm(q, axis=1, keepdims=True)],
                          axis=1).astype(np.float32)


def _state(seed=0, full_info=False):
    """A small graph as numpy: 5 of 8 keyframes, 10 of 16 landmarks, 30
    observations (scalar weights or full information), 3 pose-pose edges."""
    rng = np.random.default_rng(seed)
    kf_pose = _poses(rng, K)
    kf_valid = np.zeros(K, bool)
    kf_valid[[0, 1, 3, 4, 6]] = True
    lm_pos = rng.normal(size=(L, 3)).astype(np.float32)
    lm_valid = np.zeros(L, bool)
    lm_valid[:10] = True
    n_obs = 30
    obs = dict(
        kf=rng.choice([0, 1, 3, 4, 6, 2], n_obs).astype(np.int32),
        lm=rng.integers(0, 12, n_obs).astype(np.int32),
        xyz=rng.normal(size=(n_obs, 3)).astype(np.float32),
        w=rng.uniform(100, 2500, n_obs).astype(np.float32))
    if full_info:
        a = rng.normal(size=(n_obs, 3, 3))
        obs["info"] = (a @ np.swapaxes(a, 1, 2)
                       + 3 * np.eye(3)).astype(np.float32)
    pps = [(0, 1, _poses(rng, 1)[0], 100.0), (1, 3, _poses(rng, 1)[0], 100.0),
           (0, 6, _poses(rng, 1)[0], 200.0)]
    return kf_pose, kf_valid, lm_pos, lm_valid, obs, pps


def _jax_graph(obs, pps):
    g = jgraph.init_graph(M, E)
    g = jgraph.add_observations(
        g, jnp.asarray(obs["kf"]), jnp.asarray(obs["lm"]),
        jnp.asarray(obs["xyz"]), jnp.asarray(obs["w"]),
        jnp.ones((len(obs["kf"]),), bool),
        info=None if "info" not in obs else jnp.asarray(obs["info"]))
    for i, j, rel, w in pps:
        g = jgraph.add_pose_pose(g, i, j, jnp.asarray(rel), w)
    return g


def _torch_graph(obs, pps):
    g = tgraph.init_graph(M, E, "cpu")
    g = tgraph.add_observations(
        g, t(obs["kf"]), t(obs["lm"]), t(obs["xyz"]), t(obs["w"]),
        torch.ones((len(obs["kf"]),), dtype=torch.bool),
        info=None if "info" not in obs else t(obs["info"]))
    for i, j, rel, w in pps:
        g = tgraph.add_pose_pose(g, i, j, t(rel), w)
    return g


def _assert_imports_equal(ours, ref):
    for a, b in zip(ours[:4], ref[:4]):
        assert np.array_equal(n(a), np.asarray(b))
    assert np.array_equal(n(ours[5]), np.asarray(ref[5]))
    for f in GRAPH_FIELDS:
        a, b = n(getattr(ours[4], f)), np.asarray(getattr(ref[4], f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("full_info", [False, True])
def test_g2o_files_equal_and_import_both_ways(tmp_path, full_info):
    kf_pose, kf_valid, lm_pos, lm_valid, obs, pps = _state(1, full_info)
    jp, tp = str(tmp_path / "j.g2o"), str(tmp_path / "t.g2o")
    jg2o.export_graph(jp, kf_pose, kf_valid, lm_pos, lm_valid,
                      _jax_graph(obs, pps))
    tg2o.export_graph(tp, t(kf_pose), t(kf_valid), t(lm_pos), t(lm_valid),
                      _torch_graph(obs, pps))
    assert open(jp).read() == open(tp).read()
    text = open(tp).read()
    assert text.count("VERTEX_SE3:QUAT") == 5 and "FIX 0" in text
    assert text.count("EDGE_SE3:QUAT") == 3
    # each package imports the other's file to the same arrays
    ours = tg2o.import_graph(jp, K, L, M, E)
    ref = jg2o.import_graph(tp, K, L, M, E)
    _assert_imports_equal(ours, ref)
    kf2, kfv2, lm2, lmv2, g2, fixed = ours
    assert np.array_equal(n(kfv2), kf_valid) and np.array_equal(n(lmv2),
                                                                lm_valid)
    np.testing.assert_allclose(n(kf2)[kf_valid], kf_pose[kf_valid], atol=1e-6)
    np.testing.assert_allclose(n(lm2)[lm_valid], lm_pos[lm_valid], atol=1e-6)
    assert n(fixed).tolist() == [True] + [False] * (K - 1)
    # edges on an invalid keyframe (2) or landmark (10, 11) are not exported
    live = kf_valid[obs["kf"]] & lm_valid[obs["lm"]]
    assert int(n(g2.n_obs)) == int(live.sum())
    got = n(g2.obs_info)[:int(live.sum())]
    want = (obs["info"][live] if full_info else
            obs["w"][live][:, None, None] * np.eye(3, dtype=np.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5)    # 6 significant digits
    np.testing.assert_allclose(n(g2.pp_w)[:3], [100.0, 100.0, 200.0])


def test_g2o_export_respects_landmark_generations(tmp_path):
    kf_pose, kf_valid, lm_pos, lm_valid, obs, pps = _state(2)
    lm_gen = np.zeros(L, np.int32)
    lm_gen[obs["lm"][0]] = 1                 # that slot was recycled since
    jp, tp = str(tmp_path / "j.g2o"), str(tmp_path / "t.g2o")
    jg2o.export_graph(jp, kf_pose, kf_valid, lm_pos, lm_valid,
                      _jax_graph(obs, pps), lm_gen=lm_gen)
    tg2o.export_graph(tp, kf_pose, kf_valid, lm_pos, lm_valid,
                      _torch_graph(obs, pps), lm_gen=t(lm_gen))
    assert open(jp).read() == open(tp).read()
    stale = obs["lm"] == obs["lm"][0]
    live = kf_valid[obs["kf"]] & lm_valid[obs["lm"]]
    assert open(tp).read().count("EDGE_SE3_TRACKXYZ") == int(
        (live & ~stale).sum())


def test_g2o_full_information_roundtrip(tmp_path):
    """A hand-written reference-format file with non-isotropic information
    (tests/test_round4.py:499): both imports equal, the 3×3 kept."""
    src = tmp_path / "in.g2o"
    info3 = np.array([[100.0, 0.5, 0.0], [0.5, 25.0, -1.0], [0.0, -1.0, 4.0]])
    info6 = np.diag([10.0, 10.0, 10.0, 40.0, 40.0, 40.0])
    up3 = " ".join(str(info3[i, j]) for i in range(3) for j in range(i, 3))
    up6 = " ".join(str(info6[i, j]) for i in range(6) for j in range(i, 6))
    base = tg2o.LANDMARK_ID_BASE
    assert base == jg2o.LANDMARK_ID_BASE
    src.write_text(
        "VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n"
        "VERTEX_SE3:QUAT 1 0.1 0 0 0 0 0 1\n"
        "\n"
        f"VERTEX_TRACKXYZ {base} 0.5 0.2 2.0\n"
        f"EDGE_SE3:QUAT 0 1 0.1 0 0 0 0 0 1 {up6}\n"
        "EDGE_SE3:QUAT 1 0 -0.1 0 0 0 0 0 1 7.5\n"
        f"EDGE_SE3_TRACKXYZ 0 {base} 0.5 0.2 2.0 {up3}\n"
        f"EDGE_SE3_TRACKXYZ 1 {base} 0.4 0.2 2.0 30\n")
    ours = tg2o.import_graph(str(src), 8, 16, 32, 8)
    _assert_imports_equal(ours, jg2o.import_graph(str(src), 8, 16, 32, 8))
    g = ours[4]
    np.testing.assert_allclose(n(g.obs_info[0]), info3, atol=1e-5)
    np.testing.assert_allclose(n(g.obs_info[1]), 30 * np.eye(3), atol=1e-5)
    assert abs(float(g.obs_w[0]) - np.trace(info3) / 3.0) < 1e-5
    assert abs(float(g.pp_w[0]) - np.trace(info6) / 6.0) < 1e-5
    assert float(g.pp_w[1]) == 7.5
    assert n(ours[5]).tolist()[:2] == [True, False]   # no FIX line: first kf
    out = tmp_path / "out.g2o"
    tg2o.export_graph(str(out), *ours[:5])
    g2 = jg2o.import_graph(str(out), 8, 16, 32, 8)[4]
    np.testing.assert_allclose(np.asarray(g2.obs_info[0]), info3, rtol=1e-4)


@pytest.mark.parametrize("line", ["EDGE_SE3:QUAT 0 1 0 0 0 0 0 0 1",
                                  "EDGE_SE3_TRACKXYZ 0 100000 1 2 3"])
def test_g2o_malformed_edge_raises(tmp_path, line):
    src = tmp_path / "bad.g2o"
    src.write_text("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n" + line + "\n")
    with pytest.raises(ValueError):
        tg2o.import_graph(str(src), 4, 4, 8, 4)
    with pytest.raises(ValueError):
        jg2o.import_graph(str(src), 4, 4, 8, 4)


@pytest.mark.parametrize("ordered", [False, True])
def test_rgbdslam_files_equal_and_import_both_ways(tmp_path, ordered):
    rng = np.random.default_rng(4)
    kf_pose = _poses(rng, K)
    kf_valid = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    kf_seq = np.array([9, 8, 0, 10, 11, 12, 0, 7], np.int32)   # a wrapped ring
    stamps = 100.0 + np.arange(6) / 30.0
    kw = dict(timestamps=stamps, kf_seq=kf_seq) if ordered else {}
    jp, tp = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert jrgbd.export_rgbdslam(jp, kf_pose, kf_valid, **kw) == 6
    assert trgbd.export_rgbdslam(
        tp, t(kf_pose), t(kf_valid),
        **{k: (t(v) if k == "kf_seq" else v) for k, v in kw.items()}) == 6
    assert open(jp).read() == open(tp).read()
    ours = trgbd.import_rgbdslam(jp, K, E)
    ref = jrgbd.import_rgbdslam(tp, K, E)
    assert np.array_equal(n(ours[0]), np.asarray(ref[0]))
    assert np.array_equal(n(ours[1]), np.asarray(ref[1]))
    assert np.array_equal(n(ours[3]), np.asarray(ref[3]))
    assert np.array_equal(ours[4], ref[4])
    for f in ("pp_i", "pp_j", "pp_w", "pp_valid", "n_pp"):
        assert np.array_equal(n(getattr(ours[2], f)),
                              np.asarray(getattr(ref[2], f))), f
    # relative poses: float32 quaternion products in two libraries
    np.testing.assert_allclose(n(ours[2].pp_rel), np.asarray(ref[2].pp_rel),
                               atol=1e-6)
    order = [7, 1, 0, 3, 4, 5] if ordered else [0, 1, 3, 4, 5, 7]
    np.testing.assert_allclose(n(ours[0])[:6], kf_pose[order], atol=1e-6)
    assert int(ours[2].n_pp) == 5 and n(ours[3]).tolist()[0] is True
    if ordered:
        np.testing.assert_allclose(ours[4], stamps, atol=1e-6)


def test_rgbdslam_truncates_and_rejects(tmp_path):
    src = tmp_path / "traj.txt"
    src.write_text("# comment\n" + "".join(
        f"{i}.0 {i} 0 0 0 0 0 1\n" for i in range(6)))
    ours = trgbd.import_rgbdslam(str(src), 4, 8)
    ref = jrgbd.import_rgbdslam(str(src), 4, 8)
    assert int(n(ours[1]).sum()) == int(np.asarray(ref[1]).sum()) == 4
    assert int(ours[2].n_pp) == 3 and len(ours[4]) == 4
    src.write_text("0.0 1 2 3\n")
    with pytest.raises(ValueError):
        trgbd.import_rgbdslam(str(src), 4, 8)
