"""The slice as a whole: the port's slam_step follows the JAX engine frame
by frame — starting from the JAX slam_init state (convert.py) and fed the
uniforms of the JAX key chain — through keyframes and the windowed,
landmark-blocked dense_schur_mm BA. Poses ≤ 1e-4; keyframe / BA decisions
and landmark counts exact; chi² ≤ 1e-3 relative (plus 1e-5 absolute:
once converged, chi² is float32 noise around zero)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, t

from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu_torch import convert
from putslam_tpu_torch.eval import ate as tate
from putslam_tpu_torch.models import slam as tslam

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_ate.json")


def jax_draws(cfg, key):
    """The uniforms the JAX package's slam_step draws from ``key`` for its
    RANSAC calls (models/slam.py:217 and :331): {vo, map, retry0, ...} as
    torch tensors, plus the key the step leaves in the state."""
    H, k = cfg.ransac.n_hypotheses, cfg.ransac.used_pairs
    key, k_vo, k_map = jax.random.split(key, 3)
    out = {"vo": jax.random.uniform(k_vo, (k, H), maxval=1.0),
           "map": jax.random.uniform(k_map, (k, H), maxval=1.0)}
    for a in range(cfg.matcher.retries):
        key, k_retry = jax.random.split(key)
        out[f"retry{a}"] = jax.random.uniform(k_retry, (k, H), maxval=1.0)
    return {name: t(v) for name, v in out.items()}, key


def slice_config():
    """The tiny test config with the fr1 solver and both BA compactions
    small enough to engage at 12 frames."""
    from putslam_tpu.config import tiny_test_config

    cfg = tiny_test_config()
    return cfg.replace(backend=dataclasses.replace(
        cfg.backend, solver="dense_schur_mm", ba_window=2, ba_lm_block=128,
        optimize_every_n_frames=2))


def test_slice_follows_jax_frame_by_frame():
    cfg = slice_config()
    T = 12
    poses = np.asarray(jsyn.orbit_trajectory(T, radius=0.10, yaw_amp=0.1))
    g, d = jsyn.render_sequence(cfg.camera, jnp.asarray(poses))
    g, d = np.asarray(g), np.asarray(d)

    js = jslam.slam_init(cfg, g[0], d[0], poses[0])
    ts = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    n_kf = n_ba = 0
    for i in range(1, T):
        draws, key = jax_draws(cfg, js.key)
        js, jo = jslam.slam_step(cfg, js, g[i], d[i])
        assert np.array_equal(np.asarray(js.key), np.asarray(key))
        ts, to = tslam.slam_step(cfg, ts, t(g[i]), t(d[i]), draws=draws)
        np.testing.assert_allclose(n(to.pose), np.asarray(jo.pose), atol=1e-4,
                                   err_msg=f"frame {i}")
        for f in ("is_keyframe", "ba_ran", "n_landmarks", "vo_ok", "map_ok",
                  "n_map_inliers", "anchor_ring", "anchor_seq"):
            assert int(n(getattr(to, f))) == int(np.asarray(getattr(jo, f))), \
                (i, f)
        np.testing.assert_allclose(n(to.chi2), np.asarray(jo.chi2),
                                   rtol=1e-3, atol=1e-5)
        n_kf += int(jo.is_keyframe)
        n_ba += int(jo.ba_ran)
    assert n_kf >= 4 and n_ba >= 1       # keyframes and a windowed BA ran
    np.testing.assert_allclose(n(ts.map.lm_pos), np.asarray(js.map.lm_pos),
                               atol=1e-4)
    np.testing.assert_array_equal(n(ts.map.lm_valid),
                                  np.asarray(js.map.lm_valid))
    np.testing.assert_array_equal(n(ts.graph.obs_valid),
                                  np.asarray(js.graph.obs_valid))
    np.testing.assert_allclose(n(ts.map.kf_pose), np.asarray(js.map.kf_pose),
                               atol=1e-4)


def test_unported_options_raise():
    cfg = slice_config()
    for over in (dict(loop_closure=dataclasses.replace(cfg.loop_closure,
                                                       enabled=True)),
                 dict(vo_version=1),
                 dict(backend=dataclasses.replace(cfg.backend,
                                                  solver="dense_schur")),
                 dict(matcher=dataclasses.replace(cfg.matcher, max_mates=2))):
        with pytest.raises(NotImplementedError):
            tslam.slam_init(cfg.replace(**over), torch.zeros(96, 128),
                            torch.zeros(96, 128), device="cpu")


@pytest.mark.slow
def test_orbit30_golden_gates():
    """The port alone on the golden orbit30 workload (JAX-rendered frames,
    the golden base config with the dense_schur_mm solver): SLAM and
    finalized ATE under the golden gates; the JAX package's numbers on the
    same run are printed beside them."""
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.eval import ate as jate

    with open(GOLDEN) as f:
        gates = {k: v[1] for k, v in json.load(f).items()
                 if not k.startswith("_")}
    cfg = tiny_test_config()
    cfg = cfg.replace(
        map=dataclasses.replace(cfg.map,
                                add_features_when_measurements_less_than=10),
        backend=dataclasses.replace(cfg.backend, solver="dense_schur_mm"))
    poses = jsyn.orbit_trajectory(30, radius=0.15, yaw_amp=0.15)
    g, d = (np.asarray(x) for x in jsyn.render_sequence(cfg.camera, poses))
    gt = np.asarray(poses)
    pb, pa, _, _ = tslam.run_slam_final(cfg, g, d, init_pose=gt[0],
                                        device="cpu")
    port = (tate.ate_rmse_aligned_frames(gt, pb),
            tate.ate_rmse_aligned_frames(gt, pa))
    jb, ja, _, _ = jslam.run_slam_final(cfg, g, d, init_pose=gt[0])
    ref = (jate.ate_rmse_aligned_frames(gt, jb),
           jate.ate_rmse_aligned_frames(gt, ja))
    print(f"orbit30 ATE slam / final: port {port[0]:.5f} / {port[1]:.5f} m, "
          f"JAX {ref[0]:.5f} / {ref[1]:.5f} m")
    assert port[0] < gates["orbit30_slam"]
    assert port[1] < gates["orbit30_slam_final"]
