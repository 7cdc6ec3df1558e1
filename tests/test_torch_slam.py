"""The slice as a whole: the port's slam_step follows the JAX engine frame
by frame — starting from the JAX slam_init state (convert.py) and fed the
uniforms of the JAX key chain — through keyframes and the windowed,
landmark-blocked dense_schur_mm BA; with loop closure on a short revisit
(dense_schur BA); and with the EKF motion model on a sequence where VO
fails. Poses ≤ 1e-4; keyframe / BA decisions and landmark counts exact;
chi² ≤ 1e-3 relative (plus 1e-5 absolute: once converged, chi² is float32
noise around zero); the loop-closure queue exact (scores 1e-6), the
pose-pose edge store exact in its integers (relative poses 1e-4); the EKF
state 1e-4."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t

from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu_torch import convert
from putslam_tpu_torch.eval import ate as tate
from putslam_tpu_torch.models import slam as tslam

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_ate.json")


def jax_draws(cfg, key):
    """The uniforms the JAX package's slam_step draws from ``key`` for its
    RANSAC calls (models/slam.py:217, :331 and, with loop closure, :496;
    models/vo.py:60 with the Hamming-slack rescue): {vo, vo_retry, map,
    retry0, ..., lc} as torch tensors, plus the key the step leaves in the
    state."""
    H, k = cfg.ransac.n_hypotheses, cfg.ransac.used_pairs
    key, k_vo, k_map = jax.random.split(key, 3)
    out = {}
    if cfg.matcher.retry_hamming_slack > 0:     # models/vo.py:59-60
        k_vo, k_vo2 = jax.random.split(k_vo)
        out["vo_retry"] = jax.random.uniform(k_vo2, (k, H), maxval=1.0)
    out["vo"] = jax.random.uniform(k_vo, (k, H), maxval=1.0)
    out["map"] = jax.random.uniform(k_map, (k, H), maxval=1.0)
    for a in range(cfg.matcher.retries):
        key, k_retry = jax.random.split(key)
        out[f"retry{a}"] = jax.random.uniform(k_retry, (k, H), maxval=1.0)
    if cfg.loop_closure.enabled:
        key, k_lc = jax.random.split(key)
        out["lc"] = jax.random.uniform(k_lc, (k, H), maxval=1.0)
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
    pcfg = port_cfg(cfg)
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
        ts, to = tslam.slam_step(pcfg, ts, t(g[i]), t(d[i]), draws=draws)
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


def _check_frame(i, to, jo, chi2_atol=1e-5):
    np.testing.assert_allclose(n(to.pose), np.asarray(jo.pose), atol=1e-4,
                               err_msg=f"frame {i}")
    for f in ("is_keyframe", "ba_ran", "n_landmarks", "vo_ok", "map_ok",
              "n_map_inliers", "anchor_ring", "anchor_seq"):
        assert int(n(getattr(to, f))) == int(np.asarray(getattr(jo, f))), \
            (i, f)
    np.testing.assert_allclose(n(to.chi2), np.asarray(jo.chi2), rtol=1e-3,
                               atol=chi2_atol)


def _check_pose_pose(i, tg, jg):
    for f in ("pp_i", "pp_j", "pp_gen_i", "pp_gen_j", "pp_valid", "n_pp"):
        np.testing.assert_array_equal(n(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)),
                                      err_msg=f"frame {i} {f}")
    np.testing.assert_array_equal(n(tg.pp_w), np.asarray(jg.pp_w))
    np.testing.assert_allclose(n(tg.pp_rel), np.asarray(jg.pp_rel),
                               atol=1e-4, err_msg=f"frame {i}")


def revisit_lc_config():
    """Loop closure on the tiny config (its dense_schur solver) with the
    JAX package's LC-test map settings and a 3-keyframe recency tail, so a
    24-frame revisit closes loops."""
    from putslam_tpu.config import tiny_test_config

    cfg = tiny_test_config()
    return cfg.replace(
        map=dataclasses.replace(cfg.map,
                                add_features_when_measurements_less_than=10,
                                max_keyframes=64),
        loop_closure=dataclasses.replace(cfg.loop_closure, enabled=True,
                                         tail_skip=3))


def test_loop_closure_follows_jax_frame_by_frame():
    """24-frame revisit (sweep 0.6 m), tail_skip 3: the JAX run verifies
    candidates and accepts loop-closure edges; the port makes the same
    queue, the same verdicts and the same edges on every frame."""
    cfg = revisit_lc_config()
    pcfg = port_cfg(cfg)
    T = 24
    poses = np.asarray(jsyn.revisit_trajectory(T, sweep=0.6))
    g, d = (np.asarray(x) for x in jsyn.render_sequence(cfg.camera,
                                                        jnp.asarray(poses)))
    js = jslam.slam_init(cfg, g[0], d[0], poses[0])
    ts = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for i in range(1, T):
        draws, key = jax_draws(cfg, js.key)
        js, jo = jslam.slam_step(cfg, js, g[i], d[i])
        assert np.array_equal(np.asarray(js.key), np.asarray(key))
        ts, to = tslam.slam_step(pcfg, ts, t(g[i]), t(d[i]), draws=draws)
        _check_frame(i, to, jo)
        for f in ("kf_a", "kf_b"):
            np.testing.assert_array_equal(n(getattr(ts.lc_queue, f)),
                                          np.asarray(getattr(js.lc_queue, f)),
                                          err_msg=f"frame {i} {f}")
        np.testing.assert_allclose(n(ts.lc_queue.prob),
                                   np.asarray(js.lc_queue.prob), atol=1e-6)
        np.testing.assert_array_equal(n(ts.sig_valid), np.asarray(js.sig_valid))
        np.testing.assert_allclose(n(ts.kf_sig), np.asarray(js.kf_sig),
                                   atol=1e-6)
        assert int(n(ts.n_lc_edges)) == int(js.n_lc_edges), i
        _check_pose_pose(i, ts.graph, js.graph)
    assert int(js.n_lc_edges) >= 1       # verified and accepted in JAX
    np.testing.assert_allclose(n(ts.map.kf_pose), np.asarray(js.map.kf_pose),
                               atol=1e-4)


def test_motion_model_follows_jax_frame_by_frame():
    """The EKF on: a 12-frame orbit whose frame 5 is a flat gray image, so
    VO fails on frames 5 and 6 and the EKF prior replaces the VO
    prediction there; the EKF state follows the JAX engine every frame."""
    from putslam_tpu.config import tiny_test_config

    cfg = tiny_test_config()
    cfg = cfg.replace(motion_model=dataclasses.replace(cfg.motion_model,
                                                       enabled=True))
    pcfg = port_cfg(cfg)
    T = 12
    poses = np.asarray(jsyn.orbit_trajectory(T, radius=0.10, yaw_amp=0.1))
    g, d = (np.array(x) for x in jsyn.render_sequence(cfg.camera,
                                                      jnp.asarray(poses)))
    g[5] = 0.5
    js = jslam.slam_init(cfg, g[0], d[0], poses[0])
    ts = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    vo_failed = []
    for i in range(1, T):
        draws, key = jax_draws(cfg, js.key)
        js, jo = jslam.slam_step(cfg, js, g[i], d[i])
        ts, to = tslam.slam_step(pcfg, ts, t(g[i]), t(d[i]), draws=draws)
        _check_frame(i, to, jo)
        np.testing.assert_allclose(n(ts.ekf.x), np.asarray(js.ekf.x),
                                   atol=1e-4, err_msg=f"frame {i}")
        np.testing.assert_allclose(n(ts.ekf.P), np.asarray(js.ekf.P),
                                   atol=1e-4, rtol=1e-4, err_msg=f"frame {i}")
        if not bool(jo.vo_ok):
            vo_failed.append(i)
    assert 5 in vo_failed and 6 in vo_failed, vo_failed


def _replace(cfg, **parts):
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                          for k, v in parts.items()})


def _uncertainty(model):
    """The uncertainty operating mode. The Mahalanobis gate is 16 squared
    sigmas (tests/test_uncertainty_parity.py:95): at the config's default,
    2e-4, the map RANSAC, which gets the information matrices, accepts no
    pose. Every tracked frame is made a keyframe (with the map matched this
    well none would be otherwise), so that observations with information
    matrices are stored and the whitened BA runs."""
    return dict(map=dict(use_uncertainty=True, uncertainty_model=model,
                         min_keyframe_matches=10_000),
                backend=dict(use_obs_info=True),
                ransac=dict(error_version=3,
                            inlier_threshold_mahalanobis=16.0))


OPTION_CASES = {
    "a_uncertainty_normal": _uncertainty("normal"),
    "b_uncertainty_gradient": _uncertainty("gradient"),
    "c_error_type_1": dict(backend=dict(error_type=1)),
    "d_max_mates_3": dict(matcher=dict(max_mates=3)),
    "e_exact_ldb_ratio": dict(detector=dict(grid_policy="exact",
                                            descriptor="ldb"),
                              matcher=dict(acceptance="ratio")),
    "f_hamming_slack_degraded": dict(matcher=dict(retry_hamming_slack=16.0,
                                                  retry_threshold_growth=2.0)),
}


def follow_option_case(case, monkeypatch):
    """One entry of OPTION_CASES (run by test_torch_slam_uncertainty.py and
    test_torch_slam_options.py, a file each so that they run side by side)
    over 12 frames of
    the tiny orbit (case f on frames degraded by noise, blur and depth
    dropout, where the widened retries run): poses ≤ 1e-4, the keyframe /
    BA / map-inlier / landmark counts of every frame and the health that
    drives the retries equal, the stored information matrices ≤ 1e-3
    relative to each matrix's largest entry. chi² ≤ 1e-3 relative plus 1e-5
    of the frame's largest chi² (the float32 noise of a converged solve
    scales with the weights: pixels⁻² or a full information matrix)."""
    cfg = _replace(slice_config(), **OPTION_CASES[case])
    pcfg = port_cfg(cfg)
    T = 12
    # the uncertainty cases on a slower orbit (the first 12 of 30 frames):
    # at the 16-sigma gate the VO's RANSAC, which gets no information
    # matrices, takes every match, and loses the 12-frame orbit's 0.15 m steps
    orbit = 30 if cfg.map.use_uncertainty else T
    poses = np.asarray(jsyn.orbit_trajectory(orbit, radius=0.10,
                                             yaw_amp=0.1))[:T]
    g, d = jsyn.render_sequence(cfg.camera, jnp.asarray(poses))
    if case.startswith("f_"):
        g, d = jsyn.degrade_sequence(g, d, seed=1, intensity_sigma=0.03,
                                     depth_dropout=0.10, depth_sigma=0.005,
                                     blur=1)
    g, d = np.asarray(g), np.asarray(d)
    calls = {"guided": 0}
    for name in ("guided_match", "guided_match_pairs"):
        real = getattr(tslam.fm, name)

        def counted(*a, _real=real, **k):
            calls["guided"] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tslam.fm, name, counted)

    js = jslam.slam_init(cfg, g[0], d[0], poses[0])
    ts = tslam.slam_init(pcfg, t(g[0]), t(d[0]), t(poses[0]), device="cpu")
    info0 = np.asarray(js.graph.obs_info)
    np.testing.assert_allclose(
        n(ts.graph.obs_info), info0, rtol=0,
        atol=1e-3 * max(float(np.abs(info0).max()), 1e-12))
    ts = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    n_kf = n_ba = n_inl = 0
    for i in range(1, T):
        draws, key = jax_draws(cfg, js.key)
        js, jo = jslam.slam_step(cfg, js, g[i], d[i])
        assert np.array_equal(np.asarray(js.key), np.asarray(key))
        ts, to = tslam.slam_step(pcfg, ts, t(g[i]), t(d[i]), draws=draws)
        n_inl += int(jo.n_map_inliers) * int(jo.map_ok)
        _check_frame(i, to, jo, chi2_atol=1e-5 * max(
            1.0, float(np.asarray(jo.chi2).max())))
        assert int(n(to.n_map_matches)) == int(jo.n_map_matches), i
        np.testing.assert_allclose(n(ts.health), np.asarray(js.health),
                                   atol=1e-6, err_msg=f"frame {i}")
        n_kf += int(jo.is_keyframe)
        n_ba += int(jo.ba_ran)
    assert n_kf >= 2 and n_ba >= 1 and n_inl > 50
    np.testing.assert_array_equal(n(ts.graph.obs_valid),
                                  np.asarray(js.graph.obs_valid))
    info = np.asarray(js.graph.obs_info)
    scale = np.abs(info).max(axis=(-1, -2), keepdims=True)
    assert np.all(np.abs(n(ts.graph.obs_info) - info)
                  <= 1e-3 * np.maximum(scale, 1e-12))
    stored = scale[np.asarray(js.graph.obs_valid), 0, 0] > 0
    if cfg.map.use_uncertainty:
        sym = n(ts.graph.obs_info)
        assert stored.all()
        assert np.all(np.abs(sym - np.swapaxes(sym, -1, -2)) <= 1e-5 * scale)
    else:
        assert not stored.any()
    if case.startswith("f_"):
        assert calls["guided"] > T - 1           # widened retries ran
    np.testing.assert_allclose(n(ts.map.kf_pose), np.asarray(js.map.kf_pose),
                               atol=1e-4)


def test_unported_options_raise():
    """Every option of the uncertainty and robustness paths is accepted;
    what still raises at slam_init is a value the port does not know: a
    solver, grid policy, descriptor, acceptance or uncertainty model by
    another name (NotImplementedError), or an error model / factor type out
    of range (ValueError, as in the JAX package)."""
    cfg = port_cfg(slice_config())
    z = torch.zeros(96, 128)
    for parts in (dict(backend=dict(solver="sparse_cholesky")),
                  dict(detector=dict(grid_policy="quadtree")),
                  dict(detector=dict(descriptor="orb")),
                  dict(matcher=dict(acceptance="band")),
                  dict(map=dict(uncertainty_model="strasdat"))):
        with pytest.raises(NotImplementedError):
            tslam.slam_init(_replace(cfg, **parts), z, z, device="cpu")
    for parts in (dict(ransac=dict(error_version=5)),
                  dict(backend=dict(error_type=2))):
        with pytest.raises(ValueError):
            tslam.slam_init(_replace(cfg, **parts), z, z, device="cpu")
    for parts in OPTION_CASES.values():
        tslam.check_config(_replace(cfg, **parts))
    tslam.check_config(_replace(cfg, ransac=dict(quality_tau=10.0,
                                                 error_version=4)))


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
    pb, pa, _, _ = tslam.run_slam_final(port_cfg(cfg), g, d,
                                        init_pose=gt[0], device="cpu")
    port = (tate.ate_rmse_aligned_frames(gt, pb),
            tate.ate_rmse_aligned_frames(gt, pa))
    jb, ja, _, _ = jslam.run_slam_final(cfg, g, d, init_pose=gt[0])
    ref = (jate.ate_rmse_aligned_frames(gt, jb),
           jate.ate_rmse_aligned_frames(gt, ja))
    print(f"orbit30 ATE slam / final: port {port[0]:.5f} / {port[1]:.5f} m, "
          f"JAX {ref[0]:.5f} / {ref[1]:.5f} m")
    assert port[0] < gates["orbit30_slam"]
    assert port[1] < gates["orbit30_slam_final"]


@pytest.mark.slow
def test_golden_table():
    """All five rows of tests/golden_ate.json, measured as
    test_robustness.measure() defines them (its base_cfg unchanged: the
    tiny config's dense_schur solver; loop closure on the revisit row),
    with the port on the JAX-rendered and JAX-degraded frames on the CPU.
    Each row under its gate; the JAX package's numbers printed beside."""
    from putslam_tpu.io import synthetic as jsyn2
    from test_robustness import base_cfg, measure
    from putslam_tpu_torch.models import vo as tvo

    with open(GOLDEN) as f:
        golden = {k: v for k, v in json.load(f).items()
                  if not k.startswith("_")}
    cfg = base_cfg()
    pcfg = port_cfg(cfg)
    port = {}
    poses = jsyn2.orbit_trajectory(30, radius=0.15, yaw_amp=0.15)
    g, d = (np.asarray(x) for x in jsyn2.render_sequence(cfg.camera, poses))
    gt = np.asarray(poses)
    est_vo, _ = tvo.run_vo(pcfg, g, d, init_pose=gt[0], device="cpu")
    port["orbit30_vo"] = tate.ate_rmse_aligned_frames(gt, est_vo)
    pb, pa, _, _ = tslam.run_slam_final(pcfg, g, d, init_pose=gt[0],
                                        device="cpu")
    port["orbit30_slam"] = tate.ate_rmse_aligned_frames(gt, pb)
    port["orbit30_slam_final"] = tate.ate_rmse_aligned_frames(gt, pa)

    cfg_lc = port_cfg(cfg.replace(
        map=dataclasses.replace(cfg.map, max_keyframes=64),
        loop_closure=dataclasses.replace(cfg.loop_closure, enabled=True,
                                         tail_skip=10)))
    poses_r = jsyn2.revisit_trajectory(64, sweep=1.2)
    gr, dr = (np.asarray(x) for x in jsyn2.render_sequence(cfg.camera,
                                                           poses_r))
    gt_r = np.asarray(poses_r)
    _, pa_r, _, st_r = tslam.run_slam_final(cfg_lc, gr, dr, init_pose=gt_r[0],
                                            device="cpu")
    port["revisit64_slam_lc_final"] = tate.ate_rmse_aligned_frames(gt_r, pa_r)
    lc_edges = int(st_r.n_lc_edges)

    g2, d2 = jsyn2.degrade_sequence(g, d, seed=1, intensity_sigma=0.03,
                                    depth_dropout=0.10, depth_sigma=0.005,
                                    blur=1)
    _, pa_d, _, _ = tslam.run_slam_final(pcfg, np.asarray(g2), np.asarray(d2),
                                         init_pose=gt[0], device="cpu")
    port["orbit30_slam_degraded_final"] = tate.ate_rmse_aligned_frames(gt,
                                                                       pa_d)
    ref = measure()
    for key, (expected, gate) in golden.items():
        print(f"{key}: port {port[key]:.5f} m, JAX {ref[key]:.5f} m "
              f"(table {expected}, gate {gate})")
    print(f"revisit64 loop-closure edges (port): {lc_edges}")
    assert lc_edges >= 1
    for key, (_, gate) in golden.items():
        assert np.isfinite(port[key]) and port[key] < gate, key
