"""EKF parity: init, predict (jacfwd of the transition in both packages),
correct (including a measurement in the negative quaternion hemisphere)
and predicted_pose over a sequence of steps. Tolerance 1e-6 absolute +
1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import n, port_cfg, t

from putslam_tpu.config import MotionModelConfig
from putslam_tpu.geometry import se3 as jse3
from putslam_tpu.motion import ekf as jekf
from putslam_tpu_torch.motion import ekf as tekf

CFG = MotionModelConfig(decay=0.98)
PCFG = port_cfg(CFG)
TOL = dict(atol=1e-6, rtol=1e-5)


def _close(ts, js):
    np.testing.assert_allclose(n(ts.x), np.asarray(js.x), **TOL)
    np.testing.assert_allclose(n(ts.P), np.asarray(js.P), **TOL)


def _meas(rng, i, flip):
    tr = np.array([0.02 * i, -0.01 * i, 0.015 * i], np.float32)
    tr += rng.normal(0, 1e-3, 3).astype(np.float32)
    q = np.asarray(jse3.so3_exp_quat(jnp.asarray(
        np.array([0.0, 0.03 * i, 0.01 * i], np.float32))))
    if flip:
        q = -q                   # the same rotation, other hemisphere
    return np.concatenate([tr, q]).astype(np.float32)


@pytest.mark.parametrize("flip", [False, True])
def test_predict_correct_sequence_matches_jax(flip):
    rng = np.random.default_rng(0)
    pose0 = _meas(rng, 0, False)
    js = jekf.init(CFG, jnp.asarray(pose0))
    ts = tekf.init(PCFG, t(pose0))
    _close(ts, js)
    for i in range(1, 12):
        js = jekf.predict(CFG, js, 1.0 / 30)
        ts = tekf.predict(PCFG, ts, 1.0 / 30)
        _close(ts, js)
        np.testing.assert_allclose(n(tekf.predicted_pose(ts)),
                                   np.asarray(jekf.predicted_pose(js)), **TOL)
        z = _meas(rng, i, flip and i % 2 == 1)
        js = jekf.correct(CFG, js, jnp.asarray(z))
        ts = tekf.correct(PCFG, ts, t(z))
        _close(ts, js)
    assert np.asarray(js.x)[6] > 0        # the state kept its hemisphere


def test_predict_jacobian_with_spin_matches_jax():
    """A state with angular velocity (the quaternion branch of jacfwd away
    from its Taylor fallback) and dt = 1, as slam_step calls it."""
    x = np.zeros(13, np.float32)
    x[0:3] = [0.1, -0.2, 0.3]
    x[3:6] = [0.05, 0.01, -0.02]
    x[6:10] = np.asarray(jse3.so3_exp_quat(jnp.asarray([0.1, 0.2, -0.1])))
    x[10:13] = [0.02, -0.03, 0.05]
    P = (np.eye(13) * 1e-2 + 1e-4).astype(np.float32)
    ref = jekf.predict(CFG, jekf.EKFState(jnp.asarray(x), jnp.asarray(P)),
                       1.0)
    got = tekf.predict(PCFG, tekf.EKFState(t(x), t(P)), 1.0)
    _close(got, ref)


def test_init_without_pose_matches_jax():
    _close(tekf.init(PCFG), jekf.init(CFG))


@pytest.mark.parametrize("w", [[0.0, 0.0, 0.0], [1e-5, -2e-5, 1e-5],
                               [0.02, -0.03, 0.05], [0.4, 0.9, -0.7]])
def test_closed_form_jacobian_equals_autodiff(w):
    """The port's closed-form transition Jacobian against
    torch.func.jacfwd of the same transition: at rest, in the Taylor branch
    of sin(θ/2)/θ, and beyond it."""
    import torch

    x = np.zeros(13, np.float32)
    x[0:6] = [0.1, -0.2, 0.3, 0.05, 0.01, -0.02]
    x[6:10] = np.asarray(jse3.so3_exp_quat(jnp.asarray([0.1, 0.2, -0.1])))
    x[10:13] = w
    for dt in (1.0, 1.0 / 30):
        auto = torch.func.jacfwd(
            lambda v: tekf._transition(PCFG, v, dt))(t(x))
        closed = tekf._transition_jacobian(PCFG, t(x), dt)
        np.testing.assert_allclose(n(closed), n(auto), **TOL)
