"""Decaying-velocity EKF motion model.

Port of ``putslam_tpu/motion/ekf.py``. State [position(3), velocity(3),
quaternion wxyz(4), angular velocity(3)]; ``predict`` applies the decaying
constant-velocity transition, ``correct`` a 7-dim pose measurement. The
JAX package takes the transition Jacobian with ``jax.jacfwd``; the port
writes it in closed form, branch for branch as autodiff differentiates the
transition (``torch.func.jacfwd`` costs seconds on its first call and
milliseconds per call on a card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from putslam_tpu_torch.config import MotionModelConfig
from putslam_tpu_torch.geometry import se3

STATE_DIM = 13  # pos(3) + vel(3) + quat wxyz(4) + angvel(3)


class EKFState(NamedTuple):
    x: torch.Tensor   # (13,)
    P: torch.Tensor   # (13, 13)


def init(cfg: MotionModelConfig, pose=None, dtype=torch.float32,
         device=None) -> EKFState:
    """At rest; at ``pose`` when given (its device wins over ``device``)."""
    if pose is not None:
        device = pose.device
    x = torch.zeros((STATE_DIM,), dtype=dtype, device=device)
    x[6] = 1.0
    if pose is not None:
        x[0:3] = se3.translation(pose)
        x[6:10] = se3.rotation_quat(pose)
    return EKFState(x, torch.eye(STATE_DIM, dtype=dtype, device=device) * 1e-2)


def _transition(cfg: MotionModelConfig, x, dt: float):
    pos, vel, quat, w = x[0:3], x[3:6], x[6:10], x[10:13]
    quat2 = se3.quat_normalize(se3.quat_mul(quat, se3.so3_exp_quat(w * dt)))
    return torch.cat([pos + vel * dt, cfg.decay * vel, quat2, cfg.decay * w])


def _diag(values, x):
    return torch.diag(torch.cat([torch.full((n,), v, dtype=x.dtype,
                                            device=x.device)
                                 for n, v in values]))


def _quat_right(e):
    """R(e) with q ⊗ e = R(e) q."""
    w, x, y, z = e.unbind(-1)
    return torch.stack([torch.stack([w, -x, -y, -z]),
                        torch.stack([x, w, z, -y]),
                        torch.stack([y, -z, w, x]),
                        torch.stack([z, y, -x, w])])


def _quat_left(q):
    """L(q) with q ⊗ e = L(q) e."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([torch.stack([w, -x, -y, -z]),
                        torch.stack([x, w, -z, y]),
                        torch.stack([y, z, w, -x]),
                        torch.stack([z, -y, x, w])])


def _exp_quat_jacobian(phi):
    """(4, 3) derivative of ``se3.so3_exp_quat`` at ``phi``, branch for
    branch: the clamp of θ² at 1e-24 and the Taylor form of sin(θ/2)/θ
    below θ² = 1e-8, as forward-mode autodiff differentiates them."""
    theta2 = torch.sum(phi * phi)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    dtheta = torch.where(theta2 > 1e-24, phi / theta, torch.zeros_like(phi))
    d_w = -0.5 * torch.sin(half) * dtheta
    s = torch.where(theta2 > 1e-8, torch.sin(half) / theta,
                    0.5 - theta2 / 48.0)
    ds = torch.where(theta2 > 1e-8,
                     (0.5 * torch.cos(half) * theta - torch.sin(half))
                     / (theta * theta) * dtheta,
                     -phi / 24.0)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return torch.cat([d_w[None], s * eye + phi[:, None] * ds[None, :]])


def _transition_jacobian(cfg: MotionModelConfig, x, dt: float):
    """(13, 13) closed-form ∂f/∂x of ``_transition``."""
    quat, w = x[6:10], x[10:13]
    e = se3.so3_exp_quat(w * dt)
    u = se3.quat_mul(quat, e)
    norm_u = torch.clamp(torch.linalg.norm(u), min=1e-12)
    nq = u / norm_u
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    dnorm = (torch.eye(4, dtype=x.dtype, device=x.device)
             - nq[:, None] * nq[None, :]) / norm_u
    dq_dq = dnorm @ _quat_right(e)
    dq_dw = dnorm @ _quat_left(quat) @ _exp_quat_jacobian(w * dt) * dt
    z33 = torch.zeros_like(eye3)
    z34 = x.new_zeros((3, 4))
    return torch.cat([
        torch.cat([eye3, dt * eye3, z34, z33], dim=1),
        torch.cat([z33, cfg.decay * eye3, z34, z33], dim=1),
        torch.cat([x.new_zeros((4, 6)), dq_dq, dq_dw], dim=1),
        torch.cat([z33, z33, z34, cfg.decay * eye3], dim=1),
    ])


def predict(cfg: MotionModelConfig, s: EKFState, dt: float) -> EKFState:
    """Time update: x' = f(x), P' = F P Fᵀ + Q."""
    F = _transition_jacobian(cfg, s.x, dt)
    Q = _diag(((3, cfg.q_pos), (3, cfg.q_vel), (4, cfg.q_quat),
               (3, cfg.q_angvel)), s.x)
    return EKFState(_transition(cfg, s.x, dt), F @ s.P @ F.T + Q)


def correct(cfg: MotionModelConfig, s: EKFState, pose_meas) -> EKFState:
    """Measurement update with a pose [t, q]; the measured quaternion takes
    the state's hemisphere first (double cover)."""
    x = s.x
    H = torch.zeros((7, STATE_DIM), dtype=x.dtype, device=x.device)
    H[0:3, 0:3] = torch.eye(3, dtype=x.dtype, device=x.device)
    H[3:7, 6:10] = torch.eye(4, dtype=x.dtype, device=x.device)
    R = _diag(((3, cfg.r_pos), (4, cfg.r_quat)), x)
    q_meas = se3.rotation_quat(pose_meas)
    q_meas = torch.where(torch.dot(q_meas, x[6:10]) < 0, -q_meas, q_meas)
    z = torch.cat([se3.translation(pose_meas), q_meas])
    y = z - H @ x
    S = H @ s.P @ H.T + R
    K = s.P @ H.T @ torch.linalg.inv_ex(S)[0]   # no error check: no sync
    x2 = x + K @ y
    x2 = torch.cat([x2[0:6], se3.quat_normalize(x2[6:10]), x2[10:13]])
    P2 = (torch.eye(STATE_DIM, dtype=x.dtype, device=x.device) - K @ H) @ s.P
    return EKFState(x2, P2)


def predicted_pose(s: EKFState) -> torch.Tensor:
    return se3.make_pose(s.x[0:3], s.x[6:10])
