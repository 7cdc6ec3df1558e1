"""Factor residuals, closed-form Jacobians and robust kernels — port of
``putslam_tpu/backend/factors.py`` for the 3D Euclidean observation factor
(``error_type=0``) and the pose-pose relative-motion factor.
"""

from __future__ import annotations

import torch

from putslam_tpu_torch.geometry import se3


def obs_residual(kf_pose, lm_world, z_cam):
    """r = T_kf⁻¹(l_world) − z_cam: (...,7), (...,3), (...,3) → (...,3)."""
    return se3.apply(se3.inverse(kf_pose), lm_world) - z_cam


def obs_jacobians(kf_pose, lm_world):
    """Right-perturbation Jacobians: ∂r/∂ξ = [−I | skew(p_cam)] (3×6),
    ∂r/∂l = Rᵀ (3×3)."""
    R = se3.quat_to_matrix(se3.rotation_quat(kf_pose))
    p_cam = se3.apply(se3.inverse(kf_pose), lm_world)
    eye = -torch.eye(3, dtype=kf_pose.dtype, device=kf_pose.device)
    J_pose = torch.cat([eye.expand(p_cam.shape[:-1] + (3, 3)),
                        se3.skew(p_cam)], dim=-1)
    return J_pose, R.transpose(-1, -2)


def assemble_obs_terms(kf_p, lm_p, z_cam, error_type: int):
    """Residuals + Jacobians for a batch of pose-landmark edges:
    r (M,3), Jp (M,3,6), Jl (M,3,3)."""
    if error_type != 0:
        raise NotImplementedError(
            f"backend.error_type={error_type} is not ported yet")
    r = obs_residual(kf_p, lm_p, z_cam)
    Jp, Jl = obs_jacobians(kf_p, lm_p)
    return r, Jp, Jl


def pp_residual(pose_i, pose_j, z_rel):
    """r = log(Z⁻¹ ∘ T_i⁻¹ ∘ T_j) ∈ R⁶."""
    return se3.log(se3.compose(se3.inverse(z_rel),
                               se3.compose(se3.inverse(pose_i), pose_j)))


def pp_jacobians(pose_i, pose_j, z_rel):
    """Exact closed-form Jacobians w.r.t. right perturbations of T_i, T_j:
    ∂r/∂ξ_j = Jr⁻¹(r), ∂r/∂ξ_i = −Jr⁻¹(r)·Ad(B⁻¹), B = T_i⁻¹ T_j."""
    r = pp_residual(pose_i, pose_j, z_rel)
    B_inv = se3.compose(se3.inverse(pose_j), pose_i)
    X, Y = se3.se3_left_jacobian_inv_blocks(-r)
    Z = torch.zeros_like(X)
    Jj = se3.blocks_to_6x6(X, Y, Z, X)
    R = se3.quat_to_matrix(se3.rotation_quat(B_inv))
    S = se3.skew(se3.translation(B_inv)) @ R
    XR = X @ R
    Ji = -se3.blocks_to_6x6(XR, X @ S + Y @ R, Z, XR)
    return Ji, Jj


def robust_weight(sq_err, kind: str, delta: float):
    """IRLS weight w(e²) on the weighted squared error."""
    if kind == "none":
        return torch.ones_like(sq_err)
    if kind == "cauchy":
        return 1.0 / (1.0 + sq_err / (delta * delta))
    if kind == "huber":
        e = torch.sqrt(torch.clamp(sq_err, min=1e-20))
        return torch.where(e <= delta, torch.ones_like(e), delta / e)
    raise ValueError(f"unknown robust kernel {kind!r}")
