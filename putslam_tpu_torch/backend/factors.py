"""Factor residuals, closed-form Jacobians and robust kernels — port of
``putslam_tpu/backend/factors.py``: the 3D Euclidean observation factor
(``error_type=0``), the 2D reprojection factor (``error_type=1``) and the
pose-pose relative-motion factor.
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


def _guarded_z(p_cam):
    z = p_cam[..., 2]
    return torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)


def _project(p_cam, fu: float, fv: float):
    """Pinhole projection to *centred* pixel offsets (the principal point
    cancels in the residual)."""
    z = _guarded_z(p_cam)
    return torch.stack([fu * p_cam[..., 0] / z, fv * p_cam[..., 1] / z],
                       dim=-1)


def reproj_residual(kf_pose, lm_world, z_cam, fu: float, fv: float):
    """r = π(T_kf⁻¹(l_world)) − π(z_cam): (...,7), (...,3), (...,3) →
    (...,2) pixels. The measurement is the projection of the stored
    camera-frame point, so one edge store serves both factor types."""
    p_cam = se3.apply(se3.inverse(kf_pose), lm_world)
    return _project(p_cam, fu, fv) - _project(z_cam, fu, fv)


def reproj_jacobians(kf_pose, lm_world, fu: float, fv: float):
    """The projection Jacobian J_π = [[fu/z, 0, −fu·x/z²], [0, fv/z,
    −fv·y/z²]] chained with the 3D-point Jacobians: (...,2,6), (...,2,3)."""
    p_cam = se3.apply(se3.inverse(kf_pose), lm_world)
    x, y = p_cam[..., 0], p_cam[..., 1]
    z = _guarded_z(p_cam)
    zero = torch.zeros_like(z)
    J_pi = torch.stack([
        torch.stack([fu / z, zero, -fu * x / (z * z)], dim=-1),
        torch.stack([zero, fv / z, -fv * y / (z * z)], dim=-1),
    ], dim=-2)
    Jp3, Jl3 = obs_jacobians(kf_pose, lm_world)
    return J_pi @ Jp3, J_pi @ Jl3


def assemble_obs_terms(kf_p, lm_p, z_cam, error_type: int,
                       fu: float = 1.0, fv: float = 1.0):
    """Residuals + Jacobians for a batch of pose-landmark edges:
    0 → 3D Euclidean (r (M,3), Jp (M,3,6), Jl (M,3,3)),
    1 → 2D reprojection (r (M,2), Jp (M,2,6), Jl (M,2,3))."""
    if error_type == 0:
        r = obs_residual(kf_p, lm_p, z_cam)
        Jp, Jl = obs_jacobians(kf_p, lm_p)
    elif error_type == 1:
        r = reproj_residual(kf_p, lm_p, z_cam, fu, fv)
        Jp, Jl = reproj_jacobians(kf_p, lm_p, fu, fv)
    else:
        raise ValueError(f"unknown error_type {error_type}")
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


def pp_jacobians_autodiff(pose_i, pose_j, z_rel):
    """Forward-mode autodiff of ``pp_residual`` through the exact log map
    (``putslam_tpu/backend/factors.py:157``), batched with
    ``torch.func.vmap``: the oracle the closed form is checked against.
    Kept out of the solvers (its first call costs seconds)."""
    from torch.func import jacfwd, vmap

    zeros = torch.zeros(pose_i.shape[:-1] + (6,), dtype=pose_i.dtype,
                        device=pose_i.device)

    def r_of(xi_i, xi_j, Ti, Tj, Z):
        return pp_residual(se3.retract(Ti, xi_i), se3.retract(Tj, xi_j), Z)

    Ji = vmap(lambda Ti, Tj, Z, z: jacfwd(
        lambda a: r_of(a, z, Ti, Tj, Z))(z))(pose_i, pose_j, z_rel, zeros)
    Jj = vmap(lambda Ti, Tj, Z, z: jacfwd(
        lambda b: r_of(z, b, Ti, Tj, Z))(z))(pose_i, pose_j, z_rel, zeros)
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
