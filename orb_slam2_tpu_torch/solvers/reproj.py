"""Batched reprojection residuals and analytic Jacobians (port of
`orb_slam2_tpu/solvers/reproj.py`).

g2o's `EdgeSE3ProjectXYZ` (mono) and `EdgeStereoSE3ProjectXYZ` (with u_R)
in one unified 3-component form (u, v, u_R): a monocular edge carries zero
weight on the third component, so mono and stereo edges batch together.
The pose tangent is xi = (rho, phi) with the left-multiplicative update.
"""
from __future__ import annotations

import torch

from ..geometry import se3

CHI2_MONO = 5.991    # chi2(0.95, 2 dof), src/Optimizer.cc:507
CHI2_STEREO = 7.815  # chi2(0.95, 3 dof), src/Optimizer.cc:510


def project_residual(cam, Tcw, Xw, obs_uvr, is_stereo):
    """Residual e = obs - predicted, in (u, v, uR) form. Xw, obs_uvr (E,3);
    is_stereo (E,) bool. Returns e (E,3), the camera-frame points pc (E,3)
    and the per-component weights comp_w (E,3): (1,1,1) stereo, (1,1,0)
    mono. z is clamped to 1e-9 (the penalty form: a point behind the camera
    scores a huge error)."""
    pc = se3.apply(Tcw, Xw)
    z = torch.clamp(pc[..., 2], min=1e-9)
    inv_z = 1.0 / z
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    e = obs_uvr - torch.stack([u, v, ur], dim=-1)
    one = torch.ones_like(z)
    comp_w = torch.stack([one, one, is_stereo.to(z.dtype)], dim=-1)
    return e, pc, comp_w


def proj_jacobians(cam, pc):
    """d(pred)/d(pc): (E,3,3) for the (u, v, uR) prediction."""
    x, y = pc[..., 0], pc[..., 1]
    inv_z = 1.0 / torch.clamp(pc[..., 2], min=1e-9)
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, cam.bf * inv_z2], dim=-1)
    return torch.stack([du, dv, dur], dim=-2)


def pose_point_jacobians(cam, Tcw, pc):
    """Jacobians of e = obs - pred (note the minus sign): J_pose (E,3,6)
    with respect to xi = (rho, phi), J_point (E,3,3) with respect to the
    world point."""
    A = proj_jacobians(cam, pc)                          # d pred / d pc
    H = se3.hat(pc)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(H.shape)
    J_pose = -(A @ torch.cat([eye, -H], dim=-1))         # d pc / d xi = [I  -hat(pc)]
    J_point = -(A @ se3.rotation(Tcw).expand(H.shape))
    return J_pose, J_point


def edge_chi2(e, comp_w, inv_sigma2):
    """chi2 = e^T Omega e with Omega = inv_sigma2 * diag(comp_w)."""
    return inv_sigma2 * torch.sum(e * e * comp_w, dim=-1)


def huber_weight(chi2, delta2):
    """rho'(chi2) of the Huber kernel with delta^2 = delta2: 1 inside,
    delta / sqrt(chi2) outside (g2o `RobustKernelHuber`)."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
