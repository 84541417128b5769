"""SE(3) rigid transforms as float32 tensors (port of
`orb_slam2_tpu/geometry/se3.py`, the part tracking needs).

Poses are (..., 4, 4) homogeneous matrices; leading axes broadcast. The
tangent vector is xi = (rho, phi), translation first, and `retract` is the
left-multiplicative update exp(xi) * T (g2o `VertexSE3Expmap::oplusImpl`).
"""
from __future__ import annotations

import torch


def hat(w):
    """so(3) hat operator: (...,3) -> (...,3,3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], dim=-1),
                        torch.stack([wz, z, -wx], dim=-1),
                        torch.stack([-wy, wx, z], dim=-1)], dim=-2)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _coefficients(theta2):
    """A = sin(t)/t, B = (1-cos(t))/t^2, C = (t-sin(t))/t^3, Taylor-safe."""
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < 1e-12
    one = torch.ones_like(theta2)
    safe_t = torch.where(small, one, theta)
    safe_t2 = torch.where(small, one, theta2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / safe_t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.where(small, one, theta2 * theta))
    return A, B, C


def so3_exp(w):
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    A, B, _ = _coefficients(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye3(w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def make(R, t):
    """(...,4,4) from a (...,3,3) rotation and a (...,3) translation."""
    shape = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    # from an identity, not `T[..., 3, 3] = 1.0`: setting a CUDA tensor from
    # a Python scalar copies it from the host and waits for the stream
    T = torch.eye(4, dtype=R.dtype, device=R.device).expand(shape + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def rotation(T):
    return T[..., :3, :3]


def translation(T):
    return T[..., :3, 3]


def inverse(T):
    """Closed-form SE3 inverse (R^T, -R^T t)."""
    Rt = rotation(T).transpose(-1, -2)
    return make(Rt, -(Rt @ translation(T)[..., None])[..., 0])


def orthonormalize(T):
    """Project the rotation block onto SO(3) with two Newton steps of
    R <- R (3I - R^T R) / 2 and pin the homogeneous row: on-device pose
    chains otherwise accumulate non-orthogonality that the transpose-form
    `inverse` amplifies frame after frame (`se3.py:121-135` of the
    reference)."""
    R = rotation(T)
    eye = _eye3(T)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * R.transpose(-1, -2) @ R)
    return make(R, translation(T))


def apply(T, p):
    """Transform points: (...,4,4) x (...,3) -> (...,3)."""
    return (rotation(T) @ p[..., None])[..., 0] + translation(T)


def exp(xi):
    """se(3) exp of xi = (rho, phi) -> (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    A, B, C = _coefficients(torch.sum(phi * phi, dim=-1))
    W = hat(phi)
    W2 = W @ W
    eye = _eye3(xi)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    return make(R, (V @ rho[..., None])[..., 0])


def retract(T, xi):
    """Left-multiplicative update exp(xi) * T."""
    return exp(xi) @ T
