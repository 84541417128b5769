"""SE(3) rigid transforms as tensors (port of `orb_slam2_tpu/geometry/se3.py`).

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


_EPS = 1e-9


def so3_exp(w):
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    A, B, _ = _coefficients(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye3(w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R):
    """(...,3,3) rotation -> (...,3) axis-angle, with the reference's two
    special branches: theta ~ 0 by a Taylor series in sin^2(theta), theta ~ pi
    by the diagonal formula with the signs of the antisymmetric part."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    # vee of the antisymmetric part: v = 2 sin(theta) * axis
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s2 = 0.25 * torch.sum(v * v, dim=-1)                 # sin^2(theta)
    small = s2 < 1e-10
    sin_t = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(sin_t, cos_t)
    w = torch.where(small, 0.5 + s2 / 12.0, theta / (2.0 * sin_t))[..., None] * v
    near_pi = cos_t < -0.999999
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    one_m_c = torch.where(torch.abs(1.0 - cos_t) < _EPS, torch.ones_like(cos_t), 1.0 - cos_t)
    axis = torch.sqrt(torch.clamp((diag - cos_t[..., None]) / one_m_c[..., None], min=1e-12))
    sgn = torch.where(v >= 0, 1.0, -1.0).to(R.dtype)
    return torch.where(near_pi[..., None], axis * sgn * theta[..., None], w)


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


def log(T):
    """SE3 log -> (...,6) (rho, phi)."""
    phi = so3_log(rotation(T))
    theta2 = torch.sum(phi * phi, dim=-1)
    A, B, _ = _coefficients(theta2)
    small = theta2 < 1e-12
    W = hat(phi)
    # V^-1 = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    coef = torch.where(small, torch.full_like(theta2, 1.0 / 12.0),
                       (1.0 - A / (2.0 * B)) / torch.where(small, torch.ones_like(theta2), theta2))
    Vinv = _eye3(T) - 0.5 * W + coef[..., None, None] * (W @ W)
    rho = (Vinv @ translation(T)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def _norm_fma(q):
    """The Euclidean norm over the last axis, keepdim, summed as XLA's CPU
    reduction does: each square after the first added by a fused
    multiply-add (the float32 product is exact in float64), so quaternions
    round as the reference's and TUM files come out byte-equal."""
    acc = q[..., 0] * q[..., 0]
    for i in range(1, q.shape[-1]):
        x = q[..., i].double()
        acc = (x * x + acc.double()).to(q.dtype)
    return torch.sqrt(acc)[..., None]


def to_quat(R):
    """(...,3,3) -> (...,4) quaternion (x, y, z, w), the TUM convention:
    Shepperd's four cases, the one of the largest diagonal term taken."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def two_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s = two_sqrt(tr + 1.0)
    qw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], dim=-1)
    s = two_sqrt(1.0 + m00 - m11 - m22)
    qx = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], dim=-1)
    s = two_sqrt(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], dim=-1)
    s = two_sqrt(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], dim=-1)
    use_w = tr > 0
    use_x = ~use_w & (m00 >= m11) & (m00 >= m22)
    use_y = ~use_w & ~use_x & (m11 >= m22)
    q = torch.where(use_w[..., None], qw,
                    torch.where(use_x[..., None], qx, torch.where(use_y[..., None], qy, qz)))
    return q / _norm_fma(q)


def from_quat(q):
    """(...,4) quaternion (x, y, z, w) -> (...,3,3)."""
    q = q / _norm_fma(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)
