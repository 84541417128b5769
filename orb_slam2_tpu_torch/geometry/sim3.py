"""Sim(3) similarity transforms: rotation R, translation t, scale s (port of
`orb_slam2_tpu/geometry/sim3.py`).

g2o's `Sim3` (`Thirdparty/g2o/g2o/types/sim3/sim3.h`), used by loop closing
and the essential graph. A `Sim3` is a NamedTuple of tensors batched over
leading axes: R (...,3,3), t (...,3), s (...). The tangent is
zeta = (rho(3), phi(3), sigma(1)) with Strasdat's Sim3 exponential. Float32
on the tensors' device; no host reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class Sim3(NamedTuple):
    R: torch.Tensor  # (...,3,3)
    t: torch.Tensor  # (...,3)
    s: torch.Tensor  # (...,)

    @staticmethod
    def identity(dtype=torch.float32, device="cuda"):
        return Sim3(torch.eye(3, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device),
                    torch.ones((), dtype=dtype, device=device))

    @staticmethod
    def from_se3(T, s=None):
        if s is None:
            s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
        return Sim3(se3.rotation(T), se3.translation(T), s)

    def to_se3(self):
        """The SE3 pose LoopClosing writes back to a keyframe: R kept,
        translation divided by the scale (`src/LoopClosing.cc:648-660`)."""
        return se3.make(self.R, self.t / self.s[..., None])

    def take(self, idx):
        """The transforms at index tensor idx of the leading axis."""
        return Sim3(self.R[idx], self.t[idx], self.s[idx])


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def compose(a: Sim3, b: Sim3) -> Sim3:
    """a * b : x -> s_a R_a (s_b R_b x + t_b) + t_a."""
    return Sim3(a.R @ b.R, a.s[..., None] * _mv(a.R, b.t) + a.t, a.s * b.s)


def inverse(g: Sim3) -> Sim3:
    Rt = g.R.transpose(-1, -2)
    s_inv = 1.0 / g.s
    return Sim3(Rt, -s_inv[..., None] * _mv(Rt, g.t), s_inv)


def apply(g: Sim3, p):
    """Map points: s R p + t. p (...,3)."""
    return g.s[..., None] * _mv(g.R, p) + g.t


def where(cond, a: Sim3, b: Sim3) -> Sim3:
    """a where cond (broadcast over the leading axes), else b."""
    return Sim3(torch.where(cond[..., None, None], a.R, b.R),
                torch.where(cond[..., None], a.t, b.t), torch.where(cond, a.s, b.s))


def _V(phi, sigma):
    """The translation block V of Strasdat's Sim3 exp (t = V rho), V =
    I_coef I + W_coef W + W2_coef W^2, with the four small / large sigma x
    theta cases of Sophus' calcW; each selected branch is safe under
    forward-mode differentiation at its limit."""
    s = torch.exp(sigma)
    theta2 = torch.sum(phi * phi, dim=-1)
    W = se3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    eps = 1e-5
    sig_small = torch.abs(sigma) < eps
    th_small = theta2 < eps * eps
    one = torch.ones_like(sigma)
    sigma_safe = torch.where(sig_small, one, sigma)
    theta2_safe = torch.where(th_small, one, theta2)
    theta = torch.sqrt(theta2_safe)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a = s * sin_t
    b = s * cos_t
    c2 = theta2_safe + sigma_safe * sigma_safe

    I_coef = torch.where(sig_small, one, (s - 1.0) / sigma_safe)
    W_sig0 = torch.where(th_small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2_safe)
    W_sig = torch.where(th_small, ((sigma_safe - 1.0) * s + 1.0) / (sigma_safe * sigma_safe),
                        (a * sigma_safe + (1.0 - b) * theta) / (theta * c2))
    W_coef = torch.where(sig_small, W_sig0, W_sig)
    W2_sig0 = torch.where(th_small, 1.0 / 6.0 - theta2 / 120.0,
                          (theta - sin_t) / (theta2_safe * theta))
    W2_sig = torch.where(
        th_small,
        ((0.5 * sigma_safe * sigma_safe - sigma_safe + 1.0) * s - 1.0) / (sigma_safe ** 3),
        (I_coef - ((b - 1.0) * sigma_safe + a * theta) / c2) / theta2_safe)
    W2_coef = torch.where(sig_small, W2_sig0, W2_sig)
    return I_coef[..., None, None] * eye + W_coef[..., None, None] * W + \
        W2_coef[..., None, None] * (W @ W)


def exp(zeta) -> Sim3:
    """(...,7) = (rho, phi, sigma) -> Sim3 (Strasdat / g2o Sim3 exp)."""
    rho, phi, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    return Sim3(se3.so3_exp(phi), _mv(_V(phi, sigma), rho), torch.exp(sigma))


def _solve3(A, b):
    """A^-1 b for batched 3x3 A by the adjugate (no pivoting, no host
    check; A is exp's V, well conditioned)."""
    a, b_, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    adj = torch.stack([torch.stack([e * i - f * h, c * h - b_ * i, b_ * f - c * e], dim=-1),
                       torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
                       torch.stack([d * h - e * g, b_ * g - a * h, a * e - b_ * d], dim=-1)],
                      dim=-2)
    det = a * (e * i - f * h) + b_ * (f * g - d * i) + c * (d * h - e * g)
    return _mv(adj, b) / det[..., None]


def log(g: Sim3):
    """Sim3 -> (...,7): phi = so3_log(R), sigma = log(s), rho = V^-1 t
    with exp's V."""
    phi = se3.so3_log(g.R)
    sigma = torch.log(g.s)
    rho = _solve3(_V(phi, sigma), g.t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
