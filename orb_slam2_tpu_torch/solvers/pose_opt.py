"""Motion-only bundle adjustment, the pose optimization of tracking (port of
`orb_slam2_tpu/solvers/pose_opt.py`).

`Optimizer::PoseOptimization` (`src/Optimizer.cc:375-622`): unary
reprojection edges on one SE3 vertex, Huber kernel (delta^2 = 5.991 mono,
7.815 stereo), information 1/sigma^2 of the keypoint octave, and the
reference's schedule of 4 rounds x 10 Levenberg-Marquardt iterations with
chi2(0.95) reclassification between rounds and the robust kernel dropped
for the last two (`src/Optimizer.cc:531-611`).

On a CUDA tensor the whole schedule is one launch of the K6 kernel
(`ops/cuda_pose.pose_lm`); on a CPU tensor its twin runs the schedule
below, one normal-equation build per iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..ops import cuda_pose
from ..utils.config import device_table
from . import reproj


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor        # (4,4)
    inliers: torch.Tensor    # (E,) bool: the final chi2 classification
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor       # (E,) float32


def normal_eq_terms(cam, Tcw, Xw, obs, comp_stereo, inv_sigma2, weight_mask,
                    robust: bool):
    """Per edge, the 28 terms the normal equations sum, (E, 28) float32: H's
    upper triangle (21, row-major), b (6) and chi2 (1), each zero for an
    edge masked out or behind the camera (NaN stays NaN: 0 * NaN).

    The reference kernel's per-edge rows (`_pose_sweep`), in the K6/K7
    kernels' operation order (elementwise ops, so nothing fuses into an
    FMA): J for e = obs - pred with respect to xi = (rho, phi), invz 0
    behind the camera so no product overflows to inf (0 * inf would put a
    NaN into H), and the weight in before any Jacobian product forms."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    x, y, z = Xw[:, 0], Xw[:, 1], Xw[:, 2]
    pcx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    pcy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    pcz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    depth_ok = pcz > 1e-6
    invz = torch.where(depth_ok, 1.0 / torch.clamp(pcz, min=1e-9), torch.zeros_like(pcz))
    invz2 = invz * invz
    u = cam.fx * pcx * invz + cam.cx
    v = cam.fy * pcy * invz + cam.cy
    ur = u - cam.bf * invz
    eu, ev, eur = obs[:, 0] - u, obs[:, 1] - v, obs[:, 2] - ur
    st = comp_stereo.to(torch.float32)
    chi2 = inv_sigma2 * (eu * eu + ev * ev + st * eur * eur)
    delta2 = torch.where(comp_stereo, reproj.CHI2_STEREO, reproj.CHI2_MONO)
    w_rob = reproj.huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
    m = weight_mask * depth_ok
    w = w_rob * inv_sigma2 * m

    a, b_ = cam.fx * invz, cam.fy * invz
    c = -cam.fx * pcx * invz2
    d = -cam.fy * pcy * invz2
    cr = c + cam.bf * invz2
    zero = torch.zeros_like(a)
    Ju = torch.stack([-a, zero, -c, -(c * pcy), -(a * pcz - c * pcx), a * pcy], dim=-1)
    Jv = torch.stack([zero, -b_, -d, -(-b_ * pcz + d * pcy), d * pcx, -b_ * pcx], dim=-1)
    Jr = torch.stack([-a, zero, -cr, -(cr * pcy), -(a * pcz - cr * pcx), a * pcy], dim=-1)
    wJu, wJv, wJr = w[:, None] * Ju, w[:, None] * Jv, (w * st)[:, None] * Jr
    i, j, _ = cuda_pose.triangle(Xw.device)
    h = wJu[:, i] * Ju[:, j] + wJv[:, i] * Jv[:, j] + wJr[:, i] * Jr[:, j]
    b = -(wJu * eu[:, None] + wJv * ev[:, None] + wJr * eur[:, None])
    return torch.cat([h, b, (chi2 * m)[:, None]], dim=1)


def _build_normal_eqs(cam, Tcw, Xw, obs, comp_stereo, inv_sigma2, weight_mask,
                      robust: bool):
    """The Gauss-Newton normal equations of min sum w ||e||^2 at Tcw:
    H (6,6) = sum w J^T diag(comp_w) J, b (6,) = -sum w J^T diag(comp_w) e,
    and err = sum chi2 over the masked edges in front of the camera, all
    float32 sums over the edges of `normal_eq_terms`."""
    s = normal_eq_terms(cam, Tcw, Xw, obs, comp_stereo, inv_sigma2, weight_mask,
                        robust).sum(dim=0)
    return s[cuda_pose.triangle(Xw.device)[2]], s[21:27], s[27]


def _lm_rounds(cam, Tcw, Xw, obs, comp_stereo, inv_sigma2, mask, robust: bool,
               n_iters: int):
    """One reference round: n_iters LM steps at a fixed inlier mask. One
    build per iteration: the build at an accepted pose is the next step's
    linearization, a rejected step keeps the carried H, b."""
    def build(T):
        return _build_normal_eqs(cam, T, Xw, obs, comp_stereo, inv_sigma2, mask, robust)

    T = Tcw
    H, b, err = build(T)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=Tcw.device)
    eye = torch.eye(6, dtype=torch.float32, device=Tcw.device)
    for _ in range(n_iters):
        Hd = H + lam * torch.diag(torch.diag(H)) + 1e-10 * eye
        dx = torch.linalg.solve_ex(Hd, b).result   # singular: inf/NaN, rejected
        T_new = se3.retract(T, dx)
        H_new, b_new, err_new = build(T_new)
        accept = err_new < err       # False for NaN: a non-SPD step is rejected
        T = torch.where(accept, T_new, T)
        H = torch.where(accept, H_new, H)
        b = torch.where(accept, b_new, b)
        err = torch.where(accept, err_new, err)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
    return T


def optimize_pose(cam, Tcw0, Xw, obs_uvr, level, valid, level_sigma2,
                  n_rounds: int = 4, n_iters: int = 10) -> PoseOptResult:
    """Xw (E,3) world points; obs_uvr (E,3) with uR = -1 for mono edges;
    level (E,) keypoint octave; valid (E,) bool edge mask; level_sigma2 the
    per-octave sigma^2 (a sequence of floats)."""
    sigma2 = device_table(tuple(level_sigma2), Xw.device)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(level, 0, sigma2.shape[0] - 1).long()]
    comp_stereo = obs_uvr[:, 2] >= 0
    # drop the seed's rotation non-orthogonality: the retract chain keeps
    # whatever error the seed carries
    Tcw = se3.orthonormalize(Tcw0)
    return PoseOptResult(*cuda_pose.pose_lm(cam, Tcw, Xw, obs_uvr, inv_sigma2,
                                            comp_stereo, valid, n_rounds, n_iters))
