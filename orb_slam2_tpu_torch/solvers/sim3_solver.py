"""Sim3 from 3D-3D correspondences: closed form, RANSAC and the two-view
refinement (port of `orb_slam2_tpu/solvers/sim3_solver.py`).

`Sim3Solver` (`src/Sim3Solver.cc`): the closed-form similarity of matched
point sets (Horn / Umeyama, by a batched 3x3 SVD), every RANSAC hypothesis
of 3 pairs solved and scored at once as one leading batch dimension, with
the two-sided chi2 test of `CheckInliers` (`src/Sim3Solver.cc:313-330`)
and the disparity channel where a feature has a right x. Then
`Optimizer::OptimizeSim3`'s reprojection refinement, its Jacobian by
forward-mode differentiation (dual tensors) as the reference's `jacfwd`.
Float32 on the inputs' device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..geometry import sim3
from ..utils.config import device_table


def horn_sim3(p1, p2, fix_scale: bool = False, w=None) -> sim3.Sim3:
    """Closed-form g21 mapping p1 -> p2, p2 ~ s R p1 + t (ComputeSim3,
    `src/Sim3Solver.cc:205-310`; the rotation by Kabsch / Umeyama SVD, the
    same solution as Horn's quaternion). p1, p2 (..., n, 3), optional
    weights w (..., n); batched over the leading axes."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    ws = torch.clamp(w.sum(dim=-1), min=1e-9)[..., None]
    mu1 = (p1 * w[..., None]).sum(dim=-2) / ws
    mu2 = (p2 * w[..., None]).sum(dim=-2) / ws
    c1, c2 = p1 - mu1[..., None, :], p2 - mu2[..., None, :]
    H = torch.einsum("...ni,...nj,...n->...ij", c1, c2, w)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ D @ Ut
    rc1 = (R[..., None, :, :] @ c1[..., None])[..., 0]
    num = (c2 * rc1 * w[..., None]).sum(dim=(-2, -1))
    den = (rc1 * rc1 * w[..., None]).sum(dim=(-2, -1))
    s = torch.ones_like(num) if fix_scale else num / torch.clamp(den, min=1e-12)
    t = mu2 - s[..., None] * (R @ mu1[..., None])[..., 0]
    return sim3.Sim3(R, t, s)


class Sim3Result(NamedTuple):
    g12: sim3.Sim3          # maps frame-2 camera points into frame 1
    inliers: torch.Tensor   # (E,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor        # () bool


def _project(p, fx, fy, cx, cy):
    z = torch.clamp(p[..., 2], min=1e-9)
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1)


def _levels(level_sigma2, level, dev):
    sigma2 = device_table(tuple(level_sigma2), dev)
    return sigma2[torch.clamp(level, 0, sigma2.shape[0] - 1).long()]


def ransac_sim3(pc1, pc2, level1, level2, valid, level_sigma2, fx: float, fy: float,
                cx: float, cy: float, n_hyp: int = 128, fix_scale: bool = False,
                min_inliers: int = 20, generator: torch.Generator = None, draws=None,
                ur1=None, ur2=None, bf: float = 0.0) -> Sim3Result:
    """pc1, pc2 (E,3): matched points in camera frames 1 and 2; g12 with
    p1 ~ g12(p2). Inlier: g12 p2 projected into image 1 and g12^-1 p1 into
    image 2 within chi2 9.21 sigma^2 of the keypoint's octave (11.34 with
    the disparity residual where ur >= 0 and bf > 0: it breaks the planar
    two-fold ambiguity). The best hypothesis is refit on its inliers and
    kept if it holds as many. The (n_hyp, 3) draws index the valid pairs:
    from `generator` (a CPU `torch.Generator`, so both devices draw the
    same) or handed in as `draws`. One host read: the valid count, the
    draws' range."""
    dev = pc1.device
    n_valid = int(valid.sum())
    packed = torch.argsort((~valid).to(torch.uint8), stable=True)
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = torch.randint(0, max(n_valid, 1), (n_hyp, 3), generator=generator)
    sets = packed[torch.as_tensor(draws, device=dev).long()]

    s1, s2 = _levels(level_sigma2, level1, dev), _levels(level_sigma2, level2, dev)
    stereo1 = ur1 is not None and bf > 0
    stereo2 = ur2 is not None and bf > 0
    th1 = torch.where(ur1 >= 0, 11.34, 9.21) * s1 if stereo1 else 9.21 * s1
    th2 = torch.where(ur2 >= 0, 11.34, 9.21) * s2 if stereo2 else 9.21 * s2

    def ur_err(p, ur_meas, uv_pred, on):
        if not on:
            return 0.0
        ur_pred = uv_pred[..., 0] - bf / torch.clamp(p[..., 2], min=1e-9)
        return torch.where(ur_meas >= 0, (ur_pred - ur_meas) ** 2, torch.zeros_like(ur_pred))

    uv1, uv2 = _project(pc1, fx, fy, cx, cy), _project(pc2, fx, fy, cx, cy)

    def score(g):
        """Inliers of transforms g with leading shape L: (L,) counts, (L,E)."""
        gb = sim3.Sim3(g.R[..., None, :, :], g.t[..., None, :], g.s[..., None])
        p1h = sim3.apply(gb, pc2)
        uv1h = _project(p1h, fx, fy, cx, cy)
        e1 = ((uv1h - uv1) ** 2).sum(dim=-1) + ur_err(p1h, ur1, uv1h, stereo1)
        p2h = sim3.apply(sim3.inverse(gb), pc1)
        uv2h = _project(p2h, fx, fy, cx, cy)
        e2 = ((uv2h - uv2) ** 2).sum(dim=-1) + ur_err(p2h, ur2, uv2h, stereo2)
        inl = valid & (e1 < th1) & (e2 < th2)
        return inl.sum(dim=-1, dtype=torch.int32), inl

    gs = horn_sim3(pc2[sets], pc1[sets], fix_scale=fix_scale)      # (H,) hypotheses
    ns, _ = score(gs)
    best = torch.argmax(ns)
    g_best = gs.take(best)
    n0, inl0 = score(g_best)
    g_ref = horn_sim3(pc2, pc1, fix_scale=fix_scale, w=inl0.to(torch.float32))
    n1, inl1 = score(g_ref)
    use_ref = n1 >= n0
    g = sim3.where(use_ref, g_ref, g_best)
    n = torch.where(use_ref, n1, n0)
    inl = torch.where(use_ref, inl1, inl0)
    return Sim3Result(g12=g, inliers=inl, n_inliers=n, ok=n >= min_inliers)


def optimize_sim3(g12: sim3.Sim3, pc1, pc2, uv1, uv2, level1, level2, valid, level_sigma2,
                  fx: float, fy: float, cx: float, cy: float, fix_scale: bool = False,
                  th2: float = 10.0, iters_a: int = 5, iters_b: int = 10,
                  ur1=None, ur2=None, bf: float = 0.0):
    """Reprojection refinement of g12 (`Optimizer::OptimizeSim3`,
    `src/Optimizer.cc:1405-1640`): Gauss-Newton on the two-view pixel
    residuals e1 = proj(g12 pc2) - uv1 and e2 = proj(g12^-1 pc1) - uv2 (and
    the disparity channel where measured) with per-octave information and
    a Huber kernel of delta sqrt(10); after iters_a steps the pairs with
    chi2 > th2 either way drop out, iters_b more, then the survivors are
    counted. pc1/pc2 (E,3), uv1/uv2 (E,2). Returns (g12', inliers (E,),
    n_inliers ()). No host read."""
    dev = pc1.device
    w1 = 1.0 / _levels(level_sigma2, level1, dev)
    w2 = 1.0 / _levels(level_sigma2, level2, dev)

    def project3(p, ur_meas):
        z = torch.clamp(p[..., 2], min=1e-9)
        u = fx * p[..., 0] / z + cx
        v = fy * p[..., 1] / z + cy
        if ur_meas is None or bf <= 0:
            ur_r = torch.zeros_like(u)
        else:
            ur_r = torch.where(ur_meas >= 0, (u - bf / z) - ur_meas, torch.zeros_like(u))
        return torch.stack([u, v, ur_r], dim=-1)

    zero1 = torch.zeros(uv1.shape[:-1] + (1,), dtype=uv1.dtype, device=dev)
    obs = torch.cat([torch.cat([uv1, zero1], dim=-1), torch.cat([uv2, zero1], dim=-1)])

    def residuals(zeta, g):
        """(B,2E,3) residuals at the B transforms exp(zeta) g."""
        gz = sim3.compose(sim3.exp(zeta), g)
        gb = sim3.Sim3(gz.R[:, None], gz.t[:, None], gz.s[:, None])
        return torch.cat([project3(sim3.apply(gb, pc2), ur1),
                          project3(sim3.apply(sim3.inverse(gb), pc1), ur2)], dim=-2) - obs

    delta2 = 10.0
    w = torch.cat([w1, w2])
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)

    def gn_step(g, mask):
        # the residuals and their Jacobian (2E,3,7) in one forward-mode pass,
        # one transform per tangent direction
        with fwAD.dual_level():
            r, J = fwAD.unpack_dual(residuals(fwAD.make_dual(torch.zeros_like(eye7), eye7), g))
        r, J = r[0], J.permute(1, 2, 0)
        m = torch.cat([mask, mask])
        chi2 = (r * r).sum(dim=-1) * w
        huber = torch.where(chi2 <= delta2, 1.0,
                            torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
        wr = w * huber * m
        H = torch.einsum("eij,e,eik->jk", J, wr, J)
        b = torch.einsum("eij,e,ei->j", J, wr, r)
        if fix_scale:
            keep = torch.arange(7, device=dev) < 6
            H = torch.where(keep[:, None] & keep[None, :], H, eye7)
            b = torch.where(keep, b, torch.zeros_like(b))
        dz = -torch.linalg.solve_ex(H + 1e-6 * eye7, b[:, None])[0][:, 0]
        dz = torch.where(torch.isfinite(dz).all(), dz, torch.zeros_like(dz))
        return sim3.compose(sim3.exp(dz), g)

    def chi2_both(g):
        r = residuals(torch.zeros((1, 7), dtype=torch.float32, device=dev), g)[0]
        c = (r * r).sum(dim=-1)
        n = pc1.shape[0]
        return c[:n] * w1, c[n:] * w2

    g, mask = g12, valid
    for _ in range(iters_a):
        g = gn_step(g, mask)
    c1, c2 = chi2_both(g)
    mask = mask & (c1 <= th2) & (c2 <= th2)
    for _ in range(iters_b):
        g = gn_step(g, mask)
    c1, c2 = chi2_both(g)
    inl = mask & (c1 <= th2) & (c2 <= th2)
    return g, inl, inl.sum(dtype=torch.int32)
