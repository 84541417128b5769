"""EPnP inside RANSAC: the camera pose from 2D-3D matches, the
relocalization solver (port of `orb_slam2_tpu/solvers/pnp.py`).

`PnPsolver` (`src/PnPsolver.cc`): EPnP's control-point parameterization
(Lepetit et al.) solved for every RANSAC hypothesis at once, as one batch
of 6-point samples (the reference's `vmap` becomes a leading batch
dimension), beside a plane-homography pose per sample for coplanar scenes;
the dominant-kernel solution with a Horn alignment stands in for the
reference's beta-case Gauss-Newton, and the caller's pose optimization
refines the winner. Float32 throughout, as the reference. Plain PyTorch on
the inputs' device: batched eigh / SVD / solves of 3x3 to 12x12 systems.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..utils.config import device_table

_IU = ([0, 0, 0, 1, 1, 2], [1, 2, 3, 2, 3, 3])    # the 6 pairs of 4 control points


def _horn_rigid(src, dst):
    """Closed-form rigid alignment dst = R src + t over the last-but-one
    axis (Kabsch / Umeyama SVD, the quaternion method of
    `Sim3Solver::ComputeSim3`), every point weighted 1 as the reference's
    callers weight them. src, dst (..., n, 3); returns R (..., 3, 3), t
    (..., 3)."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    ws = w.sum(dim=-1)[..., None]
    mu_s = (src * w[..., None]).sum(dim=-2) / ws
    mu_d = (dst * w[..., None]).sum(dim=-2) / ws
    cs, cd = src - mu_s[..., None, :], dst - mu_d[..., None, :]
    H = torch.einsum("...ni,...nj,...n->...ij", cs, cd, w)      # src x dst correlation
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ D @ U.transpose(-1, -2)
    return R, mu_d - (R @ mu_s[..., None])[..., 0]


def _pca(Xw):
    """Centroid, centred points and the scatter's eigenpairs (ascending)."""
    c0 = Xw.mean(dim=-2)
    A = Xw - c0[..., None, :]
    vals, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A / Xw.shape[-2])
    return c0, A, vals, vecs


def _epnp_pose(Xw, uv, fx, fy, cx, cy):
    """EPnP on n >= 4 points, one hypothesis per leading index. Xw (..., n,
    3), uv (..., n, 2) -> Tcw (..., 4, 4)."""
    n = Xw.shape[-2]
    c0, _, vals, vecs = _pca(Xw)
    # control points: the centroid and the principal axes scaled by sqrt(eigval)
    cw = torch.stack([c0] + [c0 + torch.sqrt(torch.clamp(vals[..., i], min=1e-12))[..., None]
                             * vecs[..., :, i] for i in (2, 1, 0)], dim=-2)      # (...,4,3)
    # barycentric coordinates (compute_barycentric_coordinates)
    ones4 = torch.ones(cw.shape[:-2] + (1, 4), dtype=Xw.dtype, device=Xw.device)
    onesn = torch.ones(Xw.shape[:-2] + (1, n), dtype=Xw.dtype, device=Xw.device)
    CC = torch.cat([cw.transpose(-1, -2), ones4], dim=-2)
    Xh = torch.cat([Xw.transpose(-1, -2), onesn], dim=-2)
    alphas = torch.linalg.solve_ex(CC, Xh)[0].transpose(-1, -2)               # (...,n,4)
    # M (fill_M): 2n x 12
    u, v = uv[..., 0], uv[..., 1]
    zero = torch.zeros_like(u)
    r_u = torch.cat([torch.stack([a * fx, zero, a * (cx - u)], dim=-1)
                     for a in alphas.unbind(-1)], dim=-1)
    r_v = torch.cat([torch.stack([zero, a * fy, a * (cy - v)], dim=-1)
                     for a in alphas.unbind(-1)], dim=-1)
    M = torch.cat([r_u, r_v], dim=-2)
    kern = torch.linalg.eigh(M.transpose(-1, -2) @ M)[1][..., 0]
    kern = kern.reshape(kern.shape[:-1] + (4, 3))            # control points in the camera, up to scale

    def pdists(P):
        d = P[..., :, None, :] - P[..., None, :, :]
        return torch.sqrt(torch.clamp((d * d).sum(dim=-1), min=1e-18))[..., _IU[0], _IU[1]]

    # beta (the N=1 case): match the distances between control points
    dc, dw = pdists(kern), pdists(cw)
    beta = (dc * dw).sum(dim=-1) / torch.clamp((dc ** 2).sum(dim=-1), min=1e-12)
    pcs = alphas @ (beta[..., None, None] * kern)                            # (...,n,3)
    # positive depth (solve_for_sign)
    neg = (pcs[..., 2] < 0).sum(dim=-1) > n // 2
    pcs = pcs * torch.where(neg, -1.0, 1.0).to(pcs.dtype)[..., None, None]
    R, t = _horn_rigid(Xw, pcs)
    return se3.make(R, t)


def _planar_pose(Xw, uv, fx, fy, cx, cy):
    """The pose from (near-)coplanar points by a plane homography: EPnP's
    barycentric solve is singular on a plane (the reference's beta-case
    Gauss-Newton covers it, `src/PnPsolver.cc:718-1020`). PCA plane basis,
    DLT homography (plane -> normalized image), R and t from its first two
    columns made orthonormal. Exact on a plane, harmless elsewhere (RANSAC
    scores it against the EPnP hypothesis). Shapes as `_epnp_pose`."""
    c0, A, _, vecs = _pca(Xw)
    e1, e2, nrm = vecs[..., :, 2], vecs[..., :, 1], vecs[..., :, 0]
    s0 = (A * e1[..., None, :]).sum(dim=-1)
    s1 = (A * e2[..., None, :]).sum(dim=-1)
    mx, my = (uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy
    z, o = torch.zeros_like(s0), torch.ones_like(s0)
    r1 = torch.stack([s0, s1, o, z, z, z, -mx * s0, -mx * s1, -mx], dim=-1)
    r2 = torch.stack([z, z, z, s0, s1, o, -my * s0, -my * s1, -my], dim=-1)
    M = torch.cat([r1, r2], dim=-2)
    G = torch.linalg.eigh(M.transpose(-1, -2) @ M)[1][..., 0]
    G = G.reshape(G.shape[:-1] + (3, 3))
    # the plane's barycentre in front of the camera
    G = G * torch.where(G[..., 2, 2] < 0, -1.0, 1.0).to(G.dtype)[..., None, None]
    U2, S2, Vt2 = torch.linalg.svd(G[..., :, :2], full_matrices=False)
    Rc = U2 @ Vt2                                            # the closest orthonormal pair
    lam = 2.0 / torch.clamp(S2[..., 0] + S2[..., 1], min=1e-12)
    r3 = torch.linalg.cross(Rc[..., :, 0], Rc[..., :, 1], dim=-1)
    R_pl = torch.stack([Rc[..., :, 0], Rc[..., :, 1], r3], dim=-1)
    t_pl = lam[..., None] * G[..., :, 2]
    E = torch.stack([e1, e2, nrm], dim=-1)                   # world -> plane: E^T (X - c0)
    R_cw = R_pl @ E.transpose(-1, -2)
    return se3.make(R_cw, t_pl - (R_cw @ c0[..., None])[..., 0])


class PnPResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def ransac_pnp(Xw, uv, level, valid, level_sigma2, fx: float, fy: float, cx: float,
               cy: float, n_hyp: int = 256, generator: torch.Generator = None,
               draws=None) -> PnPResult:
    """Batched EPnP RANSAC (`PnPsolver::iterate`'s semantics; chi2 threshold
    5.991 sigma^2 of the keypoint's octave; the caller's pose optimization
    refines the winner). Samples of 6 (the dominant-kernel EPnP solution is
    exact from 6 points), each with an EPnP and a planar hypothesis. Xw
    (E,3), uv (E,2), level (E,), valid (E,) on one device. The (n_hyp, 6)
    draws index the valid matches: from `generator` (a CPU
    `torch.Generator`, so both devices draw the same), or handed in as
    `draws` (an int tensor)."""
    dev = Xw.device
    n_valid = int(valid.sum())                       # the draws' range: one host read
    packed = torch.argsort((~valid).to(torch.uint8), stable=True)
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = torch.randint(0, max(n_valid, 1), (n_hyp, 6), generator=generator)
    sets = packed[torch.as_tensor(draws, device=dev).long()]
    sigma2 = device_table(tuple(level_sigma2), dev)
    th2 = 5.991 * sigma2[torch.clamp(level, 0, sigma2.shape[0] - 1).long()]

    def score(T):
        pc = se3.apply(T[..., None, :, :], Xw)
        z = pc[..., 2]
        zc = torch.clamp(z, min=1e-9)
        u = fx * pc[..., 0] / zc + cx
        v = fy * pc[..., 1] / zc + cy
        inl = valid & (z > 0) & ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2 < th2)
        return inl.sum(dim=-1, dtype=torch.int32), inl

    Xs, us = Xw[sets], uv[sets]                                  # (H,6,3), (H,6,2)
    Ta, Tb = _epnp_pose(Xs, us, fx, fy, cx, cy), _planar_pose(Xs, us, fx, fy, cx, cy)
    na, nb = score(Ta)[0], score(Tb)[0]
    Ts = torch.where((nb > na)[:, None, None], Tb, Ta)
    best = torch.argmax(torch.maximum(na, nb))
    T_best = Ts[best]
    n_best, inl = score(T_best)
    ok = n_best >= min(10, max(n_valid // 2, 4))
    return PnPResult(Tcw=T_best, inliers=inl, n_inliers=n_best, ok=ok)
