"""Large-map bundle adjustment by preconditioned conjugate gradients on the
implicit Schur complement (port of `orb_slam2_tpu/solvers/pcg_ba.py`,
the unsharded solver).

`schur_ba.solve_ba` forms the dense (Q, C) landmark-to-camera blocks, which
global BA at large capacities cannot afford. This solver never forms
S = Hcc - W Hpp^-1 W^T: block-Jacobi PCG (camera 6x6 blocks) runs on matvecs
through the per-edge pose-point blocks W_e (gather x at each edge's camera,
push through W_e^T, reduce per landmark through Hpp^-1, push back, sum per
camera), the structure of Ceres' ITERATIVE_SCHUR.

The linearization is K9's assembly (`schur_ba._assemble`): its `Lin`
carries exactly the reference's pieces (undamped Hcc, bc, Hpp, bp, the
per-edge W_e = Jp^T Omega Jl, pt_on, err, chi2). The per-camera sums of the
matvec are a product with the problem's (E, C) one-hot, so they run in a
fixed order (no scatter-add) and a solve repeats bit for bit. Plain PyTorch
on the problem's device; no host reads.
"""
from __future__ import annotations

import torch

from ..geometry import se3
from ..utils.config import device_table
from . import reproj
from .schur_ba import (BAProblem, BAResult, Lin, _assemble, _chol3x3, _damped, _edges,
                       _tri_inv_t)


def _precompute(lin: Lin, lam):
    """The damped pieces of one LM step from a linearization; Hpp^-1 =
    L L^T from the Cholesky factor of each damped block (schur_ba's
    factorization: the adjugate inverse of a thin-parallax block is not
    numerically SPD)."""
    eye3 = torch.eye(3, dtype=torch.float32, device=lin.Hpp.device)
    Hpp_d = torch.where(lin.pt_on[:, None, None], _damped(lin.Hpp, lam), eye3)
    L = _tri_inv_t(_chol3x3(Hpp_d))
    return dict(We=lin.We, Hpp_inv=L @ L.transpose(-1, -2), Hcc_d=_damped(lin.Hcc, lam),
                bc=lin.bc, bp=lin.bp, pt_on=lin.pt_on)


def _push_to_points(pre, edges, x):
    """v_q = sum over point q's edges of W_e^T x[cam(e)] : (Q,3)."""
    Q, O = pre["We"].shape[:2]
    xe = x[edges.cam.long()].reshape(Q, O, 6)
    return torch.einsum("qoij,qoi->qj", pre["We"], xe)


def _push_to_cameras(pre, edges, u):
    """sum over camera c's edges of W_e u[point(e)] : (C,6), a product with
    the one-hot (fixed order)."""
    ye = torch.einsum("qoij,qj->qoi", pre["We"], u).reshape(-1, 6)
    return edges.onehot.T @ ye


def _schur_matvec(pre, edges, x, free):
    """y = S x with S = Hcc_d - W Hpp^-1 W^T, implicit. x (C,6)."""
    x = torch.where(free[:, None], x, torch.zeros_like(x))
    u = torch.einsum("qij,qj->qi", pre["Hpp_inv"], _push_to_points(pre, edges, x))
    y = torch.einsum("cij,cj->ci", pre["Hcc_d"], x) - _push_to_cameras(pre, edges, u)
    return torch.where(free[:, None], y, torch.zeros_like(y))


def _reduced_rhs(pre, edges, free):
    """b_red = bc - W Hpp^-1 bp."""
    u = torch.einsum("qij,qj->qi", pre["Hpp_inv"], pre["bp"])
    b = pre["bc"] - _push_to_cameras(pre, edges, u)
    return torch.where(free[:, None], b, torch.zeros_like(b))


def _pcg(pre, edges, b, free, n_iters: int):
    """Block-Jacobi preconditioned CG on the reduced camera system."""
    eye6 = torch.eye(6, dtype=torch.float32, device=b.device)
    M = torch.where(free[:, None, None], pre["Hcc_d"], eye6)
    Minv = torch.linalg.inv_ex(M + 1e-8 * eye6)[0]

    def apply_M(r):
        return torch.einsum("cij,cj->ci", Minv, r)

    tiny = torch.full((), 1e-20, dtype=torch.float32, device=b.device)
    x = torch.zeros_like(b)
    r = b
    z = apply_M(r)
    p = z
    rz = (r * z).sum()
    for _ in range(n_iters):
        Ap = _schur_matvec(pre, edges, p, free)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(torch.abs(pAp) < 1e-20, tiny, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = (r * z).sum()
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, tiny, rz)
        p = z + beta * p
        rz = rz_new
    return x


def _step(pre, edges, free, cg_iters: int):
    """The camera step by PCG, then the landmarks back-substituted."""
    dx_c = _pcg(pre, edges, _reduced_rhs(pre, edges, free), free, cg_iters)
    v = _push_to_points(pre, edges, dx_c)
    dx_p = torch.einsum("qij,qj->qi", pre["Hpp_inv"], pre["bp"] - v)
    return dx_c, torch.where(pre["pt_on"][:, None], dx_p, torch.zeros_like(dx_p))


def solve_ba_pcg(cam, prob: BAProblem, level_sigma2, n_iters: int = 10, cg_iters: int = 50,
                 robust: bool = False) -> BAResult:
    """LM over the whole problem, each step's camera system by PCG: a step
    is kept if the error falls (lambda x0.3), else lambda x5. The
    linearization at a tentative state is K9's assembly, which also gives
    its error and, if kept, the next step's pieces. Returns the final
    chi2 classification (5.991 / 7.815 and positive depth)."""
    C = prob.poses.shape[0]
    sigma2 = device_table(tuple(level_sigma2), prob.points.device)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(prob.obs_level, 0, sigma2.shape[0] - 1).long()]
    base_mask = (prob.obs_cam >= 0) & prob.pt_valid[:, None] & \
        prob.cam_valid[torch.clamp(prob.obs_cam, 0, C - 1).long()]
    mask = base_mask.to(torch.float32)
    free = prob.cam_valid & ~prob.cam_fixed
    edges = _edges(prob, inv_sigma2)

    poses, points = prob.poses, prob.points
    lin = _assemble(cam, prob, edges, poses, points, mask, robust)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=poses.device)
    for _ in range(n_iters):
        dx_c, dx_p = _step(_precompute(lin, lam), edges, free, cg_iters)
        poses_new = se3.retract(poses, dx_c)
        points_new = points + dx_p
        lin_new = _assemble(cam, prob, edges, poses_new, points_new, mask, robust)
        accept = lin_new.err < lin.err         # False for NaN: the step is rejected
        poses = torch.where(accept, poses_new, poses)
        points = torch.where(accept, points_new, points)
        lin = Lin(*(torch.where(accept, a, b) for a, b in zip(lin_new, lin)))
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e4))
    stereo = prob.obs_uvr[..., 2] >= 0
    delta2 = torch.where(stereo, reproj.CHI2_STEREO, reproj.CHI2_MONO)
    inlier = base_mask & (lin.chi2 <= delta2) & lin.depth_ok
    return BAResult(poses=poses, points=points, edge_inlier=inlier, chi2=lin.chi2)
