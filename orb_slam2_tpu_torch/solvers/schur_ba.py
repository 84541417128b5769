"""Bundle adjustment by the Schur complement (port of
`orb_slam2_tpu/solvers/schur_ba.py`).

g2o's BlockSolver_6_3 with Levenberg-Marquardt as local BA runs it
(`Optimizer::LocalBundleAdjustment`, `src/Optimizer.cc:646-1067`). Fixed
shapes: C camera slots (optimized or fixed), Q point slots, observations
point-major (Q, O). The point block H_pp is block-diagonal 3x3, so the
reduced camera system S = H_cc - W H_pp^-1 W^T is assembled in A-form: with
L = chol(H_pp)^-T and U = sum_o A_e (A_e = W_e L) aggregated per camera,
S_corr = U U^T is one matrix product. S is solved by a dense Cholesky, the
points are back-substituted, and LM damps and iterates.

The assembly (per-edge terms, per-camera and per-point sums, `Lin`) is
one launch of the K9 kernel on a CUDA tensor and its twin on a CPU tensor
(`ops/cuda_ba.ba_assemble`); each edge's pose is read by its clamped camera
index, so a padded edge (camera -1) sees camera 0's pose, as the
reference's XLA path does, but joins no camera's sums. Its sums run in a
fixed order with no float atomics, so a solve repeats bit for bit; a NaN
edge makes only its own camera's Hcc NaN (the reference's one-hot product
spreads it to every camera), and the step is rejected either way.
`S_corr` is `torch.matmul` (TF32 off, pinned in `__init__`), the Cholesky
`torch.linalg.cholesky_ex`/`cholesky_solve`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..geometry import se3
from ..ops import cuda_ba
from ..utils.config import device_table
from . import reproj


class BAProblem(NamedTuple):
    poses: torch.Tensor      # (C,4,4) Tcw
    cam_valid: torch.Tensor  # (C,) bool: slot used
    cam_fixed: torch.Tensor  # (C,) bool: pose held constant
    points: torch.Tensor     # (Q,3)
    pt_valid: torch.Tensor   # (Q,) bool
    obs_cam: torch.Tensor    # (Q,O) int32 camera slot (-1 pad)
    obs_uvr: torch.Tensor    # (Q,O,3) observations (uR = -1 mono)
    obs_level: torch.Tensor  # (Q,O) int32


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    edge_inlier: torch.Tensor  # (Q,O) bool: the final chi2 classification
    chi2: torch.Tensor         # (Q,O)


class Lin(NamedTuple):
    """The undamped normal-equation pieces at one linearization point, and
    that edge pass's chi2 and depth classification."""
    Hcc: torch.Tensor       # (C,6,6)
    bc: torch.Tensor        # (C,6)
    Hpp: torch.Tensor       # (Q,3,3)
    bp: torch.Tensor        # (Q,3)
    We: torch.Tensor        # (Q,O,6,3) per-edge pose-point blocks
    pt_on: torch.Tensor     # (Q,)
    err: torch.Tensor       # ()
    chi2: torch.Tensor      # (Q,O)
    depth_ok: torch.Tensor  # (Q,O) bool


class _Edges(NamedTuple):
    """What the assembly needs of a problem, laid out once per solve."""
    cam: torch.Tensor        # (E,) int32 camera slot of each edge, clamped to [0, C)
    onehot: torch.Tensor     # (E,C) float32, zero rows for padded edges
    obs: torch.Tensor        # (3,E)
    stereo: torch.Tensor     # (E,) float32 0/1
    inv_sigma2: torch.Tensor  # (E,)
    order: torch.Tensor      # (E,) int32: the edges that join a camera, camera-major
    cam_start: torch.Tensor  # (C+1,) int32: camera c's edges are order[cam_start[c]:cam_start[c+1]]


def _edges(prob: BAProblem, inv_sigma2) -> _Edges:
    """The edge layout of a problem, on its device with no host sync: the
    camera-major list is a stable sort of the edges by camera (edges with
    no camera last), so each camera's edges keep their edge order."""
    C = prob.poses.shape[0]
    oc = prob.obs_cam.reshape(-1)
    slots = torch.arange(C, dtype=oc.dtype, device=oc.device)
    key = torch.where((oc >= 0) & (oc < C), oc, C).long()
    order = torch.argsort(key, stable=True)
    cam_start = torch.searchsorted(key[order], torch.arange(C + 1, device=oc.device))
    return _Edges(cam=torch.clamp(oc, 0, C - 1).to(torch.int32),
                  onehot=(oc[:, None] == slots[None, :]).to(torch.float32),
                  obs=prob.obs_uvr.reshape(-1, 3).T.contiguous(),
                  stereo=(prob.obs_uvr[..., 2] >= 0).reshape(-1).to(torch.float32),
                  inv_sigma2=inv_sigma2.reshape(-1).contiguous(),
                  order=order.to(torch.int32), cam_start=cam_start.to(torch.int32))


def _assemble(cam, prob: BAProblem, edges: _Edges, poses, points, edge_mask,
              robust: bool) -> Lin:
    """The undamped normal-equation pieces at the current linearization
    point (the reference's `_assemble_pallas`): one K9 launch
    (`cuda_ba.ba_assemble`). Damping and the solve live in `_solve_step`,
    so a rejected step retries with a larger lambda without another edge
    pass."""
    return Lin(*cuda_ba.ba_assemble(cam, poses, points, prob.pt_valid, edges, edge_mask,
                                    robust))


# The least pivot of a point block's Cholesky, relative to its diagonal
# entry. A pivot h_kk - sum l_kj^2 is known in float32 only to a few eps
# h_kk (eps = 1.2e-7): LM's relative damping falls to 1e-9, below that, and
# a point seen once without depth has a rank-2 block, so its last pivot is
# rounding noise. Clamped at 1e-20 it made a 1e10 factor, the reduced
# camera system indefinite and every low-damping step NaN (PERF.md, section 6).
# The floor damps such a block by 1e-5 (two digits above the noise); a
# block with a condition number below ~1e5 never reaches it.
PIVOT_FLOOR = 1e-5


def _chol3x3(H):
    """Closed-form batched lower Cholesky of symmetric 3x3 blocks, each
    pivot at least PIVOT_FLOOR times its diagonal entry (the eps clamps
    guard exact zeros only)."""
    eps = 1e-20
    h11, h12, h13 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    h22, h23, h33 = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    l11 = torch.sqrt(torch.clamp(h11, min=eps))
    l21 = h12 / l11
    l31 = h13 / l11
    l22 = torch.sqrt(torch.maximum(h22 - l21 * l21, torch.clamp(PIVOT_FLOOR * h22, min=eps)))
    l32 = (h23 - l31 * l21) / l22
    l33 = torch.sqrt(torch.maximum(h33 - l31 * l31 - l32 * l32,
                                   torch.clamp(PIVOT_FLOOR * h33, min=eps)))
    zero = torch.zeros_like(l11)
    return torch.stack([torch.stack([l11, zero, zero], dim=-1),
                        torch.stack([l21, l22, zero], dim=-1),
                        torch.stack([l31, l32, l33], dim=-1)], dim=-2)


def _tri_inv_t(L):
    """(L^-1)^T of batched lower-triangular 3x3 blocks, in closed form."""
    l11, l21, l31 = L[..., 0, 0], L[..., 1, 0], L[..., 2, 0]
    l22, l32, l33 = L[..., 1, 1], L[..., 2, 1], L[..., 2, 2]
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m33 = 1.0 / l33
    m21 = -l21 * m11 * m22
    m32 = -l32 * m22 * m33
    m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33
    zero = torch.zeros_like(l11)
    return torch.stack([torch.stack([m11, m21, m31], dim=-1),
                        torch.stack([zero, m22, m32], dim=-1),
                        torch.stack([zero, zero, m33], dim=-1)], dim=-2)


@functools.lru_cache(maxsize=16)
def _block_index(C: int, device):
    """Row and column indices of the C 6x6 diagonal blocks of a 6C x 6C
    matrix, in the order of a (C,6,6) tensor."""
    idx = torch.arange(C * 6, device=device).reshape(C, 6)
    return idx[:, :, None].expand(C, 6, 6).reshape(-1), idx[:, None, :].expand(C, 6, 6).reshape(-1)


def _damped(H, lam):
    n = H.shape[-1]
    scale = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1).max(dim=-1).values, min=1e-6)
    return H + lam * torch.eye(n, dtype=H.dtype, device=H.device) * scale[:, None, None]


def _solve_step(prob: BAProblem, edges: _Edges, lin: Lin, lam):
    """The damped Schur solve from a linearization, in A-form: with
    L = chol(Hpp_d)^-T and A_e = W_e L, U = sum over a point's observations
    of A_e per camera (6C x 3Q) gives S_corr = U U^T, b_red = bc - U (L^T bp)
    and dx_p = L (L^T bp - U^T dx_c). Returns (dx_c (C,6), dx_p (Q,3))."""
    C = lin.Hcc.shape[0]
    Q, O = lin.chi2.shape
    dev = lin.Hcc.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    Hpp_d = torch.where(lin.pt_on[:, None, None], _damped(lin.Hpp, lam), eye3)
    # factor the damped block itself (never chol(inv3x3(Hpp_d)): the
    # adjugate inverse of a thin-parallax block is not numerically SPD)
    L = _tri_inv_t(_chol3x3(Hpp_d))                      # (Q,3,3) upper
    We = lin.We
    A_e = (We[..., 0:1] * L[:, None, None, 0, :] +
           We[..., 1:2] * L[:, None, None, 1, :] +
           We[..., 2:3] * L[:, None, None, 2, :])        # (Q,O,6,3)
    # per camera: a batched product with each point's (O,C) one-hot
    onehot = edges.onehot.reshape(Q, O, C)
    Uq = torch.bmm(onehot.transpose(1, 2), A_e.reshape(Q, O, 18))     # (Q,C,18)
    U2 = Uq.reshape(Q, C, 6, 3).permute(1, 2, 0, 3).reshape(C * 6, Q * 3)
    S_corr = U2 @ U2.T

    rows, cols = _block_index(C, dev)
    Hcc_dense = torch.zeros((C * 6, C * 6), dtype=torch.float32, device=dev).index_put(
        (rows, cols), _damped(lin.Hcc, lam).reshape(-1))
    S = Hcc_dense - S_corr
    y = torch.einsum("qkl,qk->ql", L, lin.bp)             # L^T bp
    b_red = lin.bc.reshape(C * 6) - U2 @ y.reshape(Q * 3)

    # fixed and unused cameras: identity rows and columns, zero rhs
    free = prob.cam_valid & ~prob.cam_fixed
    free6 = free.repeat_interleave(6)
    eye = torch.eye(C * 6, dtype=torch.float32, device=dev)
    S = torch.where(free6[:, None] & free6[None, :], S, torch.zeros_like(S))
    S = S + torch.where(free6, 0.0, 1.0) * eye
    b_red = torch.where(free6, b_red, torch.zeros_like(b_red))
    # cholesky_ex: no host sync; a failed factor becomes NaN, as the
    # reference's, and the step is rejected
    chol, info = torch.linalg.cholesky_ex(S + 1e-8 * eye)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    dx_flat = torch.cholesky_solve(b_red[:, None], chol)[:, 0]
    dx_c = torch.where(free[:, None], dx_flat.reshape(C, 6), torch.zeros((), device=dev))

    z = (U2.T @ torch.where(free6, dx_flat, torch.zeros_like(dx_flat))).reshape(Q, 3)
    dx_p = torch.einsum("qil,ql->qi", L, y - z)
    dx_p = torch.where(lin.pt_on[:, None], dx_p, torch.zeros_like(dx_p))
    return dx_c, dx_p


def _lm_iterations(cam, prob: BAProblem, edges: _Edges, poses, points, edge_mask,
                   robust: bool, n_iters: int):
    """One edge pass per iteration: the assembly at the tentative state
    gives both the accept/reject error and, if accepted, the next step's
    linearization; a rejected step keeps the carried one and raises lambda.
    Returns (poses, points, lin), lin the linearization at the returned
    state."""
    lin = _assemble(cam, prob, edges, poses, points, edge_mask, robust)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=poses.device)
    for _ in range(n_iters):
        dx_c, dx_p = _solve_step(prob, edges, lin, lam)
        poses_new = se3.retract(poses, dx_c)
        points_new = points + dx_p
        lin_new = _assemble(cam, prob, edges, poses_new, points_new, edge_mask, robust)
        accept = lin_new.err < lin.err        # False for NaN: the step is rejected
        poses = torch.where(accept, poses_new, poses)
        points = torch.where(accept, points_new, points)
        lin = Lin(*(torch.where(accept, a, b) for a, b in zip(lin_new, lin)))
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9),
                          torch.clamp(lam * 5.0, max=1e4))
    return poses, points, lin


def solve_ba(cam, prob: BAProblem, level_sigma2, iters_a: int = 5, iters_b: int = 10,
             robust: bool = True) -> BAResult:
    """The reference's local-BA schedule (`src/Optimizer.cc:880-1010`):
    iters_a robust iterations, chi2 reclassification (5.991 / 7.815 and
    positive depth), iters_b more, and the final classification for the
    caller's observation erasure. No host sync."""
    C = prob.poses.shape[0]
    sigma2 = device_table(tuple(level_sigma2), prob.points.device)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(prob.obs_level, 0, sigma2.shape[0] - 1).long()]
    base_mask = (prob.obs_cam >= 0) & prob.pt_valid[:, None] & \
        prob.cam_valid[torch.clamp(prob.obs_cam, 0, C - 1).long()]
    stereo = prob.obs_uvr[..., 2] >= 0
    delta2 = torch.where(stereo, reproj.CHI2_STEREO, reproj.CHI2_MONO)
    edges = _edges(prob, inv_sigma2)

    poses, points, lin = _lm_iterations(cam, prob, edges, prob.poses, prob.points,
                                        base_mask.to(torch.float32), robust, iters_a)
    # reclassify from the carried linearization (chi2 at the current state)
    mask = base_mask & (lin.chi2 <= delta2) & lin.depth_ok
    poses, points, lin = _lm_iterations(cam, prob, edges, poses, points,
                                        mask.to(torch.float32), robust, iters_b)
    inlier = base_mask & (lin.chi2 <= delta2) & lin.depth_ok
    return BAResult(poses=poses, points=points, edge_inlier=inlier, chi2=lin.chi2)
