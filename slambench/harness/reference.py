"""The benchmark's plain reference: global bundle adjustment worked out
again from the harness's own arrays (`mapgen.MapArrays`), in plain PyTorch.

It imports nothing of the program and nothing of JAX. What it computes is
the global BA a loop closure runs (ORB-SLAM2's `RunGlobalBundleAdjustment`)
on the schedule the configuration runs it: `gba_async_chunks` chunks of
ceil(gba_total_iters / gba_async_chunks) Levenberg-Marquardt iterations,
each chunk starting again at lambda 1e-4 from the state the last one left.
Every keyframe and point of the map takes part; the keyframe of the
smallest frame id is held fixed. The robust kernel is off.

One LM iteration: residuals r = observation - projection (u, v and, for a
stereo observation, the right x u - bf/z), each weighted by
1/sigma^2 of its pyramid level; Jacobians by the chain rule through the
left perturbation exp(xi) T (xi = (rho, phi)) and the point; the normal
equations' blocks summed per camera and per point; each block damped by
lambda times its largest diagonal entry; a point block's Cholesky pivots
held at least 1e-5 of their diagonal entries. The camera step solves the
Schur complement S = Hcc - W Hpp^-1 W^T either exactly (`dense`: S formed
and factored) or by `cg_iters` iterations of conjugate gradients
preconditioned by S's camera blocks (`pcg`: S applied through the edges,
never formed); the points are back-substituted. A step is kept if the
total weighted squared error falls (lambda x 0.3, at least 1e-9), else
dropped (lambda x 5, at most 1e4).

Arithmetic (`Arith`): float64 for the reference; the control
(`Arith("tf32")`) is the same code in float32 with every matrix product's
operands rounded to TF32 (a 10-bit mantissa, to nearest even), as a TF32
tensor core reads them, accumulating in float32. The products are the
linear algebra: the Jacobians' chain rule, the normal equations' blocks,
the Schur complement and its solves, and the retraction; the residuals
(the projection of each point) are elementwise, so the control's error is
that of a solver run in TF32, not of residuals read wrong.
"""
from __future__ import annotations

import dataclasses
import math

import torch

CHI2_MONO = 5.991       # chi2(2) at 95 %
CHI2_STEREO = 7.815     # chi2(3) at 95 %
LAMBDA0 = 1e-4
PIVOT_FLOOR = 1e-5


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), kept in float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class Arith:
    """The precision the reference runs in: "float64", "float32", or
    "tf32" (float32, matrix-product operands rounded to TF32)."""

    def __init__(self, mode: str = "float64"):
        if mode not in ("float64", "float32", "tf32"):
            raise ValueError(mode)
        self.mode = mode
        self.dtype = torch.float64 if mode == "float64" else torch.float32

    def mm(self, a, b):
        if self.mode == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)

    def mv(self, A, x):
        """Batched matrix-vector product A (...,m,n) x (...,n)."""
        return self.mm(A, x[..., None])[..., 0]


@dataclasses.dataclass
class Problem:
    """A global BA's data: C camera slots, Q point slots, E observations."""
    R: torch.Tensor          # (C,3,3) world-to-camera rotations
    t: torch.Tensor          # (C,3)
    cam_free: torch.Tensor   # (C,) bool: valid and not the fixed keyframe
    X: torch.Tensor          # (Q,3)
    pt_valid: torch.Tensor   # (Q,) bool
    e_cam: torch.Tensor      # (E,) int64
    e_pt: torch.Tensor       # (E,) int64
    e_obs: torch.Tensor      # (E,3) u, v, uR
    e_stereo: torch.Tensor   # (E,) bool
    e_w: torch.Tensor        # (E,) 1/sigma^2
    cam: tuple               # (fx, fy, cx, cy, bf)
    solver: str              # "dense" or "pcg"
    cg_iters: int
    chunks: int
    iters: int


def problem(arr, cfg: dict, arith: Arith) -> Problem:
    """The global BA of the harness's map `arr` under configuration `cfg`,
    in `arith`'s precision."""
    slam, solve = cfg["slam"], cfg["global_ba"]
    dt = arith.dtype
    fid = torch.where(arr.kf_valid, arr.frame_id.long(), torch.full_like(arr.frame_id.long(),
                                                                         1 << 40))
    free = arr.kf_valid.clone()
    free[torch.argmin(fid)] = False
    Q, O = arr.obs_kf.shape
    on = (arr.obs_kf >= 0) & arr.pt_valid[:, None] & arr.kf_valid[arr.obs_kf.clamp(min=0)]
    e_pt, e_cam = torch.arange(Q, device=on.device)[:, None].expand(Q, O)[on], arr.obs_kf[on]
    ur = arr.obs_ur[on]
    sf = torch.tensor([slam["scale_factor"]], dtype=torch.float64, device=on.device)
    w = sf ** (-2.0 * arr.obs_level[on].to(torch.float64))
    chunks = slam["gba_async_chunks"]
    return Problem(
        R=arr.Tcw[:, :3, :3].to(dt), t=arr.Tcw[:, :3, 3].to(dt), cam_free=free,
        X=arr.points.to(dt), pt_valid=arr.pt_valid, e_cam=e_cam, e_pt=e_pt,
        e_obs=torch.cat([arr.obs_uv[on], ur[:, None]], dim=1).to(dt), e_stereo=ur >= 0,
        e_w=w.to(dt), cam=(slam["fx"], slam["fy"], slam["cx"], slam["cy"], slam["bf"]),
        solver=solve["solver"], cg_iters=int(solve.get("cg_iters", 0)), chunks=chunks,
        iters=max(1, -(-slam["gba_total_iters"] // chunks)))


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def retract(ar: Arith, R, t, xi):
    """exp(xi) T for xi = (rho, phi): R' = exp(phi) R, t' = exp(phi) t + V rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = (phi * phi).sum(-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    one = torch.ones_like(th2)
    A = torch.where(small, 1 - th2 / 6, torch.sin(th) / torch.where(small, one, th))
    B = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / torch.where(small, one, th2))
    Cc = torch.where(small, 1.0 / 6 - th2 / 120,
                     (th - torch.sin(th)) / torch.where(small, one, th2 * th))
    Wm = skew(phi)
    W2 = ar.mm(Wm, Wm)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    E = eye + A[:, None, None] * Wm + B[:, None, None] * W2
    V = eye + B[:, None, None] * Wm + Cc[:, None, None] * W2
    return ar.mm(E, R), ar.mv(E, t) + ar.mv(V, rho)


@dataclasses.dataclass
class Lin:
    Hcc: torch.Tensor    # (C,6,6)
    bc: torch.Tensor     # (C,6)
    Hpp: torch.Tensor    # (Q,3,3)
    bp: torch.Tensor     # (Q,3)
    We: torch.Tensor     # (E,6,3)
    pt_on: torch.Tensor  # (Q,) bool
    err: float


def residuals(pb: Problem, ar: Arith, R, t, X):
    """Per observation: camera-frame point (E,3), residual (E,3) (the
    right x zero for a mono observation), chi2 (E,) and depth_ok (E,)."""
    fx, fy, cx, cy, bf = pb.cam
    pc = (R[pb.e_cam] * X[pb.e_pt][:, None, :]).sum(-1) + t[pb.e_cam]
    x, y, z = pc.unbind(-1)
    iz = 1.0 / z.clamp(min=1e-9)
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    r = pb.e_obs - torch.stack([u, v, u - bf * iz], -1)
    r = torch.cat([r[:, :2], torch.where(pb.e_stereo, r[:, 2], 0.0)[:, None]], 1)
    chi2 = pb.e_w * (r * r).sum(-1)
    return pc, r, chi2, z > 1e-6


def linearize(pb: Problem, ar: Arith, R, t, X) -> Lin:
    fx, fy, _, _, bf = pb.cam
    pc, r, chi2, front = residuals(pb, ar, R, t, X)
    x, y, z = pc.unbind(-1)
    iz = torch.where(front, 1.0 / z.clamp(min=1e-9), 0.0)
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    dproj = torch.stack([torch.stack([fx * iz, zero, -fx * x * iz2], -1),
                         torch.stack([zero, fy * iz, -fy * y * iz2], -1),
                         torch.stack([fx * iz, zero, -(fx * x - bf) * iz2], -1)], -2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    Jc = -ar.mm(dproj, torch.cat([eye, -skew(pc)], -1))        # (E,3,6) d r / d xi
    Jp = -ar.mm(dproj, R[pb.e_cam])                            # (E,3,3) d r / d X
    w = pb.e_w * front
    om = torch.stack([w, w, w * pb.e_stereo], -1)[..., None]   # (E,3,1)
    JcT, JpT = Jc.transpose(1, 2), Jp.transpose(1, 2)
    C, Q = R.shape[0], X.shape[0]
    Hcc = torch.zeros((C, 6, 6), dtype=pc.dtype, device=pc.device).index_add_(
        0, pb.e_cam, ar.mm(JcT, om * Jc))
    bc = torch.zeros((C, 6), dtype=pc.dtype, device=pc.device).index_add_(
        0, pb.e_cam, -ar.mv(JcT, om[..., 0] * r))
    Hpp = torch.zeros((Q, 3, 3), dtype=pc.dtype, device=pc.device).index_add_(
        0, pb.e_pt, ar.mm(JpT, om * Jp))
    bp = torch.zeros((Q, 3), dtype=pc.dtype, device=pc.device).index_add_(
        0, pb.e_pt, -ar.mv(JpT, om[..., 0] * r))
    seen = torch.zeros((Q,), dtype=torch.bool, device=pc.device)
    seen[pb.e_pt] = True
    return Lin(Hcc, bc, Hpp, bp, ar.mm(JcT, om * Jp), pb.pt_valid & seen,
               float(chi2.sum()))


def damped(H, lam: float):
    scale = torch.diagonal(H, dim1=-2, dim2=-1).max(dim=-1).values.clamp(min=1e-6)
    return H + lam * scale[:, None, None] * torch.eye(H.shape[-1], dtype=H.dtype,
                                                      device=H.device)


def chol_floor(H):
    """Lower Cholesky factors of (Q,3,3) blocks, each pivot at least
    PIVOT_FLOOR times its diagonal entry."""
    L = torch.zeros_like(H)
    for j in range(3):
        piv = H[:, j, j] - (L[:, j, :j] ** 2).sum(-1)
        lo = (PIVOT_FLOOR * H[:, j, j]).clamp(min=1e-20) if j else \
            torch.full_like(piv, 1e-20)
        L[:, j, j] = torch.sqrt(torch.maximum(piv, lo))
        for i in range(j + 1, 3):
            L[:, i, j] = (H[:, i, j] - (L[:, i, :j] * L[:, j, :j]).sum(-1)) / L[:, j, j]
    return L


def _point_inverse(ar: Arith, lin: Lin, lam: float):
    """(L^-1 (Q,3,3), Hpp_d^-1 = L^-T L^-1) of the damped point blocks."""
    eye = torch.eye(3, dtype=lin.Hpp.dtype, device=lin.Hpp.device)
    Hd = torch.where(lin.pt_on[:, None, None], damped(lin.Hpp, lam), eye)
    Li = torch.linalg.solve_triangular(chol_floor(Hd), eye.expand_as(Hd), upper=False)
    return Li, ar.mm(Li.transpose(1, 2), Li)


def _back_substitute(pb, ar, lin, Hinv, dx_c):
    v = torch.zeros_like(lin.bp).index_add_(
        0, pb.e_pt, ar.mv(lin.We.transpose(1, 2), dx_c[pb.e_cam]))
    dx_p = ar.mv(Hinv, lin.bp - v)
    return torch.where(lin.pt_on[:, None], dx_p, torch.zeros_like(dx_p))


def solve_dense(pb: Problem, ar: Arith, lin: Lin, lam: float):
    """The camera step from S formed and factored, the points
    back-substituted. None if S is not positive definite."""
    C, Q = lin.Hcc.shape[0], lin.Hpp.shape[0]
    dev, dt = lin.Hcc.device, lin.Hcc.dtype
    Li, Hinv = _point_inverse(ar, lin, lam)
    A = ar.mm(lin.We, Li[pb.e_pt].transpose(1, 2))                 # (E,6,3): W_e L^-T
    U = torch.zeros((C, 6, Q, 3), dtype=dt, device=dev)
    U[pb.e_cam, :, pb.e_pt, :] = A
    U = U.reshape(C * 6, Q * 3)
    S = -ar.mm(U, U.T)
    blocks = damped(lin.Hcc, lam)
    idx = torch.arange(C, device=dev)
    S.view(C, 6, C, 6)[idx, :, idx, :] += blocks
    y = ar.mv(Li, lin.bp).reshape(Q * 3)
    b = lin.bc.reshape(C * 6) - ar.mv(U, y)
    free6 = pb.cam_free.repeat_interleave(6)
    keep = free6[:, None] & free6[None, :]
    eye = torch.eye(C * 6, dtype=dt, device=dev)
    S = torch.where(keep, S, torch.zeros_like(S)) + torch.where(free6, 0.0, 1.0) * eye
    b = torch.where(free6, b, torch.zeros_like(b))
    chol, info = torch.linalg.cholesky_ex(S + 1e-8 * eye)
    if int(info) != 0:
        return None
    dx = torch.cholesky_solve(b[:, None], chol)[:, 0]
    dx_c = torch.where(pb.cam_free[:, None], dx.reshape(C, 6), torch.zeros((), dtype=dt,
                                                                            device=dev))
    return dx_c, _back_substitute(pb, ar, lin, Hinv, dx_c)


def solve_pcg(pb: Problem, ar: Arith, lin: Lin, lam: float):
    """The camera step by `cg_iters` iterations of block-Jacobi
    preconditioned CG on S applied through the observations, the points
    back-substituted."""
    C = lin.Hcc.shape[0]
    dev, dt = lin.Hcc.device, lin.Hcc.dtype
    free = pb.cam_free[:, None]
    _, Hinv = _point_inverse(ar, lin, lam)
    Hcc_d = damped(lin.Hcc, lam)
    We, WeT = lin.We, lin.We.transpose(1, 2)

    def to_cameras(u):                # sum over a camera's observations of W_e u[point]
        return torch.zeros((C, 6), dtype=dt, device=dev).index_add_(0, pb.e_cam,
                                                                    ar.mv(We, u[pb.e_pt]))

    def S_apply(p):
        q = torch.where(free, p, torch.zeros_like(p))
        v = torch.zeros_like(lin.bp).index_add_(0, pb.e_pt, ar.mv(WeT, q[pb.e_cam]))
        y = ar.mv(Hcc_d, q) - to_cameras(ar.mv(Hinv, v))
        return torch.where(free, y, torch.zeros_like(y))

    b = lin.bc - to_cameras(ar.mv(Hinv, lin.bp))
    b = torch.where(free, b, torch.zeros_like(b))
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Minv = torch.linalg.inv(torch.where(free[:, :, None], Hcc_d, eye6) + 1e-8 * eye6)
    x = torch.zeros_like(b)
    r = b
    z = ar.mv(Minv, r)
    p = z
    rz = (r * z).sum()
    for _ in range(pb.cg_iters):
        Ap = S_apply(p)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(pAp.abs() < 1e-20, torch.full_like(pAp, 1e-20), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = ar.mv(Minv, r)
        rz_new = (r * z).sum()
        beta = rz_new / torch.where(rz.abs() < 1e-20, torch.full_like(rz, 1e-20), rz)
        p = z + beta * p
        rz = rz_new
    return x, _back_substitute(pb, ar, lin, Hinv, x)


SOLVERS = {"dense": solve_dense, "pcg": solve_pcg}


def levenberg_marquardt(pb: Problem, ar: Arith, R, t, X, iters: int, log=None):
    """`iters` LM iterations from (R, t, X); each step's (error before,
    error after, kept) appended to `log` if one is given."""
    lin = linearize(pb, ar, R, t, X)
    lam = LAMBDA0
    solve = SOLVERS[pb.solver]
    for _ in range(iters):
        step = solve(pb, ar, lin, lam)
        new = None
        if step is not None:
            R2, t2 = retract(ar, R, t, step[0])
            X2 = X + step[1]
            lin2 = linearize(pb, ar, R2, t2, X2)
            if lin2.err < lin.err:         # False for NaN: the step is dropped
                new = (R2, t2, X2, lin2)
            if log is not None:
                log.append((lin.err, lin2.err, new is not None))
        if new is None:
            lam = min(lam * 5.0, 1e4)
        else:
            R, t, X, lin = new
            lam = max(lam * 0.3, 1e-9)
    return R, t, X


def global_ba(pb: Problem, ar: Arith, log=None):
    """The configuration's global BA: (R (C,3,3), t (C,3), X (Q,3)) at the
    end of its last chunk (each LM step logged to `log`, if given)."""
    R, t, X = pb.R, pb.t, pb.X
    for _ in range(pb.chunks):
        R, t, X = levenberg_marquardt(pb, ar, R, t, X, pb.iters, log)
    return R, t, X


def evaluate(pb: Problem, R, t, X):
    """A state judged in float64: projections (E,2), chi2 (E,), inlier (E,)
    (chi2 within 5.991 mono / 7.815 stereo, in front), the total chi2, and
    the camera centres (C,3)."""
    ar = Arith("float64")
    R, t, X = R.double(), t.double(), X.double()
    pb64 = dataclasses.replace(pb, e_obs=pb.e_obs.double(), e_w=pb.e_w.double())
    pc, r, chi2, front = residuals(pb64, ar, R, t, X)
    proj = pb64.e_obs[:, :2] - r[:, :2]
    thr = torch.where(pb.e_stereo, CHI2_STEREO, CHI2_MONO)
    centres = -(R.transpose(1, 2) @ t[..., None])[..., 0]
    return dict(proj=proj, chi2=chi2, inlier=(chi2 <= thr) & front, total=float(chi2.sum()),
                centres=centres, R=R)


def rotation_angle(Ra, Rb):
    """(C,) angle of Ra Rb^T in radians (atan2 of its sine and cosine, so
    small angles keep their digits)."""
    M = Ra @ Rb.transpose(1, 2)
    s = torch.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                     M[:, 1, 0] - M[:, 0, 1]], -1).norm(dim=-1) / 2.0
    c = (M.diagonal(dim1=1, dim2=2).sum(-1) - 1.0) / 2.0
    return torch.atan2(s, c)


def gaps(pb: Problem, a: dict, b: dict) -> dict:
    """How far state a lies from state b (both from `evaluate`): the
    widest reprojection gap over the observations (px), the relative gap of
    the total chi2, the observations classified differently, and the widest
    camera-centre (m) and rotation (rad) gaps over the free keyframes."""
    free = pb.cam_free
    return {
        "reproj_gap_px": float(torch.linalg.norm(a["proj"] - b["proj"], dim=1).max()),
        "chi2_gap": abs(a["total"] - b["total"]) / max(b["total"], 1e-300),
        "inlier_flips": int((a["inlier"] != b["inlier"]).sum()),
        "pose_gap_m": float(torch.linalg.norm(a["centres"] - b["centres"], dim=1)[free].max()),
        "rot_gap_rad": float(rotation_angle(a["R"], b["R"])[free].max()),
    }


def nan_to_inf(d: dict) -> dict:
    return {k: (math.inf if isinstance(v, float) and math.isnan(v) else v) for k, v in d.items()}
