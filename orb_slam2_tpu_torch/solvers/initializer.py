"""Monocular two-view bootstrap: batched H / F RANSAC and reconstruction
(port of `orb_slam2_tpu/solvers/initializer.py`).

`Initializer` (`src/Initializer.cc`): the reference runs FindHomography and
FindFundamental in two threads over 200 shared RANSAC sets (`:189-205`);
here all 200 hypotheses of both models are solved and scored in one batch
(8-point solves by SVD, symmetric-transfer and epipolar scoring), then the
RH = SH / (SH + SF) > 0.40 rule (`:207-227`) picks the model, and the
reconstruction scores every candidate (R, t) at once: 4 from the essential
matrix, 8 from the Faugeras homography decomposition (`CheckRT`,
`:1452-1719`).

Everything is fixed-shape: matches are padded with a validity mask. The
RANSAC sets index the valid matches and come from a CPU
`torch.Generator` (both devices draw the same) or are handed in as
`draws`. Host syncs: the valid count (the draws' range) and, on a CUDA
device, the batched SVDs, which wait for their solver's status; this runs
only while the map is not initialized.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.triangulation import triangulate

RANSAC_ITERS = 200
SIGMA = 1.0
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50


class InitResult(NamedTuple):
    success: torch.Tensor          # () bool
    R21: torch.Tensor              # (3,3)
    t21: torch.Tensor              # (3,) unit translation
    points: torch.Tensor           # (N,3) triangulated in frame-1 coordinates
    good: torch.Tensor             # (N,) bool triangulation validity
    used_homography: torch.Tensor  # () bool


def _normalize(pts, valid):
    """`Normalize` (`src/Initializer.cc:1378-1449`): subtract the mean and
    scale each axis by its mean absolute deviation. Returns (pts_n, T)."""
    n = torch.clamp(valid.sum(dtype=torch.int32), min=1)
    mean = torch.where(valid[:, None], pts, 0.0).sum(dim=0) / n
    mean_dev = torch.where(valid[:, None], torch.abs(pts - mean), 0.0).sum(dim=0) / n
    s = 1.0 / torch.clamp(mean_dev, min=1e-12)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (pts - mean) * s, T


def _null_vector(A):
    """The right singular vector of A's least singular value, as 3x3."""
    return torch.linalg.svd(A, full_matrices=True)[2][..., 8, :].reshape(A.shape[:-2] + (3, 3))


def _solve_h(p1, p2):
    """8-point DLT homographies H21 (p2 ~ H21 p1); p1, p2 (..., 8, 2)
    normalized."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    return _null_vector(torch.cat([r1, r2], dim=-2))             # A (..., 16, 9)


def _solve_f(p1, p2):
    """8-point fundamental matrices with the rank-2 projection, F21:
    p2^T F p1 = 0."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x)
    F = _null_vector(torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], dim=-1))
    U, S, Vt = torch.linalg.svd(F)
    S = S * torch.tensor([1.0, 1.0, 0.0], dtype=S.dtype, device=S.device)
    return U @ torch.diag_embed(S) @ Vt


def _score_h(H21, p1, p2, valid):
    """Symmetric-transfer chi2 scoring (`CheckHomography`,
    `src/Initializer.cc:897-1024`) of homographies (..., 3, 3). Returns
    (score (...), inliers (..., N))."""
    H12 = torch.linalg.inv_ex(H21).inverse
    inv_s2 = 1.0 / (SIGMA * SIGMA)

    def transfer(H, a, b):
        h = H[..., None, :, :]
        w = h[..., 2, 0] * a[:, 0] + h[..., 2, 1] * a[:, 1] + h[..., 2, 2]
        w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
        u = (h[..., 0, 0] * a[:, 0] + h[..., 0, 1] * a[:, 1] + h[..., 0, 2]) / w
        v = (h[..., 1, 0] * a[:, 0] + h[..., 1, 1] * a[:, 1] + h[..., 1, 2]) / w
        return ((b[:, 0] - u) ** 2 + (b[:, 1] - v) ** 2) * inv_s2

    chi2_1 = transfer(H12, p2, p1)
    chi2_2 = transfer(H21, p1, p2)
    ok = (chi2_1 <= CHI2_H) & (chi2_2 <= CHI2_H) & valid
    score = torch.where((chi2_1 <= CHI2_H) & valid, CHI2_H - chi2_1, 0.0).sum(dim=-1) + \
        torch.where((chi2_2 <= CHI2_H) & valid, CHI2_H - chi2_2, 0.0).sum(dim=-1)
    return score, ok


def _score_f(F21, p1, p2, valid):
    """Epipolar-distance chi2 scoring (`CheckFundamental`,
    `src/Initializer.cc:1024-1066`): 3.841 per direction, the score adds
    5.991 - chi2."""
    inv_s2 = 1.0 / (SIGMA * SIGMA)

    def epi_chi2(F, a, b):
        f = F[..., None, :, :]
        la = f[..., 0, 0] * a[:, 0] + f[..., 0, 1] * a[:, 1] + f[..., 0, 2]
        lb = f[..., 1, 0] * a[:, 0] + f[..., 1, 1] * a[:, 1] + f[..., 1, 2]
        lc = f[..., 2, 0] * a[:, 0] + f[..., 2, 1] * a[:, 1] + f[..., 2, 2]
        num = la * b[:, 0] + lb * b[:, 1] + lc
        den = la * la + lb * lb
        den = torch.where(den < 1e-12, 1e-12, den)
        return num * num / den * inv_s2

    chi2_1 = epi_chi2(F21, p1, p2)                       # line in image 2
    chi2_2 = epi_chi2(F21.transpose(-1, -2), p2, p1)
    ok = (chi2_1 <= CHI2_F) & (chi2_2 <= CHI2_F) & valid
    score = torch.where((chi2_1 <= CHI2_F) & valid, SCORE_TH - chi2_1, 0.0).sum(dim=-1) + \
        torch.where((chi2_2 <= CHI2_F) & valid, SCORE_TH - chi2_2, 0.0).sum(dim=-1)
    return score, ok


def _intrinsics(K, dev):
    fx, fy, cx, cy = K
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], device=dev)


def _check_rt(R, t, p1, p2, valid, K, th2: float = 4.0):
    """Cheirality, parallax and reprojection of candidates (C,3,3), (C,3)
    (`CheckRT`, `src/Initializer.cc:1452-1650`); p1, p2 pixel coordinates,
    valid (C,N). Returns (n_good (C,), parallax_deg (C,), X (C,N,3) in
    camera 1, good (C,N))."""
    fx, fy, cx, cy = K
    Km = _intrinsics(K, p1.device)
    P1 = torch.cat([Km, torch.zeros_like(Km[:, :1])], dim=1)
    P2 = Km @ torch.cat([R, t[..., None]], dim=-1)                  # (C,3,4)
    X = triangulate(P1, P2[:, None], p1, p2)                         # (C,N,3)
    finite = torch.isfinite(X).all(dim=-1)

    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]              # (C,3)
    n2 = X - O2[:, None]
    d1 = torch.linalg.vector_norm(X, dim=-1)
    d2 = torch.linalg.vector_norm(n2, dim=-1)
    cos_par = (X * n2).sum(dim=-1) / torch.clamp(d1 * d2, min=1e-12)

    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[:, None]
    z2 = Xc2[..., 2]
    # the reference enforces positive depth only where parallax is measurable
    depth_ok = ((z1 > 0) & (z2 > 0)) | (cos_par >= 0.99998)

    def err(Xc, z, p):
        zs = torch.where(z == 0, 1e-9, z)
        u = fx * Xc[..., 0] / zs + cx
        v = fy * Xc[..., 1] / zs + cy
        return (u - p[:, 0]) ** 2 + (v - p[:, 1]) ** 2

    good = valid & finite & depth_ok & (err(X, z1, p1) < th2) & (err(Xc2, z2, p2) < th2) & \
        (z1 > 0) & (z2 > 0) & (cos_par < 0.99998)
    n_good = good.sum(dim=-1, dtype=torch.int32)
    # parallax: the 50th smallest cosParallax among the good (or the largest)
    cp = torch.sort(torch.where(good, cos_par, 1.0), dim=-1).values
    idx = torch.clamp(n_good - 1, min=0, max=49).long()
    parallax = torch.rad2deg(torch.arccos(torch.clamp(
        torch.gather(cp, 1, idx[:, None])[:, 0], -1.0, 1.0)))
    return n_good, torch.where(n_good > 0, parallax, 0.0), X, good


def _essential_candidates(F21, Km):
    """The 4 (R, t) of E = K^T F K (`ReconstructF`, `src/Initializer.cc:250-350`)."""
    U, _, Vt = torch.linalg.svd(Km.T @ F21 @ Km)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1.0]], device=F21.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tE = U[:, 2] / torch.clamp(torch.linalg.vector_norm(U[:, 2]), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([tE, -tE, tE, -tE])


def _homography_candidates(H21, Km):
    """The 8 (R, t) of the Faugeras decomposition of A = K^-1 H K
    (`ReconstructH`, `src/Initializer.cc:354-560`)."""
    A = torch.linalg.inv(Km) @ H21 @ Km
    Ua, Sa, Vta = torch.linalg.svd(A)
    s_det = torch.linalg.det(Ua) * torch.linalg.det(Vta)
    d1, d2, d3 = Sa[0], Sa[1], Sa[2]
    eps = 1e-8
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / torch.clamp(d1 * d1 - d3 * d3, min=eps),
                                  min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / torch.clamp(d1 * d1 - d3 * d3, min=eps),
                                  min=0.0))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    aux_st = root / torch.clamp((d1 + d3) * d2, min=eps)
    aux_st_n = root / torch.clamp((d1 - d3) * d2, min=eps)
    ctheta = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=eps)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rs, ts = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1, x3 = e1 * aux1, e3 * aux3
            # d' = +d2
            st = e1 * e3 * aux_st
            Rp = mat([[ctheta, zero, -st], [zero, one, zero], [st, zero, ctheta]])
            Rs.append(s_det * Ua @ Rp @ Vta)
            ts.append(Ua @ (torch.stack([x1, zero, -x3]) * (d1 - d3)))
            # d' = -d2
            sphi = e1 * e3 * aux_st_n
            Rn = mat([[cphi, zero, sphi], [zero, -one, zero], [sphi, zero, -cphi]])
            Rs.append(s_det * Ua @ Rn @ Vta)
            ts.append(Ua @ (torch.stack([x1, zero, x3]) * (d1 + d3)))
    t = torch.stack(ts)
    return torch.stack(Rs), t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                                            min=1e-12)


def initialize(p1, p2, valid, fx: float, fy: float, cx: float, cy: float,
               generator: torch.Generator = None, draws=None) -> InitResult:
    """p1, p2 (N,2): matched undistorted pixel coordinates (reference frame,
    current frame); valid (N,). The (200, 8) RANSAC sets index the valid
    matches: from `generator` (a CPU `torch.Generator`, seed 0 when None) or
    handed in as `draws` (an int tensor)."""
    dev = p1.device
    n_valid = int(valid.sum())                     # the draws' range: one host read
    packed = torch.argsort((~valid).to(torch.uint8), stable=True)
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = torch.randint(0, max(n_valid, 1), (RANSAC_ITERS, 8), generator=generator)
    sets = packed[torch.as_tensor(draws, device=dev).long()]

    p1n, T1 = _normalize(p1, valid)
    p2n, T2 = _normalize(p2, valid)
    H_all = torch.linalg.inv(T2) @ _solve_h(p1n[sets], p2n[sets]) @ T1
    F_all = T2.T @ _solve_f(p1n[sets], p2n[sets]) @ T1
    sh_all, _ = _score_h(H_all, p1, p2, valid)
    sf_all, _ = _score_f(F_all, p1, p2, valid)
    bi_h, bi_f = torch.argmax(sh_all), torch.argmax(sf_all)      # the first maximum
    SH, SF = sh_all[bi_h], sf_all[bi_f]
    H21, F21 = H_all[bi_h], F_all[bi_f]
    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40
    _, inl_h = _score_h(H21, p1, p2, valid)
    _, inl_f = _score_f(F21, p1, p2, valid)

    K = (fx, fy, cx, cy)
    Km = _intrinsics(K, dev)
    Rsf, tsf = _essential_candidates(F21, Km)
    Rsh, tsh = _homography_candidates(H21, Km)
    ngf, parf, Xf, goodf = _check_rt(Rsf, tsf, p1, p2, inl_f.expand(4, -1), K)
    ngh, parh, Xh, goodh = _check_rt(Rsh, tsh, p1, p2, inl_h.expand(8, -1), K)
    n_inl_f = inl_f.sum(dtype=torch.int32)
    n_inl_h = inl_h.sum(dtype=torch.int32)

    # F acceptance (src/Initializer.cc:587-735)
    bf = torch.argmax(ngf)
    max_f = ngf[bf]
    n_similar_f = (ngf > 0.7 * max_f).sum(dtype=torch.int32)
    min_good_f = torch.clamp((0.9 * n_inl_f).to(torch.int32), min=MIN_TRIANGULATED)
    ok_f = (max_f >= min_good_f) & (n_similar_f == 1) & (parf[bf] > MIN_PARALLAX_DEG)
    # H acceptance (src/Initializer.cc:520-560)
    bh = torch.argmax(ngh)
    max_h = ngh[bh]
    second_h = torch.sort(ngh).values[-2]
    ok_h = (second_h < 0.75 * max_h) & (parh[bh] >= MIN_PARALLAX_DEG) & \
        (max_h > MIN_TRIANGULATED) & (max_h > 0.9 * n_inl_h)

    return InitResult(success=torch.where(use_h, ok_h, ok_f),
                      R21=torch.where(use_h, Rsh[bh], Rsf[bf]),
                      t21=torch.where(use_h, tsh[bh], tsf[bf]),
                      points=torch.where(use_h, Xh[bh], Xf[bf]),
                      good=torch.where(use_h, goodh[bh], goodf[bf]),
                      used_homography=use_h)
