"""Depth association for a frame (port of `orb_slam2_tpu/ops/stereo.py`):
the row-banded stereo matcher with SAD sub-pixel refinement, and RGB-D
pseudo-stereo.

`Frame::ComputeStereoMatches` (`src/Frame.cc:831-1128`):
1. coarse: masked Hamming argmin of each left keypoint over the right ones
   in a row band |vR - vL| <= 2 * scale(levelR), octaves +-1 and the
   disparity window [uL - maxD, uL]; best < (TH_HIGH + TH_LOW) / 2;
2. fine: the 11x11 centre-normalised SAD slid +-5 px on the keypoint's
   pyramid level, with a parabola fit for the sub-pixel offset;
3. cull: SAD > 1.5 * 1.4 * median rejected.

The reference slices every level's patches with a vmapped dynamic slice and
keeps each keypoint's own level; here one gather over a flat buffer of all
levels takes each keypoint's patches at its level's (height, width,
offset). Everything stays on the device: no value is read back.
"""
from __future__ import annotations


import numpy as np
import torch

from ..utils.config import device_cache, device_table, reciprocal_f32
from .matching import BIG, TH_HIGH, TH_LOW, hamming_matrix

SAD_W = 5   # window radius -> 11x11 patch
SAD_L = 5   # slide range +-5


@device_cache()
def _level_geometry(sizes: tuple, device):
    """(n_levels, 3) int64 on `device`: each level's height, width and
    offset in the flat buffer of all levels, made once per device."""
    offsets = np.cumsum([0] + [h * w for h, w in sizes[:-1]])
    return torch.tensor([[h, w, int(o)] for (h, w), o in zip(sizes, offsets)],
                        dtype=torch.int64, device=device)


def compute_stereo_matches(kpL_xy, kpL_level, kpL_desc, kpL_valid,
                           kpR_xy, kpR_level, kpR_desc, kpR_valid,
                           pyr_left, pyr_right, scale_factors, bf: float,
                           max_disparity: float):
    """Left keypoints (N,) against right keypoints (M,) of a rectified pair;
    pyr_left / pyr_right the two images' pyramids (lists of (h, w) float32
    levels, as the extraction built them). Returns (u_right, depth), each
    (N,) float32, -1 where unmatched. max_disparity: the reference's maxD =
    mbf / minZ with minZ = baseline, i.e. fx (`src/Frame.cc:900-906`)."""
    dev = kpL_xy.device
    n = kpL_xy.shape[0]
    n_levels = len(scale_factors)
    sf = device_table(tuple(scale_factors), dev)
    # the reference divides by a constant table: XLA folds it to float32
    # reciprocals
    inv_sf = device_table(tuple(reciprocal_f32(s) for s in scale_factors), dev)
    uL, vL = kpL_xy[:, 0], kpL_xy[:, 1]
    uR, vR = kpR_xy[:, 0], kpR_xy[:, 1]

    # --- coarse match ---
    band = 2.0 * sf[torch.clamp(kpR_level, 0, n_levels - 1).long()]
    row_ok = torch.abs(vL[:, None] - vR[None, :]) <= band[None, :]
    lvl_ok = (kpR_level[None, :] >= kpL_level[:, None] - 1) & \
        (kpR_level[None, :] <= kpL_level[:, None] + 1)
    disp_ok = (uR[None, :] >= uL[:, None] - max_disparity) & (uR[None, :] <= uL[:, None])
    cand = row_ok & lvl_ok & disp_ok & kpL_valid[:, None] & kpR_valid[None, :]
    dist = torch.where(cand, hamming_matrix(kpL_desc, kpR_desc), BIG)
    best, best_idx = torch.min(dist, dim=1)       # the lowest index wins a tie
    coarse_ok = (best < (TH_HIGH + TH_LOW) // 2) & kpL_valid

    # --- fine SAD refinement on each keypoint's pyramid level ---
    level = torch.clamp(kpL_level, 0, n_levels - 1).long()
    isf = inv_sf[level]
    su_l = torch.round(uL * isf).long()
    sv_l = torch.round(vL * isf).long()
    su_r = torch.round(uR[best_idx] * isf).long()
    sizes = tuple(tuple(lv.shape) for lv in pyr_left)
    h, w, base = _level_geometry(sizes, dev)[level].unbind(-1)
    size = 2 * SAD_W + 1
    strip_w = size + 2 * SAD_L
    in_bounds = (sv_l >= SAD_W) & (sv_l < h - SAD_W) & (su_l >= SAD_W) & (su_l < w - SAD_W) & \
        (su_r - SAD_L - SAD_W >= 0) & (su_r + SAD_L + SAD_W + 1 < w)
    sel = coarse_ok & in_bounds
    yc = torch.minimum(torch.clamp(sv_l - SAD_W, min=0), h - size)
    xl = torch.minimum(torch.clamp(su_l - SAD_W, min=0), w - size)
    xr = torch.minimum(torch.clamp(su_r - SAD_W - SAD_L, min=0), w - strip_w)

    flat_l = torch.cat([lv.reshape(-1) for lv in pyr_left])
    flat_r = torch.cat([lv.reshape(-1) for lv in pyr_right])
    ar = torch.arange(strip_w, device=dev)
    row0 = base[:, None, None] + (yc[:, None, None] + ar[None, :size, None]) * w[:, None, None]
    patch_l = flat_l[row0 + xl[:, None, None] + ar[None, None, :size]]       # (N,11,11)
    strip_r = flat_r[row0 + xr[:, None, None] + ar[None, None, :]]           # (N,11,21)
    patch_l = patch_l - patch_l[:, SAD_W, SAD_W, None, None]
    pr = strip_r.unfold(2, size, 1).permute(0, 2, 1, 3)                     # (N,11 incs,11,11)
    pr = pr - pr[:, :, SAD_W, SAD_W, None, None]
    sads = torch.abs(patch_l[:, None] - pr).sum(dim=(2, 3))                  # (N, 11)

    bd, bi = torch.min(sads, dim=1)
    interior = (bi > 0) & (bi < 2 * SAD_L)
    i0 = torch.clamp(bi, 1, 2 * SAD_L - 1)[:, None]
    d1 = torch.gather(sads, 1, i0 - 1)[:, 0]
    d2 = torch.gather(sads, 1, i0)[:, 0]
    d3 = torch.gather(sads, 1, i0 + 1)[:, 0]
    denom = d1 + d3 - 2.0 * d2
    dr = torch.where(torch.abs(denom) > 1e-9, (d1 - d3) / (2.0 * denom), 2.0)
    ok = sel & interior & (dr >= -1.0) & (dr <= 1.0)
    best_inc = torch.where(ok, bi - SAD_L, 0)
    delta_r = torch.where(ok, dr, 0.0)
    sad_best = torch.where(ok, bd, float("inf"))

    best_u_r = sf[level] * (su_r.to(torch.float32) + best_inc.to(torch.float32) + delta_r)
    disparity = uL - best_u_r
    disp_valid = (disparity >= 0.0) & (disparity < max_disparity)
    neg = disparity <= 0.0
    disparity = torch.where(neg, 0.01, disparity)
    best_u_r = torch.where(neg, uL - 0.01, best_u_r)
    ok = ok & disp_valid

    # --- median-based outlier cull (a 1-element index: no value read back) ---
    sorted_sad = torch.sort(torch.where(ok, sad_best, float("inf"))).values
    mid = torch.clamp(ok.sum() // 2, 0, n - 1).reshape(1)
    ok = ok & (sad_best < 1.5 * 1.4 * sorted_sad[mid])

    neg1 = torch.full_like(best_u_r, -1.0)
    # a tensor numerator: `float / tensor` runs as reciprocal-then-multiply
    bf_t = torch.full_like(disparity, bf)
    depth = torch.where(ok, bf_t / torch.clamp(disparity, min=1e-6), neg1)
    return torch.where(ok, best_u_r, neg1), depth


def stereo_from_rgbd(kp_xy_raw, kp_xy_und, kp_valid, depth_img, bf: float,
                     depth_factor: float = 1.0):
    """RGB-D pseudo-stereo (`Frame::ComputeStereoFromRGBD`,
    `src/Frame.cc:1131-1183`): depth looked up at the RAW keypoint pixel
    (rounded half-to-even, as cvRound), virtual right coord computed from
    the UNDISTORTED one. Returns (u_right, depth), -1 where there is none."""
    h, w = depth_img.shape
    xi = torch.clamp(torch.round(kp_xy_raw[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(kp_xy_raw[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_img[yi, xi] * depth_factor
    ok = (d > 0) & kp_valid
    neg = torch.full_like(d, -1.0)
    # a tensor numerator: `float / tensor` runs as reciprocal-then-multiply,
    # which rounds twice
    bf_t = torch.full_like(d, bf)
    u_right = torch.where(ok, kp_xy_und[:, 0] - bf_t / torch.clamp(d, min=1e-9), neg)
    return u_right, torch.where(ok, d, neg)
