"""The matching kernels K4, K5 and K8, their plain-PyTorch twins and their
wrappers (port of the matching half of `orb_slam2_tpu/ops/pallas_kernels.py`).

| wrapper               | kernel (csrc/)  | replaces (TPU kernel)                          | twin                        |
|-----------------------|-----------------|------------------------------------------------|-----------------------------|
| `masked_best_two`     | `best_two.cu`   | `pallas_kernels.masked_best_two_pallas`        | `masked_best_two_plain`     |
| `projection_best_two` | `proj_match.cu` | `pallas_kernels.projection_best_two_pallas`    | `projection_best_two_plain` |
| `epi_best_two`        | `epi_match.cu`  | `pallas_kernels.epi_best_two_pallas`           | `epi_best_two_plain`        |

Each wrapper dispatches on the device of its input (`launch.py`): a CPU
tensor runs the twin, a CUDA tensor launches the kernel or raises. The
kernels return integers from exact integer compares and float compares of
values rounded as in the twins, so they are bit-exact against them.
Descriptors are (n, 8) int32 words, the int32 view of the reference's
uint32 bits; masks are bool.
"""
from __future__ import annotations

import torch

from .launch import check, launch, on_cpu, ptr

BIG = 512    # > the largest Hamming distance (256): a masked entry
PROJ_TILE = 8192   # K5's keypoints per tile: 17 B staged + 2 B sorted each, in shared memory


def popcount32(x):
    """Bits set in each int32 word, counting the word as its uint32 bits.

    SWAR on the low 31 bits (non-negative, so every right shift is logical
    and no sum overflows) plus the sign bit on its own: `>>` on a negative
    int32 is arithmetic, and torch has no popcount."""
    top = (x < 0).to(torch.int32)
    x = x & 0x7FFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F) + top


def hamming_matrix(desc_a, desc_b):
    """(N,8) x (M,8) int32 words -> (N,M) int32 Hamming distances, one word
    at a time so no (N,M,8) intermediate is formed."""
    dist = popcount32(desc_a[:, None, 0] ^ desc_b[None, :, 0])
    for w in range(1, desc_a.shape[1]):
        dist = dist + popcount32(desc_a[:, None, w] ^ desc_b[None, :, w])
    return dist


def best_two(dist, cand_mask):
    """Per row of (N,M): best distance, best index (the lowest wins a tie)
    and second best, masked entries counting as BIG. Rows masked everywhere
    give BIG / 0 / BIG."""
    d = torch.where(cand_mask, dist, torch.full_like(dist, BIG))
    best, best_idx = torch.min(d, dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    second = d.index_put((rows, best_idx), torch.full_like(best, BIG)).min(dim=1).values
    return best, best_idx.to(torch.int32), second


# ---------------------------------------------------------------------------
# K4: masked Hamming best / second best
# ---------------------------------------------------------------------------

def masked_best_two_plain(desc_a, desc_b, cand_mask):
    """desc_a (N,8), desc_b (M,8) int32; cand_mask (N,M) bool -> best (N,),
    best_idx (N,), second (N,), all int32."""
    return best_two(hamming_matrix(desc_a, desc_b), cand_mask)


def masked_best_two(desc_a, desc_b, cand_mask):
    """Kernel wrapper of `masked_best_two_plain`."""
    if on_cpu(desc_a):
        return masked_best_two_plain(desc_a, desc_b, cand_mask)
    n, m = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    if m < 1 or (BIG + 1) * m >= 2 ** 31:
        raise ValueError(f"masked_best_two: {m} targets; the int32 key "
                         f"dist * M + col needs 1 <= M < {2 ** 31 // (BIG + 1)}")
    check(desc_a, torch.int32, (n, 8), dev, "masked_best_two desc_a", align=16)
    check(desc_b, torch.int32, (m, 8), dev, "masked_best_two desc_b", align=16)
    check(cand_mask, torch.bool, (n, m), dev, "masked_best_two cand_mask")
    best, idx, second = (torch.empty((n,), dtype=torch.int32, device=dev)
                         for _ in range(3))
    if n:
        launch("best_two", "orb_best_two", dev, ptr(desc_a), n, ptr(desc_b), m,
               ptr(cand_mask), ptr(best), ptr(idx), ptr(second))
    return best, idx, second


# ---------------------------------------------------------------------------
# K5: projection search (gate + Hamming + level-aware best / second best)
# ---------------------------------------------------------------------------

def projection_candidates(uv, radius, pred_level, p_ur, p_valid,
                          kp_xy, kp_level, kp_ur, kp_valid):
    """(P,N) bool candidate mask of the local-map search: square window of
    radius r around the projection, octave in [pred - 1, pred], stereo
    right-x within r where both sides have one, both sides valid."""
    win = (torch.abs(uv[:, None, 0] - kp_xy[None, :, 0]) < radius[:, None]) & \
        (torch.abs(uv[:, None, 1] - kp_xy[None, :, 1]) < radius[:, None])
    lvl_ok = (kp_level[None, :] >= pred_level[:, None] - 1) & \
        (kp_level[None, :] <= pred_level[:, None])
    stereo_ok = ~((p_ur[:, None] >= 0) & (kp_ur[None, :] >= 0)) | \
        (torch.abs(p_ur[:, None] - kp_ur[None, :]) < radius[:, None])
    return win & lvl_ok & stereo_ok & p_valid[:, None] & kp_valid[None, :]


def projection_best_two_plain(uv, radius, pred_level, p_ur, p_valid, p_desc,
                              kp_xy, kp_level, kp_ur, kp_valid, kp_desc):
    """Sources (P,): projections uv (P,2) f32, window radius f32, predicted
    octave int32, projected right x (-1 mono) f32, validity bool,
    descriptors (P,8) int32. Targets (N,): keypoints xy (N,2), level, right
    x, validity, descriptors. Returns best (P,), best_idx (P,) and the second
    best among candidates at the best's octave (P,), all int32; a row
    masked everywhere gives BIG / 0 / BIG."""
    cand = projection_candidates(uv, radius, pred_level, p_ur, p_valid,
                                 kp_xy, kp_level, kp_ur, kp_valid)
    dist = hamming_matrix(p_desc, kp_desc)
    best, best_idx, _ = best_two(dist, cand)
    best_lvl = kp_level[best_idx.long()]
    same = cand & (kp_level[None, :] == best_lvl[:, None])
    d = torch.where(same, dist, torch.full_like(dist, BIG))
    rows = torch.arange(d.shape[0], device=d.device)
    second = d.index_put((rows, best_idx.long()), torch.full_like(best, BIG))
    return best, best_idx, second.min(dim=1).values


def epi_candidates(un1, la, lb, lc, xy2, un2, sig, far):
    """(N,N) bool candidate mask of one neighbour, the XLA path's gate
    (`mapping_ops._triangulate_decide:204-220`): unbound on both sides, far
    from the epipole, num*num/den < sig with num = la*x2 + lb*y2 + lc and
    den = max(la*la + lb*lb, 1e-12). la/lb/lc, un1 (N,) for kf1's features;
    xy2 (N,2), un2, sig, far (N,) for the neighbour's."""
    num = la[:, None] * xy2[None, :, 0] + lb[:, None] * xy2[None, :, 1] + lc[:, None]
    den = torch.clamp(la * la + lb * lb, min=1e-12)[:, None]
    epi_ok = num * num / den < sig[None, :]
    return un1[:, None] & un2[None, :] & epi_ok & far[None, :]


def epi_best_two_plain(desc1, un1, la, lb, lc, desc2, xy2, un2, sig, far):
    """Batched over B neighbours: desc1 (N,8) int32, un1 (N,) bool; la, lb,
    lc (B,N) float32, kf1's epipolar lines in each neighbour; desc2
    (B,N,8) int32, xy2 (B,N,2) float32, un2 (B,N) bool, sig (B,N) float32
    (3.84 sigma^2 of the neighbour feature's octave), far (B,N) bool.
    Returns best (B,N) and best_idx (B,N) int32; a row with no candidate
    gives BIG / 0. One neighbour at a time, so the (N,N) temporaries are
    the largest."""
    best, idx = [], []
    for b in range(la.shape[0]):
        cand = epi_candidates(un1, la[b], lb[b], lc[b], xy2[b], un2[b], sig[b], far[b])
        bb, ii, _ = best_two(hamming_matrix(desc1, desc2[b]), cand)
        best.append(bb)
        idx.append(ii)
    n = desc1.shape[0]
    if not best:
        empty = torch.zeros((0, n), dtype=torch.int32, device=desc1.device)
        return empty, empty.clone()
    return torch.stack(best).to(torch.int32), torch.stack(idx)


def epi_best_two(desc1, un1, la, lb, lc, desc2, xy2, un2, sig, far):
    """Kernel wrapper of `epi_best_two_plain` (K8, `csrc/epi_match.cu`)."""
    if on_cpu(desc1):
        return epi_best_two_plain(desc1, un1, la, lb, lc, desc2, xy2, un2, sig, far)
    nb, n = la.shape
    dev = desc1.device
    if n < 1 or (BIG + 1) * n >= 2 ** 31:
        raise ValueError(f"epi_best_two: {n} features; the int32 key "
                         f"dist * N + col needs 1 <= N < {2 ** 31 // (BIG + 1)}")
    for t, dtype, shape, name, align in (
            (desc1, torch.int32, (n, 8), "desc1", 16),
            (un1, torch.bool, (n,), "un1", 1),
            (la, torch.float32, (nb, n), "la", 4),
            (lb, torch.float32, (nb, n), "lb", 4),
            (lc, torch.float32, (nb, n), "lc", 4),
            (desc2, torch.int32, (nb, n, 8), "desc2", 16),
            (xy2, torch.float32, (nb, n, 2), "xy2", 8),
            (un2, torch.bool, (nb, n), "un2", 1),
            (sig, torch.float32, (nb, n), "sig", 4),
            (far, torch.bool, (nb, n), "far", 1)):
        check(t, dtype, shape, dev, f"epi_best_two {name}", align)
    best, idx = (torch.empty((nb, n), dtype=torch.int32, device=dev) for _ in range(2))
    if nb:
        launch("epi_match", "orb_epi_match", dev, ptr(desc1), ptr(un1), ptr(la), ptr(lb),
               ptr(lc), ptr(desc2), ptr(xy2), ptr(un2), ptr(sig), ptr(far), nb, n,
               ptr(best), ptr(idx))
    return best, idx


def projection_best_two(uv, radius, pred_level, p_ur, p_valid, p_desc,
                        kp_xy, kp_level, kp_ur, kp_valid, kp_desc):
    """Kernel wrapper of `projection_best_two_plain`: one launch of
    persistent CTAs, each staging the keypoints in shared memory and
    bucketing them by (octave, cell), in tiles of PROJ_TILE keypoints; any
    number of keypoints whose key dist * N + col fits in int32."""
    if on_cpu(uv):
        return projection_best_two_plain(uv, radius, pred_level, p_ur, p_valid,
                                         p_desc, kp_xy, kp_level, kp_ur, kp_valid,
                                         kp_desc)
    p, n = uv.shape[0], kp_xy.shape[0]
    dev = uv.device
    if n < 1 or (BIG + 1) * n >= 2 ** 31:
        raise ValueError(f"projection_best_two: {n} targets; the int32 key "
                         f"dist * N + col needs 1 <= N < {2 ** 31 // (BIG + 1)}")
    for t, dtype, shape, name, align in (
            (uv, torch.float32, (p, 2), "uv", 8),
            (radius, torch.float32, (p,), "radius", 4),
            (pred_level, torch.int32, (p,), "pred_level", 4),
            (p_ur, torch.float32, (p,), "p_ur", 4),
            (p_valid, torch.bool, (p,), "p_valid", 1),
            (p_desc, torch.int32, (p, 8), "p_desc", 16),
            (kp_xy, torch.float32, (n, 2), "kp_xy", 8),
            (kp_level, torch.int32, (n,), "kp_level", 4),
            (kp_ur, torch.float32, (n,), "kp_ur", 4),
            (kp_valid, torch.bool, (n,), "kp_valid", 1),
            (kp_desc, torch.int32, (n, 8), "kp_desc", 16)):
        check(t, dtype, shape, dev, f"projection_best_two {name}", align)
    best, idx, second = (torch.empty((p,), dtype=torch.int32, device=dev)
                         for _ in range(3))
    # each row's (key, second distance) per octave, carried between tiles
    carry = torch.empty((p, 4), dtype=torch.int32, device=dev) if n > PROJ_TILE else None
    if p:
        launch("proj_match", "orb_proj_match", dev, ptr(uv), ptr(radius),
               ptr(pred_level), ptr(p_ur), ptr(p_valid), ptr(p_desc), p, ptr(kp_xy),
               ptr(kp_level), ptr(kp_ur), ptr(kp_valid), ptr(kp_desc), n,
               ptr(best), ptr(idx), ptr(second), None if carry is None else ptr(carry))
    return best, idx, second
