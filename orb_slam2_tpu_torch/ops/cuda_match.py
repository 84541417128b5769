"""The matching kernels K4, K5 and K8, their plain-PyTorch twins and their
wrappers (port of the matching half of `orb_slam2_tpu/ops/pallas_kernels.py`,
with the candidate gates its callers build around it).

| wrapper               | kernel (csrc/)  | replaces (TPU kernel and its callers' gate)                            | twin                          |
|-----------------------|-----------------|------------------------------------------------------------------------|-------------------------------|
| `window_best_two`     | `best_two.cu`   | `masked_best_two_pallas` + `matching.search_by_projection_frame`'s mask | `window_best_two_plain`       |
| `node_best_two`       | `best_two.cu`   | `masked_best_two_pallas` + `matching.search_by_node`'s mask            | `node_best_two_plain`         |
| `projection_best_two` | `proj_match.cu` | `projection_best_two_pallas`                                           | `projection_best_two_plain`   |
| `epi_match_keyframes` | `epi_match.cu`  | `epi_best_two_pallas` + `mapping_ops._epi_match_batch`'s per-feature glue | `epi_match_keyframes_plain` |

Each wrapper dispatches on the device of its input (`launch.py`): a CPU
tensor runs the twin, a CUDA tensor launches the kernel or raises. Each
kernel computes its search's gate in its one launch, so no (N, M) mask is
formed on the card; the twins build today's masks with plain torch and
reduce them with `masked_best_two_plain` / `epi_best_two_plain`, the specs
of the reductions. The kernels return integers from exact integer compares
and float compares of values rounded as in the twins, so they are bit-exact
against them. Descriptors are (n, 8) int32 words, the int32 view of the
reference's uint32 bits; masks are bool.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.config import device_table
from .launch import check, launch, on_cpu, ptr

BIG = 512    # > the largest Hamming distance (256): a masked entry
PROJ_TILE = 8192   # K4's and K5's targets per tile: 17 B staged + 2 B sorted each, in shared memory
OPEN = None        # an open side of an octave range


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
# K4: masked Hamming best / second best, the gate in the launch
# ---------------------------------------------------------------------------

def masked_best_two_plain(desc_a, desc_b, cand_mask):
    """The spec of K4's reduction: desc_a (N,8), desc_b (M,8) int32;
    cand_mask (N,M) bool -> best (N,), best_idx (N,), second (N,), all
    int32."""
    return best_two(hamming_matrix(desc_a, desc_b), cand_mask)


def window_candidates(uv, radius, src_level, src_ur, src_valid,
                      kp_xy, kp_level, kp_ur, kp_valid, octaves):
    """(N,M) bool candidate mask of a window search: square window of
    radius r around each source's projection, the target's octave in
    [src + dlo, src + dhi] for octaves = (dlo, dhi) (OPEN leaves a side
    open), stereo right-x within r where both sides have one, both sides
    valid."""
    dlo, dhi = octaves
    win = (torch.abs(uv[:, None, 0] - kp_xy[None, :, 0]) < radius[:, None]) & \
        (torch.abs(uv[:, None, 1] - kp_xy[None, :, 1]) < radius[:, None])
    if dlo is not OPEN:
        win = win & (kp_level[None, :] >= src_level[:, None] + dlo)
    if dhi is not OPEN:
        win = win & (kp_level[None, :] <= src_level[:, None] + dhi)
    stereo_ok = torch.where((src_ur[:, None] >= 0) & (kp_ur[None, :] >= 0),
                            torch.abs(src_ur[:, None] - kp_ur[None, :]) < radius[:, None],
                            torch.ones((), dtype=torch.bool, device=radius.device))
    return win & stereo_ok & src_valid[:, None] & kp_valid[None, :]


def window_best_two_plain(uv, radius, src_level, src_ur, src_valid, src_desc,
                          kp_xy, kp_level, kp_ur, kp_valid, kp_desc, octaves):
    """Sources (N,): projections uv (N,2) f32, window radius f32, octave
    int32, right x (-1 mono) f32, validity bool, descriptors (N,8) int32.
    Targets (M,): keypoints xy (M,2), level, right x, validity, descriptors.
    octaves: (dlo, dhi), the targets' octave range around the source's.
    Returns best (N,), best_idx (N,) and second best (N,) over every
    candidate, int32; a row with no candidate gives BIG / 0 / BIG."""
    cand = window_candidates(uv, radius, src_level, src_ur, src_valid,
                             kp_xy, kp_level, kp_ur, kp_valid, octaves)
    return masked_best_two_plain(src_desc, kp_desc, cand)


def _key_fits(what, m):
    if m < 1 or (BIG + 1) * m >= 2 ** 31:
        raise ValueError(f"{what}: {m} targets; the int32 key dist * M + col needs "
                         f"1 <= M < {2 ** 31 // (BIG + 1)}")


def _check_window_args(what, uv, radius, level, ur, valid, desc,
                       kp_xy, kp_level, kp_ur, kp_valid, kp_desc):
    """The arguments of a window search (K4's window form, K5): N sources,
    M targets on one CUDA device, as the kernels load them. Returns (N, M,
    device)."""
    n, m, dev = uv.shape[0], kp_xy.shape[0], uv.device
    _key_fits(what, m)
    for t, dtype, shape, name, align in (
            (uv, torch.float32, (n, 2), "uv", 8),
            (radius, torch.float32, (n,), "radius", 4),
            (level, torch.int32, (n,), "level", 4),
            (ur, torch.float32, (n,), "ur", 4),
            (valid, torch.bool, (n,), "valid", 1),
            (desc, torch.int32, (n, 8), "desc", 16),
            (kp_xy, torch.float32, (m, 2), "kp_xy", 8),
            (kp_level, torch.int32, (m,), "kp_level", 4),
            (kp_ur, torch.float32, (m,), "kp_ur", 4),
            (kp_valid, torch.bool, (m,), "kp_valid", 1),
            (kp_desc, torch.int32, (m, 8), "kp_desc", 16)):
        check(t, dtype, shape, dev, f"{what} {name}", align)
    return n, m, dev


def window_best_two(uv, radius, src_level, src_ur, src_valid, src_desc,
                    kp_xy, kp_level, kp_ur, kp_valid, kp_desc, octaves):
    """Kernel wrapper of `window_best_two_plain` (K4's window form): one
    launch of persistent CTAs that stage and bucket the targets as K5
    does, in tiles of PROJ_TILE; any number of targets whose key
    dist * M + col fits in int32."""
    if on_cpu(uv):
        return window_best_two_plain(uv, radius, src_level, src_ur, src_valid, src_desc,
                                     kp_xy, kp_level, kp_ur, kp_valid, kp_desc, octaves)
    n, m, dev = _check_window_args("window_best_two", uv, radius, src_level, src_ur, src_valid,
                                   src_desc, kp_xy, kp_level, kp_ur, kp_valid, kp_desc)
    dlo, dhi = (-2 ** 31 if octaves[0] is OPEN else int(octaves[0]),
                2 ** 31 - 1 if octaves[1] is OPEN else int(octaves[1]))
    best, idx, second = (torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(3))
    # each row's (key, second distance), carried between tiles
    carry = torch.empty((n, 2), dtype=torch.int32, device=dev) if m > PROJ_TILE else None
    if n:
        launch("best_two", "orb_window_best_two", dev, ptr(uv), ptr(radius), ptr(src_level),
               ptr(src_ur), ptr(src_valid), ptr(src_desc), n, ptr(kp_xy), ptr(kp_level),
               ptr(kp_ur), ptr(kp_valid), ptr(kp_desc), m, dlo, dhi, ptr(best), ptr(idx),
               ptr(second), None if carry is None else ptr(carry))
    return best, idx, second


def node_candidates(node_a, valid_a, node_b, valid_b):
    """(N,M) bool candidate mask of BoW-bucket matching: the same vocabulary
    node, node_a >= 0, both valid."""
    cand = (node_a[:, None] == node_b[None, :]) & (node_a[:, None] >= 0)
    return cand & valid_a[:, None] & valid_b[None, :]


def node_best_two_plain(node_a, desc_a, valid_a, node_b, desc_b, valid_b):
    """node_a (N,) int32, desc_a (N,8) int32, valid_a (N,) bool; node_b,
    desc_b, valid_b (M,...) -> best (N,), best_idx (N,), second (N,),
    int32."""
    return masked_best_two_plain(desc_a, desc_b,
                                 node_candidates(node_a, valid_a, node_b, valid_b))


def node_best_two(node_a, desc_a, valid_a, node_b, desc_b, valid_b):
    """Kernel wrapper of `node_best_two_plain` (K4's node form): CTAs of 16
    rows staging the targets' nodes and descriptors in shared memory."""
    if on_cpu(desc_a):
        return node_best_two_plain(node_a, desc_a, valid_a, node_b, desc_b, valid_b)
    n, m = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    _key_fits("node_best_two", m)
    for t, dtype, shape, name, align in (
            (node_a, torch.int32, (n,), "node_a", 4),
            (desc_a, torch.int32, (n, 8), "desc_a", 16),
            (valid_a, torch.bool, (n,), "valid_a", 1),
            (node_b, torch.int32, (m,), "node_b", 4),
            (desc_b, torch.int32, (m, 8), "desc_b", 16),
            (valid_b, torch.bool, (m,), "valid_b", 1)):
        check(t, dtype, shape, dev, f"node_best_two {name}", align)
    best, idx, second = (torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(3))
    if n:
        launch("best_two_node", "orb_node_best_two", dev, ptr(desc_a), ptr(node_a), ptr(valid_a), n,
               ptr(desc_b), ptr(node_b), ptr(valid_b), m, ptr(best), ptr(idx), ptr(second))
    return best, idx, second


# ---------------------------------------------------------------------------
# K5: projection search (gate + Hamming + level-aware best / second best)
# ---------------------------------------------------------------------------

def projection_candidates(uv, radius, pred_level, p_ur, p_valid,
                          kp_xy, kp_level, kp_ur, kp_valid):
    """(P,N) bool candidate mask of the local-map search: the window search
    at octaves [pred - 1, pred]."""
    return window_candidates(uv, radius, pred_level, p_ur, p_valid,
                             kp_xy, kp_level, kp_ur, kp_valid, (-1, 0))


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
    p, n, dev = _check_window_args("projection_best_two", uv, radius, pred_level, p_ur, p_valid,
                                   p_desc, kp_xy, kp_level, kp_ur, kp_valid, kp_desc)
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


# ---------------------------------------------------------------------------
# K8: the epipolar search of a keyframe event
# ---------------------------------------------------------------------------

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


def _row(a, k):
    """a[k] for a 0-d (or one-element) index tensor k on a's device, with
    no read back to the host."""
    return a.index_select(0, k.reshape(1))[0]


def epi_rows(kf_obs, kf_feat_valid, kf_xy, kf_desc, kf_level, kf1, kf2, F, epipoles,
             level_sigma2, scale_factors):
    """The per-feature terms of the epipolar search, gathered from the map's
    rows as `epi_best_two_plain` takes them: kf_* the map's (K,N,...)
    keyframe arrays, kf1 a 0-d int64 tensor (the new keyframe's row), kf2
    (B,) int64 (the neighbours' rows), F (B,3,3) float32
    (`mapping_ops._fundamental_from_poses`), epipoles (B,2) float32 (the new
    keyframe's centre in each neighbour), the octave tables as floats. kf1's
    epipolar lines in each neighbour in the XLA path's form
    (`_triangulate_decide:204-220`), the unbound masks, sig = 3.84 sigma^2
    and the epipole-distance gate at each feature's octave clamped to the
    tables."""
    dev = kf_obs.device
    kf1 = torch.as_tensor(kf1, device=dev).long()
    xy1 = _row(kf_xy, kf1)
    x1, y1 = xy1[None, :, 0], xy1[None, :, 1]
    la, lb, lc = (x1 * F[:, r, 0, None] + y1 * F[:, r, 1, None] + F[:, r, 2, None]
                  for r in range(3))
    un1 = (_row(kf_obs, kf1) < 0) & _row(kf_feat_valid, kf1)
    un2 = (kf_obs[kf2] < 0) & kf_feat_valid[kf2]
    xy2 = kf_xy[kf2]
    lvl2 = torch.clamp(kf_level[kf2], 0, len(level_sigma2) - 1).long()
    sig = 3.84 * device_table(tuple(level_sigma2), dev)[lvl2]
    dx, dy = xy2[..., 0] - epipoles[:, 0, None], xy2[..., 1] - epipoles[:, 1, None]
    far = dx * dx + dy * dy >= 100.0 * device_table(tuple(scale_factors), dev)[lvl2]
    return _row(kf_desc, kf1), un1, la, lb, lc, kf_desc[kf2], xy2, un2, sig, far


def epi_match_keyframes_plain(kf_obs, kf_feat_valid, kf_xy, kf_desc, kf_level, kf1, kf2, F,
                              epipoles, level_sigma2, scale_factors):
    """The epipolar search of a keyframe event from the map's rows (the
    arguments of `epi_rows`): `epi_best_two_plain` on the rows `epi_rows`
    gathers. Returns (best, best_idx), (B,N) int32."""
    return epi_best_two_plain(*epi_rows(kf_obs, kf_feat_valid, kf_xy, kf_desc, kf_level, kf1,
                                        kf2, F, epipoles, level_sigma2, scale_factors))


def epi_match_keyframes(kf_obs, kf_feat_valid, kf_xy, kf_desc, kf_level, kf1, kf2, F,
                        epipoles, level_sigma2, scale_factors):
    """Kernel wrapper of `epi_match_keyframes_plain` (K8, `csrc/epi_match.cu`):
    one launch over (neighbour, chunk of kf1 features) that gathers the
    rows, gates and reduces; the octave tables pass by value."""
    if on_cpu(kf_obs):
        return epi_match_keyframes_plain(kf_obs, kf_feat_valid, kf_xy, kf_desc, kf_level, kf1,
                                         kf2, F, epipoles, level_sigma2, scale_factors)
    K, n = kf_obs.shape
    nb = kf2.shape[0]
    dev = kf_obs.device
    _key_fits("epi_match_keyframes", n)
    levels = len(level_sigma2)
    if not 1 <= levels <= 32 or len(scale_factors) != levels:
        raise ValueError(f"epi_match_keyframes: {levels} octaves of sigma^2 and "
                         f"{len(scale_factors)} scale factors; 1 to 32 of each, as many")
    kf1 = torch.as_tensor(kf1, device=dev).reshape(1)
    for t, dtype, shape, name, align in (
            (kf_obs, torch.int32, (K, n), "kf_obs", 4),
            (kf_feat_valid, torch.bool, (K, n), "kf_feat_valid", 1),
            (kf_xy, torch.float32, (K, n, 2), "kf_xy", 8),
            (kf_desc, torch.int32, (K, n, 8), "kf_desc", 16),
            (kf_level, torch.int32, (K, n), "kf_level", 4),
            (kf1, torch.int64, (1,), "kf1", 8),
            (kf2, torch.int64, (nb,), "kf2", 8),
            (F, torch.float32, (nb, 3, 3), "F", 4),
            (epipoles, torch.float32, (nb, 2), "epipoles", 8)):
        check(t, dtype, shape, dev, f"epi_match_keyframes {name}", align)
    best, idx = (torch.empty((nb, n), dtype=torch.int32, device=dev) for _ in range(2))
    if nb:
        launch("epi_match", "orb_epi_match", dev, (ctypes.c_float * levels)(*level_sigma2),
               (ctypes.c_float * levels)(*scale_factors), levels, ptr(kf_obs),
               ptr(kf_feat_valid), ptr(kf_xy), ptr(kf_desc), ptr(kf_level), ptr(kf1), ptr(kf2),
               ptr(F), ptr(epipoles), nb, n, ptr(best), ptr(idx))
    return best, idx
