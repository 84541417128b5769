"""A numpy model of K5's one-pass search (`csrc/proj_match.cu`) against its
twin `projection_best_two_plain`, on the CPU, with all keypoints in one tile
and in tiles (the kernel's loop for N > 8192, modelled at small tile sizes).

The model repeats the kernel's decisions step by step: the bucket grid
(32 px cells doubled until levels x cells <= 4096, from the valid finite
keypoints' largest coordinates), the counting sort (bucket order within a
bucket shuffled, as the shared atomics may leave it), 32 lanes that take one
(octave, cell row) run of buckets each with a one-cell margin, or every
column when the window is too far out or not finite, the per-lane,
per-octave least key and second-least distance, and the two warp minimums.
In tiles: the grid and sort per tile, the lanes on the tile's columns, at
the tile's end each octave's pair (least key, second-least distance) by two
warp minimums, merged with the earlier tiles' pair (the lesser key; the
least of the two distances and the larger key's distance). The twin decides
from the dense (P, N) mask in two passes; the two must be equal on every
row, ties and edges included.
"""
import numpy as np
import pytest
import torch

from orb_slam2_tpu_torch.ops import cuda_match as cm

BIG = cm.BIG
INT_MAX = 2 ** 31 - 1
MAX_LEVELS, MAX_BUCKETS, FAR_OUT = 16, 4096, np.float32(2.0 ** 20)
f32 = np.float32


def _popcount(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _grid(kp_xy, kp_level, fin):
    ex = max(f32(0), kp_xy[fin, 0].max(initial=f32(0)))
    ey = max(f32(0), kp_xy[fin, 1].max(initial=f32(0)))
    nl = min(max(0, int(kp_level[fin].max(initial=0))) + 1, MAX_LEVELS)
    inv = f32(1 / 32)
    while True:
        gx, gy = np.floor(ex * inv) + f32(1), np.floor(ey * inv) + f32(1)
        if gx * gy * f32(nl) <= MAX_BUCKETS:
            return inv, int(gx), int(gy), nl
        inv = inv * f32(0.5)


def _cell(x, inv, g):
    return int(min(max(np.floor(f32(x) * inv), f32(0)), f32(g - 1)))


def _level(lvl, nl):
    return min(max(int(lvl), 0), nl - 1)


def _tile_buckets(rng, kp_xy, kp_level, kp_valid, c0, c1):
    """The grid and counting sort of one tile of columns [c0, c1): the
    grid, off (off[b + 1] = bucket b's end) and the sorted (global) columns,
    each bucket's order shuffled as the shared atomics may leave it."""
    tile = np.arange(c0, c1)
    fin = kp_valid[tile] & np.isfinite(kp_xy[tile]).all(1)
    inv, gx, gy, nl = _grid(kp_xy[tile], kp_level[tile], fin)
    bucket = np.full(len(tile), -1)
    for c in np.flatnonzero(fin):
        col = tile[c]
        bucket[c] = ((_level(kp_level[col], nl) * gy + _cell(kp_xy[col, 1], inv, gy)) * gx
                     + _cell(kp_xy[col, 0], inv, gx))
    counts = np.bincount(bucket[fin], minlength=MAX_BUCKETS)
    end = np.cumsum(counts)                       # off[b + 1] after the scatter
    off = np.concatenate([[0], end])
    cols = np.empty(int(end[-1]), np.int64)
    for b in np.flatnonzero(counts):
        cols[off[b]:off[b + 1]] = tile[rng.permutation(np.flatnonzero(bucket == b))]
    return (inv, gx, gy, nl), off, cols


def _key_dist(key, n):
    return BIG if key == INT_MAX else key // n


def lane_model(rng, uv, radius, pred, p_ur, p_valid, p_desc, kp_xy, kp_level, kp_ur, kp_valid,
               kp_desc, tile=None):
    """The kernel's decisions on every row, its keypoints in tiles of `tile`
    columns (all in one tile when None, the kernel's path for N <= 8192).
    Returns (best, idx, second) and the columns each row visited."""
    n = kp_xy.shape[0]
    tile = n if tile is None else tile
    tiles = [(c0, min(c0 + tile, n), *_tile_buckets(rng, kp_xy, kp_level, kp_valid, c0,
                                                      min(c0 + tile, n)))
             for c0 in range(0, n, tile)]
    dist = _popcount(p_desc[:, None, :] ^ kp_desc[None, :, :])

    best = np.full(len(uv), BIG), np.zeros(len(uv), np.int64), np.full(len(uv), BIG)
    visits = np.zeros(len(uv), np.int64)
    for row in range(len(uv)):
        if not p_valid[row]:
            continue
        u, v, r, pur, pl = uv[row, 0], uv[row, 1], radius[row], p_ur[row], int(pred[row])
        carry = None                               # (K1, D2) per octave of the earlier tiles
        for t, (c0, c1, (inv, gx, gy, nl), off, cols) in enumerate(tiles):
            k1 = np.full((32, 2), INT_MAX, np.int64)
            d2 = np.full((32, 2), BIG, np.int64)

            def visit(lane, col):
                visits[row] += 1
                kx, ky, kl, kur = kp_xy[col, 0], kp_xy[col, 1], int(kp_level[col]), kp_ur[col]
                if not kp_valid[col] or not (abs(u - kx) < r) or not (abs(v - ky) < r):
                    return
                if kl < pl - 1 or kl > pl:
                    return
                if pur >= 0 and kur >= 0 and not (abs(pur - kur) < r):
                    return
                li, d = kl - (pl - 1), int(dist[row, col])
                key = d * n + col
                if key < k1[lane, li]:
                    if k1[lane, li] != INT_MAX:
                        d2[lane, li] = min(d2[lane, li], k1[lane, li] // n)
                    k1[lane, li] = key
                else:
                    d2[lane, li] = min(d2[lane, li], d)

            near = np.isfinite(r) and abs(u) + r < FAR_OUT and abs(v) + r < FAR_OUT
            if r > 0 and not near:
                for col in range(c0, c1):
                    visit((col - c0) % 32, col)
            elif r > 0:
                cx0, cx1 = max(_cell(u - r, inv, gx) - 1, 0), min(_cell(u + r, inv, gx) + 1, gx - 1)
                cy0, cy1 = max(_cell(v - r, inv, gy) - 1, 0), min(_cell(v + r, inv, gy) + 1, gy - 1)
                l0, l1 = _level(pl - 1, nl), _level(pl, nl)
                ny = cy1 - cy0 + 1
                for sp in range((l1 - l0 + 1) * ny):
                    b0 = ((l0 + sp // ny) * gy + cy0 + sp % ny) * gx + cx0
                    for i in range(off[b0], off[b0 + cx1 - cx0 + 1]):
                        visit(sp % 32, cols[i])
            if len(tiles) == 1:                    # the one-tile reduction
                kmin = int(k1.min())
                if kmin == INT_MAX:
                    continue
                b, bidx = kmin // n, kmin % n
                li = int(kp_level[bidx]) - (pl - 1)
                own = k1[:, li]
                lanes = np.where(own == kmin, d2[:, li], np.where(own == INT_MAX, BIG, own // n))
                best[0][row], best[1][row], best[2][row] = b, bidx, int(lanes.min())
                continue
            # the tile's pair per octave (two warp minimums each), merged
            pair = []
            for li in range(2):
                K1 = int(k1[:, li].min())
                D2 = int(np.where(k1[:, li] == K1, d2[:, li],
                                  [_key_dist(k, n) for k in k1[:, li]]).min())
                if carry is not None:
                    Kc, Dc = carry[li]
                    D2 = min(D2, Dc, _key_dist(max(K1, Kc), n))
                    K1 = min(K1, Kc)
                pair.append((K1, D2))
            carry = pair
        if carry is not None:
            (ka, da), (kb, db) = carry
            kmin = min(ka, kb)
            if kmin != INT_MAX:
                best[0][row], best[1][row] = kmin // n, kmin % n
                best[2][row] = db if kmin == kb else da
    return best, visits


def _inputs(rng, p, n):
    """Map points projected near keypoints of a 640x480 frame, with the
    ties and edges forced: duplicate descriptors, two best candidates at the
    best's octave, keypoints on cell edges and at |du| = r exactly, points
    and keypoints outside the image, non-finite windows, r = 0."""
    kp_xy = np.stack([rng.uniform(-20, 660, n), rng.uniform(-20, 500, n)], 1).astype(f32)
    kp_xy[:40] = (rng.integers(0, 20, (40, 2)) * 32).astype(f32)          # on cell edges
    kp_level = rng.integers(0, 8, n).astype(np.int32)
    kp_ur = np.where(rng.random(n) < 0.5, kp_xy[:, 0] - rng.uniform(1, 30, n), -1).astype(f32)
    kp_desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    kp_desc[n // 2: n // 2 + 30] = kp_desc[:30]                          # duplicate descriptors
    kp_valid = rng.random(n) < 0.9
    kp_xy[45] = np.nan
    src = rng.integers(0, n, p)
    uv = (kp_xy[src] + rng.normal(0, 6, (p, 2))).astype(f32)
    radius = rng.uniform(4, 60, p).astype(f32)
    pred = np.clip(kp_level[src] + rng.integers(0, 2, p), 0, 7).astype(np.int32)
    p_ur = np.where(rng.random(p) < 0.5, uv[:, 0] - rng.uniform(1, 30, p), -1).astype(f32)
    flips = rng.integers(0, 2 ** 32, (p, 8), dtype=np.uint32) & np.uint32(0x01010101)
    p_desc = kp_desc[src] ^ flips
    p_valid = rng.random(p) < 0.9
    # two candidates at one octave with the best distance: a twin keypoint
    # beside each of rows 0-19's sources, same octave, same descriptor
    for row in range(20):
        twin = n - 1 - row
        kp_xy[twin] = kp_xy[src[row]] + f32(1.0)
        kp_level[twin], kp_ur[twin] = kp_level[src[row]], kp_ur[src[row]]
        kp_desc[twin], kp_valid[twin] = kp_desc[src[row]], True
        p_desc[row], p_valid[row], radius[row] = kp_desc[src[row]], True, f32(8)
        uv[row], pred[row] = kp_xy[src[row]], kp_level[src[row]]
    # |du| = r exactly: a keypoint at u + r (not a candidate) and at u - r + ulp
    for row in range(20, 30):
        c0, c1 = n - 40 - row, n - 80 - row
        kp_xy[c0] = (uv[row, 0] + radius[row], uv[row, 1])
        kp_xy[c1] = (np.nextafter(uv[row, 0] - radius[row], f32(np.inf)), uv[row, 1])
        for c in (c0, c1):
            kp_level[c], kp_valid[c], kp_ur[c] = pred[row], True, f32(-1)
        p_valid[row] = True
    radius[30], radius[31], radius[32], uv[33] = np.nan, np.inf, f32(0), (np.nan, 5)
    uv[34], radius[34] = (3e6, 100), f32(5e6)          # far out: every column
    p_valid[30:35] = True
    return (uv, radius, pred, p_ur, p_valid, p_desc.view(np.int32), kp_xy, kp_level, kp_ur,
            kp_valid, kp_desc.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_model_equals_twin(seed):
    rng = np.random.default_rng(seed)
    args = _inputs(rng, 300, 500)
    (best, idx, second), visits = lane_model(rng, *args)
    want = cm.projection_best_two_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                          for a in args))
    for name, g, w in zip(("best", "idx", "second"), (best, idx, second), want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    # the forced cases happened: ties at the best's octave, rows with no
    # candidate, a row over every column, and bucketed rows that test few
    assert (second[:20] == best[:20]).sum() >= 10
    assert (best == BIG).sum() > 0 and visits[34] == 500
    assert np.median(visits[35:][args[4][35:]]) < 100


def _tie_across_tiles(args, tile, rows=range(40, 60)):
    """Force ties across tile borders: for each row, the best keypoint in
    one tile, its twin (same descriptor, octave and place) in the next, and
    a second candidate at the best's octave one bit off in the one after,
    so best, index and second each come from a tile of their own where
    three tiles still have free columns (each keypoint used once). Returns
    the rows forced."""
    uv, radius, pred, p_ur, p_valid, p_desc, kp_xy, kp_level, kp_ur, kp_valid, kp_desc = args
    n = kp_xy.shape[0]
    free = [list(range(c0, min(c0 + tile, n))) for c0 in range(0, n, tile)]
    forced = []
    for k, row in enumerate(rows):
        live = [f for f in free if f]
        pool = [live[(k + j) % len(live)] for j in range(3)] if len(live) > 1 else []
        if not pool or (pool[0] is pool[2] and len(pool[0]) < 2):
            continue
        c, twin, near = (f.pop(0) for f in pool)
        for col in (c, twin, near):
            kp_xy[col], kp_level[col], kp_ur[col], kp_valid[col] = uv[row], pred[row], -1.0, True
        kp_desc[c] = kp_desc[twin] = p_desc[row]
        kp_desc[near] = p_desc[row] ^ np.int32(1)
        radius[row], p_valid[row] = np.float32(6), True
        forced.append(row)
    return forced


@pytest.mark.parametrize("seed,n,tile", [(3, 200, 64), (4, 130, 7), (5, 200, 100),
                                         (6, 129, 64)])
def test_tiled_lane_model_equals_twin(seed, n, tile):
    """The tile loop (N = 200 in tiles of 64; 130 in 19 tiles of 7; 200 in
    two tiles; 129 in two tiles of 64 and one of 1), ties forced across
    tile borders: equal to the twin on every row; the forced ties give
    best == second."""
    rng = np.random.default_rng(seed)
    args = _inputs(rng, 120, n)
    forced = _tie_across_tiles(args, tile)
    (best, idx, second), _ = lane_model(rng, *args, tile=tile)
    want = cm.projection_best_two_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                          for a in args))
    for name, g, w in zip(("best", "idx", "second"), (best, idx, second), want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert len(forced) >= 2 and (best[forced] == second[forced]).sum() >= len(forced) // 2
    assert (best < BIG).sum() > 30
