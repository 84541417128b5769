"""K4's two gates (`orb_slam2_tpu_torch/ops/cuda_match.py`
`window_best_two_plain`, `node_best_two_plain`) against the JAX reference on
the CPU (XLA), and numpy models of the two kernels' orders
(`csrc/best_two.cu`) against the twins.

- The window form's twin against the candidate mask the reference's
  `search_by_projection_frame` builds (`orb_slam2_tpu/ops/matching.py:
  207-226`) and its `best_two`: the forward, backward and neither octave
  rules, stereo on and off, radii and keypoints on 32 px cell borders; and
  the whole `search_by_projection_frame` under each rule.
- The node form's twin against the reference's `search_by_node` mask
  (`:318-320`) and `best_two`, with nodes -1 and with every node 0; and the
  whole `search_by_node`.
- The window kernel's order: the bucket grid and counting sort of K5's
  model (`test_torch_proj_match_lanes.py`, the shared `bucket_search.cuh`),
  lanes that visit the buckets of the row's octave range (open sides
  clamped to the grid), one (least key, second-least distance) state per
  lane of any octave, at a tile's end two warp minimums merged with the
  carried pair. The node kernel's order: target tiles, lanes striding over
  a tile's columns and keeping their state across tiles, two warp minimums.
Every comparison is bit-exact: the outputs are integers decided by exact
integer and float compares on the same inputs.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import matching as jm

from orb_slam2_tpu_torch.ops import cuda_match as cm
from orb_slam2_tpu_torch.ops import matching as tm

from test_torch_proj_match_lanes import (FAR_OUT, INT_MAX, _cell, _inputs, _key_dist, _level,
                                         _popcount, _tie_across_tiles, _tile_buckets)

torch.set_num_threads(1)
BIG = cm.BIG
SF = [1.2 ** i for i in range(8)]
RULES = {"neither": (-1, 1), "forward": (0, cm.OPEN), "backward": (cm.OPEN, 0)}


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32 else a))


@jax.jit
def _jax_window_mask(uv, radius, src_level, src_ur, src_valid, kp_xy, kp_level, kp_ur,
                     kp_valid, lo_open, hi_open, dlo, dhi):
    """The reference's candidate mask (matching.py:210-226), its octave rule
    written as the offsets the three branches test."""
    win = (jnp.abs(uv[:, None, 0] - kp_xy[None, :, 0]) < radius[:, None]) & (
        jnp.abs(uv[:, None, 1] - kp_xy[None, :, 1]) < radius[:, None])
    lvl_ok = (lo_open | (kp_level[None, :] >= src_level[:, None] + dlo)) & \
        (hi_open | (kp_level[None, :] <= src_level[:, None] + dhi))
    stereo_ok = jnp.where((src_ur[:, None] >= 0) & (kp_ur[None, :] >= 0),
                          jnp.abs(src_ur[:, None] - kp_ur[None, :]) < radius[:, None], True)
    return win & lvl_ok & stereo_ok & src_valid[:, None] & kp_valid[None, :]


def _window_inputs(rng, n, m, stereo=True):
    """Sources projected near targets of a 640x480 frame, with radii
    (th * scale factor, as the search computes them) and places on 32 px
    cell borders: a fifth of the targets on cell corners, a fifth of the
    sources there too, and targets at u +- r exactly."""
    kp_xy = np.stack([rng.uniform(0, 640, m), rng.uniform(0, 480, m)], 1).astype(np.float32)
    kp_xy[: m // 5] = (rng.integers(0, 20, (m // 5, 2)) * 32).astype(np.float32)
    kp_level = rng.integers(0, 8, m).astype(np.int32)
    kp_ur = np.where(rng.random(m) < 0.5, kp_xy[:, 0] - rng.uniform(1, 30, m), -1).astype(np.float32)
    src = rng.integers(0, m, n)
    uv = (kp_xy[src] + rng.normal(0, 4, (n, 2))).astype(np.float32)
    uv[: n // 5] = kp_xy[src[: n // 5]]
    level = np.clip(kp_level[src] + rng.integers(-1, 2, n), 0, 7).astype(np.int32)
    radius = (np.float32(rng.choice([14.0, 32.0])) *
              np.asarray(SF, np.float32)[level]).astype(np.float32)
    for row in range(n // 5, n // 5 + 20):             # |du| = r exactly, and one ulp inside
        kp_xy[m - 1 - row] = (uv[row, 0] + radius[row], uv[row, 1])
        kp_xy[m - 41 - row] = (np.nextafter(uv[row, 0] - radius[row], np.float32(np.inf)), uv[row, 1])
        kp_level[[m - 1 - row, m - 41 - row]] = level[row]
    ur = np.where(rng.random(n) < 0.5, uv[:, 0] - rng.uniform(1, 30, n), -1).astype(np.float32)
    if not stereo:
        ur[:], kp_ur[:] = -1.0, -1.0
    kp_desc = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    desc = kp_desc[src] ^ (rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32) & np.uint32(0x01010101))
    return (uv, radius, level, ur, rng.random(n) < 0.9, desc, kp_xy, kp_level, kp_ur,
            rng.random(m) < 0.9, kp_desc)


@pytest.mark.parametrize("stereo", [True, False])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_window_twin_equals_reference_mask_and_best_two(rule, stereo):
    args = _window_inputs(np.random.default_rng(len(rule) + stereo), 300, 400, stereo)
    dlo, dhi = RULES[rule]
    want_mask = _jax_window_mask(*map(jnp.asarray, args[:5] + args[6:10]),
                                 dlo is cm.OPEN, dhi is cm.OPEN, dlo or 0, dhi or 0)
    got_mask = cm.window_candidates(*map(_t, args[:5] + args[6:10]), RULES[rule])
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    want = jm.best_two(jm.hamming_matrix(jnp.asarray(args[5]), jnp.asarray(args[10])), want_mask)
    got = cm.window_best_two(*map(_t, args), RULES[rule])         # CPU: the twin
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 50 < int((got[0] < BIG).sum()) < 300 and int((got[2] < BIG).sum()) > 20


@pytest.mark.parametrize("rule", ["forward", "backward"])
def test_search_by_projection_frame_rules_bit_exact(rule):
    """The whole motion-model search under the forward and backward rules
    (test_torch_matching.py covers neither)."""
    rng = np.random.default_rng(7 + len(rule))
    s = _window_inputs(rng, 300, 256)
    src = (s[0], s[2], s[5], s[4], rng.uniform(0, 360, 300).astype(np.float32), s[3])
    kp = (s[6], s[7], s[10], s[9], rng.uniform(0, 360, 256).astype(np.float32), s[8])
    kw = dict(forward=rule == "forward", backward=rule == "backward", check_rotation=False)
    want = jm.search_by_projection_frame(*map(jnp.asarray, src + kp), SF, 7.0, **kw)
    got = tm.search_by_projection_frame(*map(_t, src + kp), SF, 7.0, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    np.testing.assert_array_equal(got.idx.numpy()[v], np.asarray(want.idx)[v])
    np.testing.assert_array_equal(got.dist.numpy()[v], np.asarray(want.dist)[v])
    assert v.sum() > 20


def _node_inputs(rng, n, m, nodes):
    """Targets with vocabulary nodes in [0, nodes), sources that resemble
    them with the same node (a tenth with node -1), 5 % invalid on each
    side, duplicate targets (ties); nodes = 1: every node 0."""
    desc_b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    desc_b[m // 2: m // 2 + 20] = desc_b[:20]
    node_b = rng.integers(0, nodes, m).astype(np.int32)
    src = rng.integers(0, m, n)
    desc_a = desc_b[src] ^ (rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32) & np.uint32(0x00100010))
    node_a = np.where(rng.random(n) < 0.1, -1, node_b[src]).astype(np.int32)
    return (node_a, desc_a, rng.random(n) < 0.95, rng.uniform(0, 360, n).astype(np.float32),
            node_b, desc_b, rng.random(m) < 0.95, rng.uniform(0, 360, m).astype(np.float32))


@pytest.mark.parametrize("nodes", [1, 12])
def test_node_twin_equals_reference(nodes):
    node_a, desc_a, valid_a, angle_a, node_b, desc_b, valid_b, angle_b = args = \
        _node_inputs(np.random.default_rng(nodes), 200, 300, nodes)
    cand = (jnp.asarray(node_a)[:, None] == jnp.asarray(node_b)[None, :]) & \
        (jnp.asarray(node_a)[:, None] >= 0)
    cand = cand & jnp.asarray(valid_a)[:, None] & jnp.asarray(valid_b)[None, :]
    want = jm.best_two(jm.hamming_matrix(jnp.asarray(desc_a), jnp.asarray(desc_b)), cand)
    got = cm.node_best_two(*map(_t, (node_a, desc_a, valid_a, node_b, desc_b, valid_b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy()[node_a < 0] == BIG).all() and int((got[0] < 50).sum()) > 100
    want_m = jm.search_by_node(*map(jnp.asarray, args), nn_ratio=0.7, max_dist=100)
    got_m = tm.search_by_node(*map(_t, args), nn_ratio=0.7, max_dist=100)
    np.testing.assert_array_equal(got_m.valid.numpy(), np.asarray(want_m.valid))
    v = got_m.valid.numpy()
    np.testing.assert_array_equal(got_m.idx.numpy()[v], np.asarray(want_m.idx)[v])
    assert v.sum() > 20


def _take(k1, d2, lane, key, d, n):
    """bucket_search.cuh `take`: one candidate into a lane's state."""
    if key < k1[lane]:
        if k1[lane] != INT_MAX:
            d2[lane] = min(d2[lane], k1[lane] // n)
        k1[lane] = key
    else:
        d2[lane] = min(d2[lane], d)


def _warp_pair(k1, d2, n):
    """The two warp minimums: the least key, then the best's lane's
    second-least distance against every other lane's least key's."""
    K1 = int(k1.min())
    return K1, int(min(d2[i] if k1[i] == K1 else _key_dist(int(k1[i]), n) for i in range(32)))


def window_model(rng, uv, radius, level, ur, valid, desc, kp_xy, kp_level, kp_ur, kp_valid,
                 kp_desc, octaves, tile=None):
    """The window kernel's decisions on every row, its targets in tiles of
    `tile` columns (one tile when None, the kernel's untiled instance)."""
    m = kp_xy.shape[0]
    tile = m if tile is None else tile
    tiles = [(c0, min(c0 + tile, m), *_tile_buckets(rng, kp_xy, kp_level, kp_valid, c0,
                                                      min(c0 + tile, m)))
             for c0 in range(0, m, tile)]
    dist = _popcount(desc.view(np.uint32)[:, None, :] ^ kp_desc.view(np.uint32)[None, :, :])
    out = np.full(len(uv), BIG), np.zeros(len(uv), np.int64), np.full(len(uv), BIG)
    for row in range(len(uv)):
        if not valid[row]:
            continue
        u, v, r, sur = uv[row, 0], uv[row, 1], radius[row], ur[row]
        lo = -(1 << 40) if octaves[0] is cm.OPEN else int(level[row]) + octaves[0]
        hi = (1 << 40) if octaves[1] is cm.OPEN else int(level[row]) + octaves[1]
        carry = None
        for c0, c1, (inv, gx, gy, nl), off, cols in tiles:
            k1, d2 = np.full(32, INT_MAX, np.int64), np.full(32, BIG, np.int64)

            def visit(lane, col):
                kl, kur = int(kp_level[col]), kp_ur[col]
                if not kp_valid[col] or not (abs(u - kp_xy[col, 0]) < r) \
                        or not (abs(v - kp_xy[col, 1]) < r) or kl < lo or kl > hi:
                    return
                if sur >= 0 and kur >= 0 and not (abs(sur - kur) < r):
                    return
                _take(k1, d2, lane, int(dist[row, col]) * m + col, int(dist[row, col]), m)

            near = np.isfinite(r) and abs(u) + r < FAR_OUT and abs(v) + r < FAR_OUT
            if r > 0 and not near:
                for col in range(c0, c1):
                    visit((col - c0) % 32, col)
            elif r > 0:
                cx0, cx1 = max(_cell(u - r, inv, gx) - 1, 0), min(_cell(u + r, inv, gx) + 1, gx - 1)
                cy0, cy1 = max(_cell(v - r, inv, gy) - 1, 0), min(_cell(v + r, inv, gy) + 1, gy - 1)
                l0, l1 = _level(lo, nl), _level(hi, nl)
                ny = cy1 - cy0 + 1
                for sp in range((l1 - l0 + 1) * ny):
                    b0 = ((l0 + sp // ny) * gy + cy0 + sp % ny) * gx + cx0
                    for i in range(off[b0], off[b0 + cx1 - cx0 + 1]):
                        visit(sp % 32, cols[i])
            K1, D2 = _warp_pair(k1, d2, m)
            if carry is not None:                  # bucket_search.cuh `merge`
                D2 = min(D2, carry[1], _key_dist(max(K1, carry[0]), m))
                K1 = min(K1, carry[0])
            carry = (K1, D2)
        if carry[0] != INT_MAX:
            out[0][row], out[1][row], out[2][row] = carry[0] // m, carry[0] % m, carry[1]
    return out


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("seed,m,tile", [(0, 300, None), (1, 200, 64), (2, 130, 7)])
def test_window_model_equals_twin(seed, m, tile, rule):
    """The window kernel's order, in one tile and in tiles (N = 200 in tiles
    of 64; 130 in 19 tiles of 7), under each octave rule, with ties forced
    across tile borders and K5's adversarial rows (non-finite windows,
    r = 0, a window far out over every column): equal to the twin on every
    row; the forced ties give best == second."""
    rng = np.random.default_rng(seed)
    args = _inputs(rng, 120, m)
    forced = _tie_across_tiles(args, tile or m)
    got = window_model(rng, *args, RULES[rule], tile=tile)
    want = cm.window_best_two_plain(*map(_t, args), RULES[rule])
    for name, g, w in zip(("best", "idx", "second"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert (got[0][forced] == got[2][forced]).sum() >= len(forced) // 2
    assert (got[0] < BIG).sum() > 30


def node_model(node_a, desc_a, valid_a, node_b, desc_b, valid_b, tile):
    """The node kernel's decisions: per row (one warp) the targets in tiles
    of `tile` staged nodes (-1 where invalid), lanes striding over a tile's
    columns and keeping their state across tiles, two warp minimums."""
    n, m = len(node_a), len(node_b)
    staged = np.where(valid_b, node_b, -1)
    dist = _popcount(desc_a.view(np.uint32)[:, None, :] ^ desc_b.view(np.uint32)[None, :, :])
    out = np.full(n, BIG), np.zeros(n, np.int64), np.full(n, BIG)
    for row in range(n):
        if not (valid_a[row] and node_a[row] >= 0):
            continue
        k1, d2 = np.full(32, INT_MAX, np.int64), np.full(32, BIG, np.int64)
        for c0 in range(0, m, tile):
            for c in range(min(tile, m - c0)):
                if staged[c0 + c] == node_a[row]:
                    d = int(dist[row, c0 + c])
                    _take(k1, d2, c % 32, d * m + c0 + c, d, m)
        K1, D2 = _warp_pair(k1, d2, m)
        if K1 != INT_MAX:
            out[0][row], out[1][row], out[2][row] = K1 // m, K1 % m, D2
    return out


@pytest.mark.parametrize("nodes,tile", [(1, 2048), (1, 40), (5, 64)])
def test_node_model_equals_twin(nodes, tile):
    """The node kernel's order with every node 0 (one tile, and tiles of
    40) and with 5 nodes (tiles of 64): equal to the twin on every row,
    duplicate targets in other tiles giving ties."""
    args = _node_inputs(np.random.default_rng(10 + nodes), 120, 300, nodes)
    args = args[:3] + args[4:7]
    got = node_model(*args, tile)
    want = cm.node_best_two_plain(*map(_t, args))
    for name, g, w in zip(("best", "idx", "second"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert (got[0] == got[2]).sum() > 0 and (got[0] < BIG).sum() > 50
