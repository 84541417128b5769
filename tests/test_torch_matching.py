"""The port's descriptor matching (`orb_slam2_tpu_torch/ops/matching.py`)
and the twins of the K4 and K5 kernels (`ops/cuda_match.py`) against the JAX
reference on the CPU. Inputs come from a seed with numpy and go to both
packages. Every comparison here is bit-exact: the outputs are integers and
flags decided by exact integer and float compares on the same inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import matching as jm
from orb_slam2_tpu.ops import pallas_kernels as pk

from orb_slam2_tpu_torch.ops import cuda_match as cm
from orb_slam2_tpu_torch.ops import launch
from orb_slam2_tpu_torch.ops import matching as tm

torch.set_num_threads(1)
SF = [1.2 ** i for i in range(8)]


def _t(a):
    """numpy -> torch, descriptors (uint32) as their int32 view."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _flip(rng, desc, max_bits):
    """Copies of desc with up to max_bits random bits flipped per row."""
    out = desc.copy()
    bits = out.view(np.uint8).reshape(len(out), 32)
    for i in range(len(out)):
        for b in rng.integers(0, 256, rng.integers(0, max_bits + 1)):
            bits[i, b // 8] ^= np.uint8(1 << (b % 8))
    return out


def test_popcount32_matches_unpackbits_on_every_bit_pattern():
    rng = np.random.default_rng(0)
    words = np.concatenate([rng.integers(0, 2 ** 32, 4000, dtype=np.uint32),
                            np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1,
                                      0x80000001, 0xAAAAAAAA, 0x55555555], np.uint32)])
    assert (words >= 2 ** 31).sum() > 1000          # top bit set: negative int32
    want = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(1)
    _eq(cm.popcount32(_t(words)), want)


@pytest.mark.parametrize("n,m", [(200, 300), (37, 129)])
def test_hamming_matrix_and_best_two_bit_exact(n, m):
    rng = np.random.default_rng(n)
    a, b = _desc(rng, n), _desc(rng, m)
    b[:5] = a[:5]                                  # distance 0 as well
    want = jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
    got = tm.hamming_matrix(_t(a), _t(b))
    assert got.dtype == torch.int32
    _eq(got, want)
    # ties: quantized distances so equal minima are common
    dist = (np.asarray(want) // 16).astype(np.int32)
    mask = rng.random((n, m)) < 0.3
    mask[3] = False                                # a row masked everywhere
    for g, w in zip(tm.best_two(_t(dist), _t(mask)),
                    jm.best_two(jnp.asarray(dist), jnp.asarray(mask))):
        _eq(g, w)


def test_resolve_conflicts_bit_exact():
    rng = np.random.default_rng(1)
    n, n_t = 300, 40                               # many sources per target
    idx = rng.integers(0, n_t, n).astype(np.int32)
    dist = rng.integers(0, 6, n).astype(np.int32)  # ties on distance
    accept = rng.random(n) < 0.7
    want = jm.resolve_conflicts(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(accept), n_t)
    _eq(tm.resolve_conflicts(_t(idx), _t(dist), _t(accept), n_t), want)


@pytest.mark.parametrize("counts", [(9, 9, 9, 4), (12, 5, 5, 5, 1), (7, 7, 0, 0)])
def test_rotation_consistency_with_tied_bins(counts):
    """Histogram ties decide which bins survive: the lower bin index wins,
    as `lax.top_k` orders them."""
    rng = np.random.default_rng(sum(counts))
    bins = np.concatenate([np.full(c, b * 5 + 2) for b, c in enumerate(counts)])
    n = len(bins) + 10
    rot = np.concatenate([bins * 12.0, rng.uniform(0, 360, 10)]).astype(np.float32)
    angle_dst = rng.uniform(0, 360, 64).astype(np.float32)
    best_idx = rng.integers(0, 64, n).astype(np.int32)
    angle_src = np.mod(angle_dst[best_idx] + rot, 360.0).astype(np.float32)
    matched = np.ones(n, bool)
    matched[-10:] = rng.random(10) < 0.5
    want = jm.rotation_consistency(jnp.asarray(angle_src), jnp.asarray(angle_dst),
                                   jnp.asarray(matched), jnp.asarray(best_idx))
    got = tm.rotation_consistency(_t(angle_src), _t(angle_dst), _t(matched), _t(best_idx))
    _eq(got, want)
    assert 0 < int(got.sum()) < n


class TestMaskedBestTwoTwin:
    """The spec of K4's reduction against the Pallas kernel (interpret
    mode) and the XLA path (after tests/test_pallas_kernels.py:9-36)."""

    def _check(self, rng, n, m, density):
        a, b = _desc(rng, n), _desc(rng, m)
        b[: min(n, m) // 4] = _flip(rng, a[: min(n, m) // 4], 12)
        mask = rng.random((n, m)) < density
        mask[::17] = False                        # rows masked everywhere
        want_pallas = pk.masked_best_two_pallas(jnp.asarray(a), jnp.asarray(b),
                                                jnp.asarray(mask), interpret=True)
        want_xla = jm.best_two(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)),
                               jnp.asarray(mask))
        got = cm.masked_best_two_plain(_t(a), _t(b), _t(mask))
        for g, wp, wx in zip(got, want_pallas, want_xla):
            assert g.dtype == torch.int32
            _eq(g, wp)
            _eq(g, wx)
        assert int(got[0][0]) == jm.BIG and int(got[1][0]) == 0

    @pytest.mark.parametrize("n,m,density", [(200, 300, 0.3), (130, 256, 0.5), (5, 1, 1.0)])
    def test_bit_exact(self, n, m, density):
        self._check(np.random.default_rng(n * m), n, m, density)


class TestProjectionBestTwoTwin:
    """The K5 twin against `projection_best_two_pallas` (interpret mode),
    bit-exact (after tests/test_pallas_kernels.py:41-92)."""

    def _inputs(self, rng, P, N):
        kp_xy = rng.uniform(0, 640, (N, 2)).astype(np.float32)
        kp_level = rng.integers(0, 8, N).astype(np.int32)
        kp_ur = np.where(rng.random(N) < 0.5, kp_xy[:, 0] - rng.uniform(1, 30, N),
                         -1.0).astype(np.float32)
        kp_valid = rng.random(N) < 0.9
        kp_desc = _desc(rng, N)
        src = rng.integers(0, N, P)                # sources near real keypoints
        uv = (kp_xy[src] + rng.normal(0, 6, (P, 2))).astype(np.float32)
        radius = rng.uniform(5, 60, P).astype(np.float32)
        pred = np.clip(kp_level[src] + rng.integers(0, 2, P), 0, 7).astype(np.int32)
        p_ur = np.where(rng.random(P) < 0.5, uv[:, 0] - rng.uniform(1, 30, P),
                        -1.0).astype(np.float32)
        p_valid = rng.random(P) < 0.8
        p_desc = _flip(rng, kp_desc[src], 40)
        return (uv, radius, pred, p_ur, p_valid, p_desc,
                kp_xy, kp_level, kp_ur, kp_valid, kp_desc)

    @pytest.mark.parametrize("P,N", [(200, 256), (300, 100)])
    def test_bit_exact(self, P, N):
        args = self._inputs(np.random.default_rng(P + N), P, N)
        want = pk.projection_best_two_pallas(*[jnp.asarray(a) for a in args],
                                             interpret=True)
        got = cm.projection_best_two(*[_t(a) for a in args])
        for g, w in zip(got, want):
            _eq(g, w)
        assert int((got[0] < 100).sum()) > P // 4   # real matches were tested
        assert int((got[2] < jm.BIG).sum()) > 0     # and level-aware seconds


def _frame_pair(rng, n_src, n_kp):
    """A last frame's projected keypoints and the current frame's, with
    true correspondences: close pixels, similar descriptors and angles."""
    kp_xy = rng.uniform(0, 320, (n_kp, 2)).astype(np.float32)
    kp_level = rng.integers(0, 8, n_kp).astype(np.int32)
    kp_desc = _desc(rng, n_kp)
    kp_angle = rng.uniform(0, 360, n_kp).astype(np.float32)
    kp_ur = np.where(rng.random(n_kp) < 0.6, kp_xy[:, 0] - rng.uniform(2, 20, n_kp),
                     -1.0).astype(np.float32)
    kp_valid = rng.random(n_kp) < 0.95
    src = rng.integers(0, n_kp, n_src)
    uv = (kp_xy[src] + rng.normal(0, 2.0, (n_src, 2))).astype(np.float32)
    level = np.clip(kp_level[src] + rng.integers(-1, 2, n_src), 0, 7).astype(np.int32)
    desc = _flip(rng, kp_desc[src], 60)
    angle = np.mod(kp_angle[src] + rng.normal(20.0, 4.0, n_src), 360).astype(np.float32)
    ur = np.where(kp_ur[src] >= 0, kp_ur[src] + rng.normal(0, 1.0, n_src),
                  -1.0).astype(np.float32)
    valid = rng.random(n_src) < 0.9
    return (uv, level, desc, valid, angle, ur), \
        (kp_xy, kp_level, kp_desc, kp_valid, kp_angle, kp_ur)


def _matches_equal(got, want):
    _eq(got.valid, want.valid)
    v = got.valid.numpy()
    _eq(got.idx.numpy()[v], np.asarray(want.idx)[v])
    _eq(got.dist.numpy()[v], np.asarray(want.dist)[v])
    assert v.sum() > 20                            # real matches were compared


@pytest.mark.parametrize("th,check_rotation", [(7.0, True), (14.0, False)])
def test_search_by_projection_frame_bit_exact(th, check_rotation):
    rng = np.random.default_rng(int(th))
    s, k = _frame_pair(rng, 300, 256)
    want = jm.search_by_projection_frame(*map(jnp.asarray, s), *map(jnp.asarray, k),
                                         SF, th, forward=False, backward=False,
                                         check_rotation=check_rotation)
    got = tm.search_by_projection_frame(*map(_t, s), *map(_t, k), SF, th,
                                        forward=False, backward=False,
                                        check_rotation=check_rotation)
    _matches_equal(got, want)


def test_search_by_projection_points_bit_exact():
    rng = np.random.default_rng(5)
    (uv, level, desc, valid, _, ur), (kp_xy, kp_level, kp_desc, kp_valid, _, kp_ur) = \
        _frame_pair(rng, 400, 256)
    view_cos = rng.uniform(0.9, 1.0, 400).astype(np.float32)
    already = rng.random(256) < 0.1
    args_np = (uv, level, view_cos, desc, valid, ur, kp_xy, kp_level, kp_desc,
               kp_valid, kp_ur)
    want = jm.search_by_projection_points(*map(jnp.asarray, args_np), SF, th=3.0,
                                          nn_ratio=0.8, already_matched=jnp.asarray(already))
    got = tm.search_by_projection_points(*map(_t, args_np), SF, th=3.0, nn_ratio=0.8,
                                         already_matched=_t(already))
    _matches_equal(got, want)


def test_search_by_node_bit_exact():
    rng = np.random.default_rng(6)
    n = 256
    desc_b = _desc(rng, n)
    angle_b = rng.uniform(0, 360, n).astype(np.float32)
    node_b = rng.integers(0, 12, n).astype(np.int32)
    src = rng.permutation(n)                       # feature i of a sees src[i] of b
    desc_a = _flip(rng, desc_b[src], 40)
    angle_a = np.mod(angle_b[src] + rng.normal(15.0, 3.0, n), 360).astype(np.float32)
    node_a = np.where(rng.random(n) < 0.1, -1, node_b[src]).astype(np.int32)
    valid_a, valid_b = rng.random(n) < 0.95, rng.random(n) < 0.95
    args_np = (node_a, desc_a, valid_a, angle_a, node_b, desc_b, valid_b, angle_b)
    for max_dist in (50, 100):
        want = jm.search_by_node(*map(jnp.asarray, args_np), nn_ratio=0.7,
                                 max_dist=max_dist)
        got = tm.search_by_node(*map(_t, args_np), nn_ratio=0.7, max_dist=max_dist)
        _matches_equal(got, want)


def test_cpu_tensors_run_the_twins_without_launching():
    rng = np.random.default_rng(7)
    launch.reset_launches()
    a, b = _t(_desc(rng, 8)), _t(_desc(rng, 9))
    node_a, node_b = torch.zeros(8, dtype=torch.int32), torch.zeros(9, dtype=torch.int32)
    ok_a, ok_b = torch.ones(8, dtype=torch.bool), torch.ones(9, dtype=torch.bool)
    got = cm.node_best_two(node_a, a, ok_a, node_b, b, ok_b)
    want = cm.masked_best_two_plain(a, b, torch.ones((8, 9), dtype=torch.bool))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    xy = torch.zeros((9, 2))
    window = (xy[:8], torch.full((8,), 5.0), node_a, -ok_a.float(), ok_a, a,
              xy, node_b, -ok_b.float(), ok_b, b, (-1, 1))
    got = cm.window_best_two(*window)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not any(launch.LAUNCHES.values())
    with pytest.raises(ValueError):
        cm.node_best_two(node_a.to("meta"), a.to("meta"), ok_a.to("meta"), node_b.to("meta"),
                         b.to("meta"), ok_b.to("meta"))
