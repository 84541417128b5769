"""The twin of the port's epipolar match kernel K8
(`orb_slam2_tpu_torch/ops/cuda_match.epi_best_two_plain`) against the JAX
reference's two paths on the CPU: its Pallas kernel `epi_best_two_pallas`
(interpret mode) and the XLA candidate mask plus `fused_best_two` of
`mapping_ops._triangulate_decide:204-225`. Random inputs, B = 3
neighbours, N = 256 features, built so each row has a few features near its
epipolar line, some rows none and some targets bound.

Tolerance: bit-exact (best and index), except on rows where a candidate's
gate value sits within 1e-5 (relative, computed in float64) of its
threshold: there the float32 forms may round to opposite sides. The XLA
path and the twin share the form num*num/den < sig, the Pallas kernel
tests num*num < sig*den; each comparison excuses only its own boundary
rows, and the test checks that few rows are excused.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import matching as jmatching
from orb_slam2_tpu.ops import pallas_kernels as pk

from orb_slam2_tpu_torch.ops import cuda_match

B, N = 3, 256


def _inputs(seed):
    rng = np.random.default_rng(seed)
    desc1 = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    src = rng.integers(0, N, (B, N))
    flips = rng.integers(0, 2 ** 32, (B, N, 8), dtype=np.uint32) & \
        rng.integers(0, 2 ** 32, (B, N, 8), dtype=np.uint32) & \
        rng.integers(0, 2 ** 32, (B, N, 8), dtype=np.uint32)       # ~1/8 of the bits
    desc2 = desc1[src] ^ flips
    xy2 = np.stack([rng.uniform(0, 640, (B, N)), rng.uniform(0, 480, (B, N))], -1)
    ang = rng.uniform(0, np.pi, (B, N))
    la, lb = np.cos(ang), np.sin(ang)
    # each line passes near the target of one feature of the neighbour
    j0 = rng.integers(0, N, (B, N))
    x0 = np.take_along_axis(xy2[..., 0], j0, 1)
    y0 = np.take_along_axis(xy2[..., 1], j0, 1)
    lc = -(la * x0 + lb * y0) + rng.normal(0, 1.5, (B, N))
    for b in range(B):                  # ... and that target resembles the feature
        desc2[b, j0[b]] = desc1 ^ flips[b]
    scale = rng.uniform(0.01, 100.0, (B, N))                  # F's arbitrary scale
    lvl = rng.integers(0, 8, (B, N))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(desc1=desc1, un1=rng.random(N) < 0.8, la=f32(la * scale), lb=f32(lb * scale),
                lc=f32(lc * scale), desc2=desc2, xy2=f32(xy2), un2=rng.random((B, N)) < 0.8,
                sig=f32(np.float32(3.84) * f32(1.44 ** lvl)), far=rng.random((B, N)) < 0.9)


@jax.jit
def _xla_path(desc1, un1, la, lb, lc, desc2, xy2, un2, sig, far):
    def one(la, lb, lc, desc2, xy2, un2, sig, far):
        num = la[:, None] * xy2[None, :, 0] + lb[:, None] * xy2[None, :, 1] + lc[:, None]
        den = jnp.maximum(la * la + lb * lb, 1e-12)[:, None]
        cand = un1[:, None] & un2[None, :] & (num * num / den < sig[None, :]) & far[None, :]
        best, idx, _ = jmatching.fused_best_two(desc1, desc2, cand, False)
        return best, idx
    return jax.vmap(one)(la, lb, lc, desc2, xy2, un2, sig, far)


def _boundary_rows(a, pallas_form: bool):
    """(B,N) bool: rows with a live candidate whose gate value is within
    1e-5 of the threshold, in float64."""
    la, lb, lc = (a[k].astype(np.float64)[:, :, None] for k in ("la", "lb", "lc"))
    x2, y2 = (a["xy2"][..., c].astype(np.float64)[:, None, :] for c in (0, 1))
    num2 = (la * x2 + lb * y2 + lc) ** 2
    den = np.maximum(la * la + lb * lb, 1e-12)
    sig = a["sig"].astype(np.float64)[:, None, :]
    lhs, rhs = (num2, sig * den) if pallas_form else (num2 / den, sig)
    near = np.abs(lhs - rhs) <= 1e-5 * rhs
    live = a["un1"][None, :, None] & a["un2"][:, None, :] & a["far"][:, None, :]
    return (near & live).any(-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epi_best_two_twin_matches_reference(seed):
    a = _inputs(seed)
    t = {k: torch.from_numpy(np.ascontiguousarray(v.view(np.int32) if v.dtype == np.uint32
                                                  else v)) for k, v in a.items()}
    order = ("desc1", "un1", "la", "lb", "lc", "desc2", "xy2", "un2", "sig", "far")
    got = [g.numpy() for g in cuda_match.epi_best_two_plain(*(t[k] for k in order))]
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    hit = got[0] < cuda_match.BIG
    assert 0.2 * B * N < hit.sum() < B * N and (got[0] <= 50).sum() > 50
    # a row with no candidate: BIG at column 0, as both reference paths give
    assert (got[1][~hit] == 0).all()
    jargs = [jnp.asarray(a[k]) for k in order]
    for want, pallas_form in ((pk.epi_best_two_pallas(*jargs, interpret=True), True),
                              (_xla_path(*jargs), False)):
        excused = _boundary_rows(a, pallas_form)
        assert excused.sum() <= 0.01 * B * N
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[~excused], np.asarray(w)[~excused])


def test_epi_best_two_cpu_wrapper_is_the_twin():
    """The event's K8 wrapper (`epi_match_keyframes`) on CPU tensors runs its
    twin, whose search is `epi_best_two_plain` on the rows it gathers from
    the map: kf1's row, each neighbour's row, lines F [x1; 1]."""
    rng = np.random.default_rng(5)
    k, levels = 4, 8
    obs = np.where(rng.random((k, N)) < 0.5, -1, rng.integers(0, 100, (k, N))).astype(np.int32)
    xy = np.stack([rng.uniform(0, 640, (k, N)), rng.uniform(0, 480, (k, N))], -1)
    desc = rng.integers(0, 2 ** 32, (k, N, 8), dtype=np.uint32).view(np.int32)
    level = rng.integers(-1, levels + 1, (k, N)).astype(np.int32)
    f = rng.normal(0, 1e-3, (3, 3, 3)).astype(np.float32)
    f[..., 2, 2] = rng.normal(0, 1, 3)
    epi = rng.uniform(0, 640, (3, 2)).astype(np.float32)
    sig2 = tuple(1.2 ** (2 * i) for i in range(levels))
    sf = tuple(1.2 ** i for i in range(levels))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (t(obs), t(rng.random((k, N)) < 0.9), t(xy.astype(np.float32)), t(desc), t(level),
            torch.tensor(2), torch.tensor([0, 3, 1]), t(f), t(epi), sig2, sf)
    got = cuda_match.epi_match_keyframes(*args)
    want = cuda_match.epi_match_keyframes_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    x1 = args[2][2]
    line = [t(f)[:, r, 0, None] * x1[None, :, 0] + t(f)[:, r, 1, None] * x1[None, :, 1]
            + t(f)[:, r, 2, None] for r in range(3)]
    kf2 = args[6]
    lvl = torch.clamp(args[4][kf2], 0, levels - 1).long()
    d = args[2][kf2] - t(epi)[:, None, :]
    rows = cuda_match.epi_best_two_plain(
        args[3][2], (args[0][2] < 0) & args[1][2], *line, args[3][kf2], args[2][kf2],
        (args[0][kf2] < 0) & args[1][kf2], 3.84 * torch.tensor(sig2, dtype=torch.float32)[lvl],
        d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        >= 100.0 * torch.tensor(sf, dtype=torch.float32)[lvl])
    for g, w in zip(got, rows):
        assert torch.equal(g, w)
    assert int((got[0] < cuda_match.BIG).sum()) > 10
