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
    a = _inputs(5)
    t = [torch.from_numpy(np.ascontiguousarray(v.view(np.int32) if v.dtype == np.uint32
                                               else v)) for v in a.values()]
    for g, w in zip(cuda_match.epi_best_two(*t), cuda_match.epi_best_two_plain(*t)):
        assert torch.equal(g, w)
