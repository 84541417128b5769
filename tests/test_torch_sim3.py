"""The port's Sim3 geometry, Sim3 solvers and SearchBySim3
(`geometry/sim3.py`, `solvers/sim3_solver.py`, `ops/matching.search_by_sim3`)
against the JAX reference's on the same inputs, on the CPU.

Tolerances, and why: the Sim3 maps are float32 chains of a few dozen
operations in other orders (XLA fuses them), so transforms and points
agree to 2e-5 (measured within 3e-6); the closed-form fits take a 3x3 SVD
through another LAPACK, so their Sim3s agree to 1e-4 (the singular
vectors' signs may differ; the rotation they give may not). Integer
results are equal: RANSAC's inliers (the reference's draws handed in),
SearchBySim3's indices, distances and validity (K4's window-form twin
against the reference's dense `best_two`).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geometry import sim3 as jsim3
from orb_slam2_tpu.ops import matching as jmatching
from orb_slam2_tpu.solvers import sim3_solver as jsolver

from orb_slam2_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_tpu_torch.ops import matching as tmatching
from orb_slam2_tpu_torch.solvers import sim3_solver as tsolver
from orb_slam2_tpu_torch.utils import convert

from test_loop_closing import build_drifted_map

MAP_TOL = 2e-5
FIT_TOL = 1e-4
SIGMA2 = tuple(1.2 ** (2 * i) for i in range(8))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(tg, jg, tol):
    for f in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                   atol=tol, rtol=tol, err_msg=f)


def _zetas(rng, n):
    z = rng.normal(0, 0.6, (n, 7)).astype(np.float32)
    z[:4, 3:6] *= 1e-4          # the small-angle branches
    z[2:6, 6] *= 1e-6           # the small-scale branches
    z[:, 6] *= 0.3
    return z


def test_exp_log_round_trip_and_ops(rng):
    z = _zetas(rng, 32)
    tg, jg = tsim3.exp(_t(z)), jsim3.exp(jnp.asarray(z))
    _close(tg, jg, MAP_TOL)
    np.testing.assert_allclose(tsim3.log(tg).numpy(), np.asarray(jsim3.log(jg)), atol=1e-4)
    np.testing.assert_allclose(tsim3.log(tg).numpy(), z, atol=1e-4)      # round trip
    z2 = _zetas(rng, 32)
    th, jh = tsim3.exp(_t(z2)), jsim3.exp(jnp.asarray(z2))
    _close(tsim3.compose(tg, th), jsim3.compose(jg, jh), MAP_TOL)
    _close(tsim3.inverse(tg), jsim3.inverse(jg), MAP_TOL)
    p = rng.normal(0, 2, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(tsim3.apply(tg, _t(p)).numpy(),
                               np.asarray(jsim3.apply(jg, jnp.asarray(p))), atol=1e-4,
                               rtol=MAP_TOL)
    # g * g^-1 is the identity
    e = tsim3.compose(tg, tsim3.inverse(tg))
    np.testing.assert_allclose(e.R.numpy(), np.broadcast_to(np.eye(3), (32, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(e.s.numpy(), 1.0, atol=1e-5)


def _pairs(rng, n, s_true, noise):
    p2 = rng.uniform(-2, 2, (n, 3)).astype(np.float32) + np.float32([0, 0, 5])
    g = jsim3.exp(jnp.asarray(np.float32([0.2, -0.1, 0.3, 0.05, -0.1, 0.08, np.log(s_true)])))
    p1 = np.asarray(jsim3.apply(g, jnp.asarray(p2))) + rng.normal(0, noise, (n, 3))
    return p1.astype(np.float32), p2


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3(rng, fix_scale):
    p1, p2 = _pairs(rng, 40, 1.0 if fix_scale else 1.3, 0.01)
    w = (rng.uniform(size=40) > 0.2).astype(np.float32)
    for wt in (None, w):
        tg = tsolver.horn_sim3(_t(p2), _t(p1), fix_scale=fix_scale,
                               w=None if wt is None else _t(wt))
        jg = jsolver.horn_sim3(jnp.asarray(p2), jnp.asarray(p1), fix_scale=fix_scale,
                               w=None if wt is None else jnp.asarray(wt))
        _close(tg, jg, FIT_TOL)


def _ransac_case(rng, fix_scale):
    n = 96
    p1, p2 = _pairs(rng, n, 1.0 if fix_scale else 1.15, 0.002)
    p1[::7] += rng.normal(0, 0.5, (len(p1[::7]), 3)).astype(np.float32)    # outliers
    valid = rng.uniform(size=n) > 0.1
    lv1, lv2 = rng.integers(0, 3, n).astype(np.int32), rng.integers(0, 3, n).astype(np.int32)
    # a measured right x (u - bf / z) on about half the features
    ur1 = np.where(rng.uniform(size=n) > 0.5, 300 * p1[:, 0] / p1[:, 2] + 160 - 30 / p1[:, 2],
                   -1.0).astype(np.float32)
    ur2 = np.where(rng.uniform(size=n) > 0.5, 300 * p2[:, 0] / p2[:, 2] + 160 - 30 / p2[:, 2],
                   -1.0).astype(np.float32)
    return p1, p2, valid, lv1, lv2, ur1, ur2


@pytest.mark.parametrize("fix_scale", [False, True])
def test_ransac_sim3_with_the_reference_draws(rng, fix_scale):
    p1, p2, valid, lv1, lv2, ur1, ur2 = _ransac_case(rng, fix_scale)
    geom = (300.0, 300.0, 160.0, 120.0)
    key = jax.random.PRNGKey(7 * 977 + 3)
    jr = jsolver.ransac_sim3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(lv1),
                             jnp.asarray(lv2), jnp.asarray(valid), SIGMA2, *geom,
                             fix_scale=fix_scale, key=key, ur1=jnp.asarray(ur1),
                             ur2=jnp.asarray(ur2), bf=30.0)
    # the reference's draws: jax.random.randint over the valid count
    draws = jax.random.randint(key, (128, 3), 0, max(int(valid.sum()), 1))
    tr = tsolver.ransac_sim3(_t(p1), _t(p2), _t(lv1), _t(lv2), _t(valid), SIGMA2, *geom,
                             fix_scale=fix_scale, draws=_t(draws), ur1=_t(ur1), ur2=_t(ur2),
                             bf=30.0)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert int(tr.n_inliers) == int(jr.n_inliers) and bool(tr.ok) == bool(jr.ok)
    _close(tr.g12, jr.g12, FIT_TOL)
    assert int(tr.n_inliers) > 60


@pytest.mark.parametrize("fix_scale,stereo", [(False, False), (True, True)])
def test_optimize_sim3(rng, fix_scale, stereo):
    """Free scale, and fixed scale with the disparity channel, on a short
    schedule (2 + 3 steps: XLA compiles every unrolled step; compute_sim3's
    test in `test_torch_loop_closing.py` runs the reference's 5 + 10)."""
    iters = (2, 3)
    p1, p2, valid, lv1, lv2, ur1, ur2 = _ransac_case(rng, fix_scale)
    geom = (300.0, 300.0, 160.0, 120.0)
    uv1 = np.stack([300 * p1[:, 0] / p1[:, 2] + 160, 300 * p1[:, 1] / p1[:, 2] + 120], -1)
    uv2 = np.stack([300 * p2[:, 0] / p2[:, 2] + 160, 300 * p2[:, 1] / p2[:, 2] + 120], -1)
    uv1, uv2 = uv1.astype(np.float32), uv2.astype(np.float32)
    g0 = jsolver.horn_sim3(jnp.asarray(p2[valid]), jnp.asarray(p1[valid]), fix_scale=fix_scale)
    kw = dict(ur1=ur1, ur2=ur2, bf=30.0) if stereo else {}
    sched = dict(iters_a=iters[0], iters_b=iters[1])
    jg, jinl, jn = jsolver.optimize_sim3(
        g0, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(lv1), jnp.asarray(lv2), jnp.asarray(valid), SIGMA2, *geom,
        fix_scale=fix_scale, **sched,
        **{k: jnp.asarray(v) if k != "bf" else v for k, v in kw.items()})
    tg, tinl, tn = tsolver.optimize_sim3(
        convert.sim3_from_numpy(g0, "cpu"), _t(p1), _t(p2), _t(uv1), _t(uv2), _t(lv1),
        _t(lv2), _t(valid), SIGMA2, *geom, fix_scale=fix_scale, **sched,
        **{k: _t(v) if k != "bf" else v for k, v in kw.items()})
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) > 50
    _close(tg, jg, FIT_TOL)


def test_search_by_sim3_bit_exact(rng):
    """Both directions through K4's window-form twin (open octaves, no
    stereo test, z > 0 folded into validity) give the reference's dense
    search: indices, distances and validity equal."""
    c, m, kf0, kf1, Xw, drift_t = build_drifted_map(rng)
    P = m.capacity_pt
    gs = [jsim3.Sim3(jnp.eye(3), jnp.asarray(-drift_t, jnp.float32), jnp.float32(1.0)),
          jsim3.exp(jnp.asarray(np.float32([0.05, -0.02, 0.1, 0.01, 0.02, -0.01, 0.0]))),
          jsim3.exp(jnp.asarray(np.float32([0.3, 0.1, -3.0, 0.0, 0.0, 0.0, 0.1])))]
    for g in gs:
        args = []
        for k in (kf1, kf0):
            obs = np.asarray(m.kf_obs[k])
            pc = np.asarray(m.pt_pos)[np.clip(obs, 0, P - 1)] @ np.asarray(m.kf_pose[k])[:3, :3].T \
                + np.asarray(m.kf_pose[k])[:3, 3]
            ok = np.asarray(m.kf_feat_valid[k]) & (obs >= 0)
            args.append((pc.astype(np.float32), np.asarray(m.kf_xy[k]), np.asarray(m.kf_level[k]),
                         np.asarray(m.kf_desc[k]), ok))
        jm = jmatching.search_by_sim3(*[jnp.asarray(a) for a in args[0]],
                                      *[jnp.asarray(a) for a in args[1]], g, c.scale_factors,
                                      c.fx, c.fy, c.cx, c.cy)
        tk = [(_t(a[0]), _t(a[1]), _t(a[2]), _t(a[3].view(np.int32)), _t(a[4])) for a in args]
        mm = tmatching.search_by_sim3(*tk[0], *tk[1], convert.sim3_from_numpy(g, "cpu"),
                                      c.scale_factors, c.fx, c.fy, c.cx, c.cy)
        np.testing.assert_array_equal(mm.idx.numpy(), np.asarray(jm.idx))
        np.testing.assert_array_equal(mm.dist.numpy(), np.asarray(jm.dist))
        np.testing.assert_array_equal(mm.valid.numpy(), np.asarray(jm.valid))
    assert int(np.asarray(jm.valid).sum()) == 0      # the far transform matches nothing
