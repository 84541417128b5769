"""The port's SE3 algebra, reprojection edges and motion-only BA
(`orb_slam2_tpu_torch/geometry/se3.py`, `solvers/reproj.py`,
`solvers/pose_opt.py`) and the twins of the K6 and K7 kernels
(`ops/cuda_pose.py`) against the JAX reference on the CPU. Scenes come from
a seed with numpy (after tests/test_pose_opt.py) and go to both packages.

Tolerances, and why:
- se3 and reproj: 1e-6 relative (float32 ops in another order);
- optimize_pose (the K6 twin) against the reference's XLA schedule: Tcw
  within 1e-4 per entry; the solvers differ only in LU rounding and the
  order of the normal-equation sums;
- the K6 twin against `pose_lm_pallas` (interpret mode): 1e-3, the
  reference's own bound between its XLA and Pallas paths
  (tests/test_pose_opt.py:149-159), whose kernel takes Cholesky steps;
- the K7 twin against `pose_normal_eqs_pallas` (interpret mode): H rtol 3e-4
  atol 2e-3, b atol 2e-2, err rtol 3e-4, the reference's own
  (tests/test_pallas_kernels.py:164-168).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geometry import camera as jcamera
from orb_slam2_tpu.geometry import se3 as jse3
from orb_slam2_tpu.ops import pallas_kernels as pk
from orb_slam2_tpu.solvers import pose_opt as jpose
from orb_slam2_tpu.solvers import reproj as jreproj

from orb_slam2_tpu_torch.geometry import camera as tcamera
from orb_slam2_tpu_torch.geometry import se3 as tse3
from orb_slam2_tpu_torch.ops import cuda_pose, launch
from orb_slam2_tpu_torch.solvers import pose_opt as tpose
from orb_slam2_tpu_torch.solvers import reproj as treproj

torch.set_num_threads(1)
LEVEL_SIGMA2 = [1.2 ** (2 * i) for i in range(8)]


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


def _close(got, want, rtol=1e-6, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _cams(bf):
    return (jcamera.Camera.make(500.0, 500.0, 320.0, 240.0, bf=bf),
            tcamera.Camera.make(500.0, 500.0, 320.0, 240.0, bf=bf, device="cpu"))


def make_scene(rng, n=256, stereo=False, bf=40.0, outliers=0.0):
    """World points, (u, v, uR) observations at a known pose, mixed octaves;
    a share of the observations moved by 20-80 px."""
    Xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(4, 15, n)], -1).astype(np.float32)
    xi = np.array([0.1, -0.05, 0.08, 0.02, -0.03, 0.01], np.float32)
    T_true = np.asarray(jse3.exp(jnp.asarray(xi)))
    pc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
    u = 500.0 * pc[:, 0] / pc[:, 2] + 320.0
    v = 500.0 * pc[:, 1] / pc[:, 2] + 240.0
    ur = u - bf / pc[:, 2] if stereo else -np.ones(n)
    if stereo:                                      # a few mono edges as well
        ur = np.where(rng.random(n) < 0.2, -1.0, ur)
    obs = np.stack([u, v, ur], -1).astype(np.float32)
    k = int(outliers * n)
    obs[:k, :2] += (rng.uniform(20, 80, (k, 2)) * rng.choice([-1, 1], (k, 2))).astype(np.float32)
    obs[k:, :2] += rng.normal(0, 0.5, (n - k, 2)).astype(np.float32)
    level = rng.integers(0, 8, n).astype(np.int32)
    T0 = np.asarray(jse3.retract(jnp.asarray(T_true),
                                 jnp.asarray([0.1, -0.08, 0.05, 0.03, -0.02, 0.04])))
    return Xw, obs, level, T_true.astype(np.float32), T0.astype(np.float32)


def test_se3_matches_reference():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (64, 6)).astype(np.float32)
    xi[:4, 3:] = 0.0                               # the small-angle branch
    xi[4:8, 3:] *= 1e-7
    _close(tse3.exp(_t(xi)), jse3.exp(jnp.asarray(xi)), atol=1e-6)
    _close(tse3.so3_exp(_t(xi[:, 3:])), jse3.so3_exp(jnp.asarray(xi[:, 3:])), atol=1e-6)
    _close(tse3.hat(_t(xi[:, :3])), jse3.hat(jnp.asarray(xi[:, :3])))
    T = np.array(jse3.exp(jnp.asarray(xi)))
    T[:, :3, :3] *= 1.0 + rng.normal(0, 1e-3, (64, 3, 3)).astype(np.float32)  # off SO(3)
    p = rng.normal(0, 3, (64, 3)).astype(np.float32)
    for name in ("inverse", "orthonormalize"):
        _close(getattr(tse3, name)(_t(T)), getattr(jse3, name)(jnp.asarray(T)), atol=1e-6)
    _close(tse3.apply(_t(T), _t(p)), jse3.apply(jnp.asarray(T), jnp.asarray(p)), atol=1e-5)
    _close(tse3.retract(_t(T), _t(xi)), jse3.retract(jnp.asarray(T), jnp.asarray(xi)), atol=1e-5)
    _close(tse3.make(_t(T[:, :3, :3]), _t(p)), jse3.make(jnp.asarray(T[:, :3, :3]), jnp.asarray(p)))
    assert torch.equal(tse3.rotation(_t(T)), _t(T[:, :3, :3]))
    assert torch.equal(tse3.translation(_t(T)), _t(T[:, :3, 3]))


def test_reproj_matches_reference():
    rng = np.random.default_rng(1)
    jcam, tcam = _cams(40.0)
    Xw, obs, level, T, _ = make_scene(rng, n=128, stereo=True)
    Xw[:4, 2] = -1.0                               # behind the camera: z clamped
    st = obs[:, 2] >= 0
    ej, pcj, cwj = jreproj.project_residual(jcam, jnp.asarray(T), jnp.asarray(Xw),
                                            jnp.asarray(obs), jnp.asarray(st))
    et, pct, cwt = treproj.project_residual(tcam, _t(T), _t(Xw), _t(obs), _t(st))
    _close(pct, pcj, atol=1e-5)
    assert torch.equal(cwt, _t(np.asarray(cwj)))
    front = np.asarray(pcj)[:, 2] > 0
    _close(et[front], np.asarray(ej)[front], rtol=1e-5, atol=2e-3)
    Jj, Pj = jreproj.pose_point_jacobians(jcam, jnp.asarray(T), pcj)
    Jt, Pt = treproj.pose_point_jacobians(tcam, _t(T), _t(np.asarray(pcj)))
    _close(Jt[front], np.asarray(Jj)[front], rtol=1e-6, atol=1e-6)
    _close(Pt[front], np.asarray(Pj)[front], rtol=1e-6, atol=1e-6)
    inv_s2 = (1.0 / np.asarray(LEVEL_SIGMA2, np.float32)[level]).astype(np.float32)
    chi2_j = jreproj.edge_chi2(ej, cwj, jnp.asarray(inv_s2))
    chi2_t = treproj.edge_chi2(_t(np.asarray(ej)), cwt, _t(inv_s2))
    _close(chi2_t, chi2_j)
    d2 = np.where(st, jreproj.CHI2_STEREO, jreproj.CHI2_MONO).astype(np.float32)
    _close(treproj.huber_weight(chi2_t, _t(d2)),
           jreproj.huber_weight(chi2_j, jnp.asarray(d2)))


def _both(jcam, tcam, Xw, obs, level, T0, valid=None):
    valid = np.ones(len(Xw), bool) if valid is None else valid
    ref = jpose.optimize_pose(jcam, jnp.asarray(T0), jnp.asarray(Xw), jnp.asarray(obs),
                              jnp.asarray(level), jnp.asarray(valid), LEVEL_SIGMA2)
    got = tpose.optimize_pose(tcam, _t(T0), _t(Xw), _t(obs), _t(level), _t(valid),
                              LEVEL_SIGMA2)
    return ref, got


@pytest.mark.parametrize("stereo,outliers", [(False, 0.0), (True, 0.0), (True, 0.2),
                                             (False, 0.2)])
def test_optimize_pose_matches_xla_schedule(stereo, outliers):
    rng = np.random.default_rng(10 * stereo + int(outliers * 10))
    jcam, tcam = _cams(40.0 if stereo else 0.0)
    Xw, obs, level, T_true, T0 = make_scene(rng, stereo=stereo, outliers=outliers)
    valid = rng.random(len(Xw)) < 0.95
    ref, got = _both(jcam, tcam, Xw, obs, level, T0, valid)
    _close(got.Tcw, ref.Tcw, rtol=0, atol=1e-4)
    _close(got.Tcw, T_true, rtol=0, atol=2e-2)     # 0.5 px noise on every edge
    n_ref = int(ref.n_inliers)
    assert got.n_inliers.dtype == torch.int32 and got.inliers.dtype == torch.bool
    # the inlier sets agree except where chi2 sits at the threshold
    d2 = np.where(obs[:, 2] >= 0, jreproj.CHI2_STEREO, jreproj.CHI2_MONO)
    chi2 = np.asarray(ref.chi2)
    edge = np.abs(chi2 - d2) <= 1e-3 * d2
    differ = got.inliers.numpy() != np.asarray(ref.inliers)
    assert not (differ & ~edge).any()
    assert abs(int(got.n_inliers) - n_ref) <= int(edge.sum())
    k = int(outliers * len(Xw))
    assert not got.inliers.numpy()[:k].any()      # every outlier rejected
    _close(got.chi2[got.inliers], chi2[got.inliers.numpy()], rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("stereo", [False, True])
def test_pose_lm_twin_matches_pallas_kernel(stereo):
    """The K6 twin against the one-launch Pallas kernel in interpret mode,
    on a shortened schedule (3 rounds of 2 iterations: it still crosses the
    robust-to-plain switch and two reclassifications; interpret mode
    traces every unrolled step, and 4 x 10 takes minutes to trace)."""
    rng = np.random.default_rng(20 + stereo)
    jcam, tcam = _cams(40.0 if stereo else 0.0)
    Xw, obs, level, T_true, T0 = make_scene(rng, stereo=stereo, outliers=0.125)
    n = len(Xw)
    inv_s2 = (1.0 / np.asarray(LEVEL_SIGMA2, np.float32)[level]).astype(np.float32)
    st = obs[:, 2] >= 0
    T0o = np.asarray(jse3.orthonormalize(jnp.asarray(T0)))
    Tk, inl_k, n_k, _ = pk.pose_lm_pallas(
        jnp.asarray(T0o), jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.bf,
        jnp.asarray(Xw.T), jnp.asarray(obs.T), jnp.asarray(inv_s2)[None],
        jnp.asarray(st, jnp.float32)[None], jnp.ones((1, n), jnp.float32),
        jnp.float32(jreproj.CHI2_MONO), jnp.float32(jreproj.CHI2_STEREO),
        n_rounds=3, n_iters=2, interpret=True)
    launch.reset_launches()
    T, inl, n_inl, _ = cuda_pose.pose_lm(tcam, _t(T0o), _t(Xw), _t(obs), _t(inv_s2),
                                         _t(st), torch.ones(n, dtype=torch.bool), 3, 2)
    assert not any(launch.LAUNCHES.values())      # a CPU tensor ran the twin
    _close(T, Tk, rtol=0, atol=1e-3)
    assert abs(int(n_inl) - int(n_k)) <= 2


def test_pose_lm_twin_rejects_nan_steps_like_pallas_kernel():
    """A valid edge with a NaN world point makes every sweep's err NaN
    (0 * NaN): the reference kernel rejects every step and keeps its seed,
    and so does the K6 twin; the K7 twin's err is NaN there, as the
    reference kernel's is."""
    rng = np.random.default_rng(25)
    jcam, tcam = _cams(40.0)
    Xw, obs, level, _, T0 = make_scene(rng, stereo=True)
    Xw[5] = np.nan
    n = len(Xw)
    inv_s2 = (1.0 / np.asarray(LEVEL_SIGMA2, np.float32)[level]).astype(np.float32)
    st = obs[:, 2] >= 0
    T0o = np.asarray(jse3.orthonormalize(jnp.asarray(T0)))
    jargs = (jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.bf, jnp.asarray(Xw.T),
             jnp.asarray(obs.T), jnp.asarray(inv_s2)[None])
    d2 = (jnp.float32(jreproj.CHI2_MONO), jnp.float32(jreproj.CHI2_STEREO))
    Tk, inl_k, _, _ = pk.pose_lm_pallas(
        jnp.asarray(T0o), *jargs, jnp.asarray(st, jnp.float32)[None],
        jnp.ones((1, n), jnp.float32), *d2, n_rounds=2, n_iters=2, interpret=True)
    T, inl, _, _ = cuda_pose.pose_lm(tcam, _t(T0o), _t(Xw), _t(obs), _t(inv_s2), _t(st),
                                     torch.ones(n, dtype=torch.bool), 2, 2)
    assert np.array_equal(np.asarray(Tk)[:3], T0o[:3]) and torch.equal(T[:3], _t(T0o)[:3])
    assert np.array_equal(inl.numpy(), np.asarray(inl_k)) and not bool(inl[5])
    _, _, ek = pk.pose_normal_eqs_pallas(
        jnp.asarray(T0o), *jargs, jnp.ones((1, n), jnp.float32),
        jnp.asarray(st, jnp.float32)[None], *d2, robust=True, interpret=True)
    _, _, err = cuda_pose.pose_normal_eqs(tcam, _t(T0o), _t(Xw), _t(obs), _t(inv_s2),
                                          _t(st), torch.ones(n), True)
    assert np.isnan(float(ek)) and bool(err.isnan())


def test_pose_normal_eqs_twin_matches_pallas_kernel():
    """The K7 twin (the XLA build) against `pose_normal_eqs_pallas`, with
    behind-camera points whose Jacobian products overflow float32 unless the
    weight goes in first (after tests/test_pallas_kernels.py:124-168)."""
    rng = np.random.default_rng(30)
    E = 256
    jcam = jcamera.Camera.make(300.0, 300.0, 160.0, 120.0, 0, 0, 0, 0, 0, 30.0, 320, 240)
    tcam = tcamera.Camera.make(300.0, 300.0, 160.0, 120.0, 0, 0, 0, 0, 0, 30.0, 320, 240,
                               device="cpu")
    Xw = (rng.normal(0, 1.0, (E, 3)) + [0, 0, 5.0]).astype(np.float32)
    Xw[:8, 2] = -0.5
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.05, 0.2]
    pc = Xw @ T[:3, :3].T + T[:3, 3]
    u = 300.0 * pc[:, 0] / pc[:, 2] + 160.0
    v = 300.0 * pc[:, 1] / pc[:, 2] + 120.0
    stereo = rng.random(E) < 0.5
    obs = np.stack([u + rng.normal(0, 2, E), v + rng.normal(0, 2, E),
                    np.where(stereo, u - 30.0 / pc[:, 2] + rng.normal(0, 2, E), -1.0)],
                   -1).astype(np.float32)
    level = rng.integers(0, 8, E)
    inv_s2 = (1.0 / np.asarray(LEVEL_SIGMA2)[level]).astype(np.float32)
    mask = (rng.random(E) < 0.9).astype(np.float32)
    st = obs[:, 2] >= 0
    for robust in (True, False):
        Hk, bk, ek = pk.pose_normal_eqs_pallas(
            jnp.asarray(T), jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.bf,
            jnp.asarray(Xw.T), jnp.asarray(obs.T), jnp.asarray(inv_s2)[None],
            jnp.asarray(mask)[None], jnp.asarray(st, jnp.float32)[None],
            jnp.float32(jreproj.CHI2_MONO), jnp.float32(jreproj.CHI2_STEREO),
            robust=robust, interpret=True)
        H, b, err = cuda_pose.pose_normal_eqs(tcam, _t(T), _t(Xw), _t(obs), _t(inv_s2),
                                              _t(st), _t(mask), robust)
        assert bool(torch.isfinite(H).all())
        _close(H, Hk, rtol=3e-4, atol=2e-3)
        _close(b, bk, rtol=3e-4, atol=2e-2)
        _close(err, ek, rtol=3e-4)
        Hx, bx, ex = jpose._build_normal_eqs(
            jcam, jnp.asarray(T), jnp.asarray(Xw), jnp.asarray(obs), jnp.asarray(st),
            jnp.asarray(inv_s2), jnp.asarray(mask), robust)
        _close(H, Hx, rtol=3e-4, atol=2e-3)
        _close(b, bx, rtol=3e-4, atol=2e-2)
