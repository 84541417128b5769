"""The port's essential-graph solver and PCG bundle adjustment
(`solvers/pose_graph.py`, `solvers/pcg_ba.py`) against the JAX reference's
on the same problems, on the CPU.

Tolerances, and why: the pose graph's 20 Gauss-Newton steps take float32
Jacobians by forward-mode differentiation in other operation orders and
assemble H as J^T J where the reference scatters blocks, so the optimized
nodes part by up to ~1e-5 in R and s and 1e-4 m in t (held to 1e-4 and
5e-4); both must also pass the reference tests' own accuracy bars. PCG
runs 50 CG iterations a step on float32 matvecs summed in other orders,
so its poses are held to the reference's at 2e-4 and to the port's dense
Schur solve at the reference test's own 5e-3 against the truth.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geometry import se3 as jse3, sim3 as jsim3
from orb_slam2_tpu.solvers import pcg_ba as jpcg, pose_graph as jpg

from orb_slam2_tpu_torch.geometry.camera import Camera
from orb_slam2_tpu_torch.solvers import pcg_ba as tpcg, pose_graph as tpg, schur_ba as tsb
from orb_slam2_tpu_torch.utils import convert

from test_schur_ba import make_ba_scene, LEVEL_SIGMA2

R_TOL, T_TOL = 1e-4, 5e-4


def _sim3(R, t, s):
    return jsim3.Sim3(jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32),
                      jnp.asarray(s, jnp.float32))


def _stack(gs):
    return jsim3.Sim3(jnp.stack([g.R for g in gs]), jnp.stack([g.t for g in gs]),
                      jnp.stack([g.s for g in gs]))


def _problem(nodes, K, n, edges, meas, E, fixed=0):
    ei, ej, ev = np.zeros(E, np.int32), np.zeros(E, np.int32), np.zeros(E, bool)
    for k, (i, j) in enumerate(edges):
        ei[k], ej[k], ev[k] = i, j, True
    meas = meas + [_sim3(np.eye(3), np.zeros(3), 1.0)] * (E - len(meas))
    return jpg.PoseGraphProblem(nodes=nodes, node_valid=jnp.asarray(np.arange(K) < n),
                                node_fixed=jnp.asarray(np.arange(K) == fixed),
                                edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
                                edge_meas=_stack(meas), edge_valid=jnp.asarray(ev))


def circle_problem():
    """tests/test_pose_graph.py's circle: 16 poses with drifted odometry and
    one true loop edge (6 DoF)."""
    n, K = 16, 20
    gt = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        Twc = np.eye(4)
        Twc[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray([0, 0, ang])))
        Twc[:3, 3] = [np.cos(ang), np.sin(ang), 0.0]
        gt.append(np.linalg.inv(Twc))
    rel = [gt[i + 1] @ np.linalg.inv(gt[i]) for i in range(n - 1)]
    drift = np.asarray(jse3.exp(jnp.asarray([0.05, 0.02, 0.0, 0.0, 0.0, 0.025])))
    noisy = [r @ drift for r in rel]
    poses = [gt[0]]
    for r in noisy:
        poses.append(r @ poses[-1])
    nodes = _stack([_sim3(p[:3, :3], p[:3, 3], 1.0) for p in poses] +
                   [_sim3(np.eye(3), np.zeros(3), 1.0)] * (K - n))
    loop = gt[0] @ np.linalg.inv(gt[n - 1])
    meas = [_sim3(r[:3, :3], r[:3, 3], 1.0) for r in noisy] + \
        [_sim3(loop[:3, :3], loop[:3, 3], 1.0)]
    edges = [(i, i + 1) for i in range(n - 1)] + [(n - 1, 0)]
    return _problem(nodes, K, n, edges, meas, 32), gt, False


def scale_problem():
    """tests/test_pose_graph.py's 7-DoF case: a line of 10 poses whose
    odometry shrinks the scale 5 % a step, and one loop edge."""
    n, K = 10, 12
    gt = []
    for i in range(n):
        Twc = np.eye(4)
        Twc[:3, 3] = [i * 1.0, 0, 0]
        gt.append(np.linalg.inv(Twc))
    rel = [gt[i + 1] @ np.linalg.inv(gt[i]) for i in range(n - 1)]
    nodes_l = [_sim3(gt[0][:3, :3], gt[0][:3, 3], 1.0)]
    meas = []
    cur = nodes_l[0]
    for i in range(n - 1):
        mi = _sim3(rel[i][:3, :3], rel[i][:3, 3], 0.95)
        meas.append(mi)
        cur = jsim3.compose(mi, cur)
        nodes_l.append(cur)
    nodes = _stack(nodes_l + [_sim3(np.eye(3), np.zeros(3), 1.0)] * (K - n))
    loop = gt[0] @ np.linalg.inv(gt[n - 1])
    meas.append(_sim3(loop[:3, :3], loop[:3, 3], 1.0))
    edges = [(i, i + 1) for i in range(n - 1)] + [(n - 1, 0)]
    return _problem(nodes, K, n, edges, meas, 16), gt, True


@pytest.mark.parametrize("make", [circle_problem, scale_problem], ids=["6dof", "7dof"])
def test_optimize_pose_graph(make):
    prob, gt, seven = make()
    n_iters = 25 if seven else 20
    jout = jpg.optimize_pose_graph(prob, n_iters=n_iters)
    tout = tpg.optimize_pose_graph(convert.pose_graph_problem_from_numpy(prob, "cpu"),
                                   n_iters=n_iters)
    np.testing.assert_allclose(tout.R.numpy(), np.asarray(jout.R), atol=R_TOL)
    np.testing.assert_allclose(tout.s.numpy(), np.asarray(jout.s), atol=R_TOL)
    np.testing.assert_allclose(tout.t.numpy(), np.asarray(jout.t), atol=T_TOL)
    n = len(gt)
    if seven:
        # the reference test's bar: the junction's scale jump collapses
        s = tout.s.numpy()
        assert abs(np.log(s[0] / s[n - 1])) < 0.5 * abs(np.log(float(prob.nodes.s[0]) /
                                                              float(prob.nodes.s[n - 1])))
        assert (s[:n] > 0.9).all() and (s[:n] <= 1.05).all()
    else:
        def end_err(ns):
            C = -np.asarray(ns.R[n - 1]).T @ (np.asarray(ns.t[n - 1]) / np.asarray(ns.s[n - 1]))
            return np.linalg.norm(C + gt[n - 1][:3, :3].T @ gt[n - 1][:3, 3])
        assert end_err(tout) < 0.35 * end_err(prob.nodes)


def test_pose_graph_fixed_scale_freezes_sigma():
    """fix_scale (stereo / RGB-D): every node keeps its scale."""
    prob, _, _ = scale_problem()
    jout = jpg.optimize_pose_graph(prob, n_iters=10, fix_scale=True)
    tout = tpg.optimize_pose_graph(convert.pose_graph_problem_from_numpy(prob, "cpu"),
                                   n_iters=10, fix_scale=True)
    np.testing.assert_array_equal(tout.s.numpy(), np.asarray(prob.nodes.s))
    np.testing.assert_allclose(tout.t.numpy(), np.asarray(jout.t), atol=T_TOL)
    np.testing.assert_allclose(tout.R.numpy(), np.asarray(jout.R), atol=R_TOL)


def test_solve_ba_pcg_against_reference_and_dense(rng):
    cam, prob, poses_true, X_true, nc, npts = make_ba_scene(
        rng, n_cams=6, n_pts=120, C=8, Q=160, O=8, perturb=0.02)
    jres = jpcg.solve_ba_pcg(cam, prob, LEVEL_SIGMA2, n_iters=15, cg_iters=60, robust=True)
    tprob = convert.ba_problem_from_numpy(prob, "cpu")
    tc = Camera.make(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                     bf=float(cam.bf), device="cpu")
    tres = tpcg.solve_ba_pcg(tc, tprob, LEVEL_SIGMA2, n_iters=15, cg_iters=60, robust=True)
    np.testing.assert_allclose(tres.poses.numpy(), np.asarray(jres.poses), atol=2e-4)
    np.testing.assert_allclose(tres.points.numpy()[:npts], np.asarray(jres.points)[:npts],
                               atol=2e-3)
    np.testing.assert_array_equal(tres.edge_inlier.numpy(), np.asarray(jres.edge_inlier))
    dense = tsb.solve_ba(tc, tprob, LEVEL_SIGMA2, iters_a=15, iters_b=0, robust=True)
    for c in range(nc):
        np.testing.assert_allclose(tres.poses.numpy()[c], poses_true[c], atol=5e-3)
        np.testing.assert_allclose(dense.poses.numpy()[c], poses_true[c], atol=5e-3)
    err = np.linalg.norm(tres.points.numpy()[:npts] - X_true, axis=-1)
    assert np.median(err) < 1e-2


def _seen_once_scene(rng, n_once=10):
    """The reference's stereo BA scene with n_once points seen once, by
    their last camera (a free one: cameras 0 and 1 are fixed) and without
    depth: rank-2 point blocks, as a global BA meets them."""
    cam, prob, poses_true, X_true, nc, npts = make_ba_scene(
        rng, n_cams=6, n_pts=120, C=8, Q=160, O=8, stereo=True, perturb=0.02)
    obs_cam, obs_uvr = np.asarray(prob.obs_cam).copy(), np.asarray(prob.obs_uvr).copy()
    once = [q for q in range(npts) if obs_cam[q].max() >= 2][:n_once]
    for q in once:
        last = int(np.nonzero(obs_cam[q] >= 0)[0][-1])
        obs_cam[q, 0], obs_uvr[q, 0] = obs_cam[q, last], obs_uvr[q, last]
        obs_cam[q, 1:] = -1
        obs_uvr[q, :, 2] = -1.0
    prob = prob._replace(obs_cam=jnp.asarray(obs_cam), obs_uvr=jnp.asarray(obs_uvr))
    tc = Camera.make(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                     bf=float(cam.bf), device="cpu")
    return tc, convert.ba_problem_from_numpy(prob, "cpu")


@pytest.mark.parametrize("lam", [1e-4, 1e-9])
def test_step_with_points_seen_once(rng, lam):
    """One LM step at LM's first and least damping against the exact step
    of the same linearization (the reduced system formed in float64 with
    exact 3x3 inverses). At 1e-9 the damping is below float32's resolution
    of a rank-2 block: without schur_ba.PIVOT_FLOOR both steps were NaN
    there. Held, relative: the dense step to 1e-3 (measured 2.1e-5 at
    1e-4, 3.3e-4 at 1e-9); PCG's (200 CG iterations) to 1e-3 at 1e-4
    (9.2e-5) and to 0.1 at 1e-9 (5.3e-2: float32 CG on the implicit
    operator stalls there, PERF.md section 6)."""
    tc, prob = _seen_once_scene(rng)
    C = prob.poses.shape[0]
    inv_sigma2 = 1.0 / torch.tensor(LEVEL_SIGMA2)[prob.obs_level.long()]
    mask = ((prob.obs_cam >= 0) & prob.pt_valid[:, None]).float()
    edges = tsb._edges(prob, inv_sigma2)
    lin = tsb._assemble(tc, prob, edges, prob.poses, prob.points, mask, False)
    lam32 = torch.tensor(lam)
    free = prob.cam_valid & ~prob.cam_fixed
    f6 = free.repeat_interleave(6)

    Q, O = lin.chi2.shape
    Hpp = torch.where(lin.pt_on[:, None, None], tsb._damped(lin.Hpp.double(), lam32.double()),
                      torch.eye(3, dtype=torch.float64))
    W = torch.einsum("qoc,qoij->ciqj", edges.onehot.double().reshape(Q, O, C),
                     lin.We.double())
    WH = torch.einsum("ciqj,qjk->ciqk", W, torch.linalg.inv(Hpp)).reshape(C * 6, Q * 3)
    S = torch.block_diag(*tsb._damped(lin.Hcc.double(), lam32.double())) - \
        WH @ W.reshape(C * 6, Q * 3).T
    b = lin.bc.double().reshape(-1) - WH @ lin.bp.double().reshape(-1)
    exact = torch.linalg.solve(S[f6][:, f6], b[f6])

    pre = tpcg._precompute(lin, lam32)
    for step, tol in ((tsb._solve_step(prob, edges, lin, lam32)[0], 1e-3),
                      (tpcg._pcg(pre, edges, tpcg._reduced_rhs(pre, edges, free), free, 200),
                       1e-3 if lam > 1e-6 else 0.1)):
        step = step.reshape(-1)[f6].double()
        assert float((step - exact).norm() / exact.norm()) < tol


def test_pcg_and_dense_with_points_seen_once(rng):
    """run_global_ba's 10 LM iterations with either solver, robust kernel
    off, on the scene with points seen once: finite, the poses within the
    reference test's 5e-3 of each other (measured 1.7e-6)."""
    tc, prob = _seen_once_scene(rng)
    dense = tsb.solve_ba(tc, prob, LEVEL_SIGMA2, iters_a=10, iters_b=0, robust=False)
    pcg = tpcg.solve_ba_pcg(tc, prob, LEVEL_SIGMA2, n_iters=10)
    free = prob.cam_valid & ~prob.cam_fixed
    assert float((pcg.poses - dense.poses)[free].abs().max()) <= 5e-3
    assert torch.isfinite(dense.poses).all() and torch.isfinite(pcg.poses).all()
