"""The port's sharded solvers (`orb_slam2_tpu_torch/parallel/`,
`solvers/pcg_ba.solve_ba_pcg_sharded`) and loop closing's mesh branches
against the JAX package's on a mesh of the same size, on the CPU.

The port's ranks are W processes spawned by `torch.multiprocessing` over
gloo (`init_distributed(device="cpu")`, a file store in the test's
temporary directory, one thread each); each rank saves its result and
every rank's must be the same. The reference runs its `shard_map` solvers
on a mesh of W of the 8 virtual CPU devices (`tests/conftest.py`). This
module's top level imports torch only, so a spawned rank imports neither
JAX nor the JAX package; the reference's side imports JAX inside the test
functions.

Tolerances, and why:
- the sharded global BA and PCG against the reference's at the same W
  (the reference damps each shard's camera blocks by that shard's own
  diagonal, `sharded_ba.py:81-82`, so W changes the result): poses within
  2e-4 and points within 2e-3 m, the port's PCG-against-reference bound
  (`tests/test_torch_pose_graph.py`), the same edge classification;
- at W = 1 the sharded global BA equals the port's `schur_ba.solve_ba`
  bit for bit (the all-reduce of one rank is a copy);
- the sharded essential graph within the port's pose-graph bounds (R 1e-4,
  t 5e-4), and the loop's junction closes (`tests/test_parallel.py`);
- correct_loop with a mesh, the global BA included, within
  `tests/test_torch_loop_closing.py`'s 1e-4.
"""
import functools

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from orb_slam2_tpu_torch.geometry.camera import Camera
from orb_slam2_tpu_torch.parallel import distributed, sharded_ba, sharded_pose_graph
from orb_slam2_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_tpu_torch.solvers import pcg_ba, schur_ba

LEVEL_SIGMA2 = tuple(1.2 ** (2 * i) for i in range(8))   # test_schur_ba's
POSE_TOL, POINT_TOL = 2e-4, 2e-3
R_TOL, T_TOL = 1e-4, 5e-4
GBA_TOL = 1e-4


def _jobs(mesh, inputs):
    """What one rank computes: each entry of `inputs` through the port's
    sharded entry point on `mesh`."""
    out = {"mesh": (mesh.ndim, mesh.mesh_dim_names, mesh.size())}
    for key, (cam, prob, n_iters, robust) in inputs.get("ba", {}).items():
        out[f"ba_{key}"] = sharded_ba.solve_global_ba_sharded(cam, prob, LEVEL_SIGMA2, mesh,
                                                              n_iters=n_iters, robust=robust)
        if mesh.size() == 1:
            out[f"solve_ba_{key}"] = schur_ba.solve_ba(cam, prob, LEVEL_SIGMA2, iters_a=n_iters,
                                                       iters_b=0, robust=robust)
    if "pcg" in inputs:
        cam, prob = inputs["pcg"]
        out["pcg"] = pcg_ba.solve_ba_pcg_sharded(cam, prob, LEVEL_SIGMA2, mesh, n_iters=5,
                                                 cg_iters=40)
    if "pose_graph" in inputs:
        out["pose_graph"] = sharded_pose_graph.optimize_pose_graph_sharded(
            inputs["pose_graph"], mesh, n_iters=15, fix_scale=True)
    if "correct_loop" in inputs:
        cfg, m, kf, cand, S = inputs["correct_loop"]
        out["correct_loop"] = tlc.correct_loop(cfg, m, kf, cand, S, mesh=mesh, run_gba=True)
    if "essential" in inputs:
        cfg, m, before, kf, cand, group = inputs["essential"]
        out["essential_E"] = tlc.essential_problem(cfg, m, before, kf, cand, group,
                                                   mesh=mesh).edge_i.shape[0]
        out["essential"] = tlc._essential_graph(cfg, m, before, kf, cand, group, mesh=mesh)
    return out


def _rank(rank, W, tmp, inputs):
    torch.set_num_threads(1)
    if W == 1:
        mesh = distributed.init_distributed(device="cpu")      # this process alone
    else:
        mesh = distributed.init_distributed(init_method=f"file://{tmp}/init", world_size=W,
                                            rank=rank, device="cpu")
    torch.save(_jobs(mesh, inputs), f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


def _flat(x):
    """The tensors of a result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _flat(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat(v)]
    return []


def _spawn(W, tmp, inputs):
    """Rank 0's results, after checking every rank returned the same."""
    mp.spawn(_rank, args=(W, str(tmp), inputs), nprocs=W, join=True)
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(W)]
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(_flat(outs[0]), _flat(other)))
    return outs[0]


def _port_cam(cam):
    return Camera.make(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                       bf=float(cam.bf), device="cpu")


def _ba_scene(seed, **kw):
    from test_schur_ba import make_ba_scene
    from orb_slam2_tpu_torch.utils import convert
    cam, prob, poses_true, X_true, nc, npts = make_ba_scene(np.random.default_rng(seed), **kw)
    return dict(jcam=cam, jprob=prob, cam=_port_cam(cam),
                prob=convert.ba_problem_from_numpy(prob, "cpu"), poses_true=poses_true,
                X_true=X_true, nc=nc, npts=npts)


SMALL = dict(n_cams=4, n_pts=60, C=8, Q=160, O=8, perturb=0.01)   # test_parallel's


def _pose_graph_problem():
    from test_parallel import TestShardedPoseGraph
    return TestShardedPoseGraph()._problem(np.random.default_rng(0))


@functools.lru_cache(maxsize=1)
def _drifted():
    """tests/test_loop_closing.py's drifted map and the reference's Sim3 of
    its loop, in both packages."""
    from test_loop_closing import build_drifted_map
    from orb_slam2_tpu.pipeline import loop_closing as jlc
    from orb_slam2_tpu_torch.utils import convert
    c, m, kf0, kf1, _, _ = build_drifted_map(np.random.default_rng(0))
    ok, S, _ = jlc.compute_sim3(c, m, kf1, kf0)
    assert ok
    return dict(c=c, m=m, kf0=kf0, kf1=kf1, S=S, tc=convert.config_from_jax(c),
                tm=convert.mapstate_from_numpy(m, "cpu"), tS=convert.sim3_from_numpy(S, "cpu"))


def _inputs(W):
    scene = _ba_scene(0, **SMALL)
    inputs = {}
    if W != 3:                    # 160 points do not split into 3 blocks
        inputs["ba"] = {robust: (scene["cam"], scene["prob"], 5, robust)
                        for robust in (False, True)}
    if W == 4:
        rec = _ba_scene(0)
        inputs["ba"]["recovery"] = (rec["cam"], rec["prob"], 15, True)
    if W == 2:
        from orb_slam2_tpu_torch.utils import convert
        inputs["pcg"] = (scene["cam"], scene["prob"])
        inputs["pose_graph"] = convert.pose_graph_problem_from_numpy(_pose_graph_problem()[0],
                                                                     "cpu")
        d = _drifted()
        inputs["correct_loop"] = (d["tc"], d["tm"], d["kf1"], d["kf0"], d["tS"])
    if W == 3:
        from orb_slam2_tpu.pipeline import loop_closing as jlc
        from orb_slam2_tpu_torch.utils import convert
        d = _drifted()
        jm, jgroup = jlc._propagate_and_fuse(d["c"], d["m"], d["kf1"], d["kf0"], d["S"])
        inputs["essential"] = (d["tc"], convert.mapstate_from_numpy(jm, "cpu"), d["tm"].kf_pose,
                               d["kf1"], d["kf0"], torch.from_numpy(np.array(jgroup)))
    return inputs


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's results at W ranks, one spawn per W."""
    runs = {}

    def get(W):
        if W not in runs:
            runs[W] = _spawn(W, tmp_path_factory.mktemp(f"w{W}"), _inputs(W))
        return runs[W]
    return get


def _jmesh(W):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:W]), ("shard",))


def _close(got, want, npts, what):
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_TOL,
                               err_msg=what)
    np.testing.assert_allclose(got.points.numpy()[:npts], np.asarray(want.points)[:npts],
                               atol=POINT_TOL, err_msg=what)
    np.testing.assert_array_equal(got.edge_inlier.numpy(), np.asarray(want.edge_inlier),
                                  err_msg=what)


@pytest.mark.parametrize("robust", [False, True], ids=["plain", "robust"])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_sharded_ba_against_reference(port, W, robust):
    from orb_slam2_tpu.parallel import sharded_ba as jsharded
    scene = _ba_scene(0, **SMALL)
    want = jsharded.solve_global_ba_sharded(scene["jcam"], scene["jprob"], LEVEL_SIGMA2,
                                            _jmesh(W), n_iters=5, robust=robust)
    got = port(W)[f"ba_{robust}"]
    _close(got, want, scene["npts"], f"W={W}")
    if W == 1:
        # one rank: the unsharded solve's every bit
        one = port(1)[f"solve_ba_{robust}"]
        assert all(torch.equal(a, b) for a, b in zip(got, one))


def test_sharded_ba_recovers_the_scene(port):
    """The 8-camera-slot scene from a 0.02 perturbation, 15 robust LM
    iterations over 4 ranks (tests/test_parallel.py:13-24)."""
    rec = _ba_scene(0)
    res = port(4)["ba_recovery"]
    for c in range(rec["nc"]):
        np.testing.assert_allclose(res.poses.numpy()[c], rec["poses_true"][c], atol=5e-3)
    err = np.linalg.norm(res.points.numpy()[:rec["npts"]] - rec["X_true"], axis=-1)
    assert np.median(err) < 1e-2


def test_sharded_pcg_against_reference(port):
    from orb_slam2_tpu.solvers import pcg_ba as jpcg
    scene = _ba_scene(0, **SMALL)
    want = jpcg.solve_ba_pcg_sharded(scene["jcam"], scene["jprob"], LEVEL_SIGMA2, _jmesh(2),
                                     n_iters=5, cg_iters=40)
    _close(port(2)["pcg"], want, scene["npts"], "sharded PCG")


def test_sharded_pose_graph_against_reference(port):
    from orb_slam2_tpu.parallel import sharded_pose_graph as jspg
    prob, gt, n = _pose_graph_problem()
    want = jspg.optimize_pose_graph_sharded(prob, _jmesh(2), n_iters=15, fix_scale=True)
    got = port(2)["pose_graph"]
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=R_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=T_TOL)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), atol=R_TOL)
    T_new, T0 = got.to_se3().numpy(), np.asarray(prob.nodes.to_se3())

    def end_err(T):
        return np.linalg.norm(np.linalg.inv(T[n - 1])[:3, 3] - np.linalg.inv(gt[n - 1])[:3, 3])
    assert end_err(T_new) < 0.5 * end_err(T0)


def _same_map(tm, jm, tol, what):
    from orb_slam2_tpu.mapstate import map as jmap
    from orb_slam2_tpu_torch.utils import convert
    got = convert.mapstate_to_numpy(tm)
    for f in jmap.MapState._fields:
        g, w = got[f], np.asarray(getattr(jm, f))
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def test_correct_loop_with_mesh(port):
    """correct_loop over 2 ranks: the sharded essential graph and the
    sharded global BA, against the reference's on a 2-device mesh."""
    from orb_slam2_tpu.pipeline import loop_closing as jlc
    d = _drifted()
    jm2 = jlc.correct_loop(d["c"], d["m"], d["kf1"], d["kf0"], d["S"], mesh=_jmesh(2),
                           run_gba=True)
    _same_map(port(2)["correct_loop"], jm2, GBA_TOL, "correct_loop(mesh)")


def test_essential_graph_pads_edges_to_the_mesh(port):
    """Over 3 ranks the power-of-two edge axis is padded to a multiple of
    3, as the reference pads it (`loop_closing.py:506-508`), and the solve
    matches the reference's on a 3-device mesh."""
    from orb_slam2_tpu.pipeline import loop_closing as jlc
    d = _drifted()
    jm, jgroup = jlc._propagate_and_fuse(d["c"], d["m"], d["kf1"], d["kf0"], d["S"])
    n_edges = len(jlc.build_essential_edges(d["c"], jm, d["kf1"], d["kf0"]))
    E = max(16, 1 << int(np.ceil(np.log2(n_edges + 1))))
    res = port(3)
    assert res["essential_E"] == -(-E // 3) * 3 and res["essential_E"] % 3 == 0
    assert res["essential_E"] > E
    want = jlc._essential_graph(d["c"], jm, d["m"].kf_pose, d["kf1"], d["kf0"], jgroup,
                                mesh=_jmesh(3))
    _same_map(res["essential"], want, 1e-4, "_essential_graph(mesh)")


def test_init_distributed_alone_is_a_one_rank_mesh(port):
    """No arguments and no torchrun environment: this process alone, a 1-D
    mesh named "shard" over gloo."""
    assert port(1)["mesh"] == (1, ("shard",), 1)
