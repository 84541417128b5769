"""The port's loop closing (`pipeline/loop_closing.py`, `mapstate.add_loop_edge`)
against the JAX reference's on `tests/test_loop_closing.py`'s drifted map
(K = 16, P = 512, N = 64), carried across with `utils/convert.py`, on the
CPU (K4's and K5's twins).

Tolerances, and why: detection candidates, the consistency groups, the
SearchByBoW counts, compute_sim3's decision and inlier count, the loop
edges, the essential graph's edge list and keyframe culling are integers
and equal. compute_sim3 gets the reference's RANSAC draws (the port draws
from a torch generator, the reference from `jax.random`). Its Sim3 agrees
to 1e-5 (measured 1.2e-7); the corrected map's poses and points to 1e-5
(measured 7e-7), with the global BA's 10 float32 LM iterations 1e-4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.bow import database as jdb
from orb_slam2_tpu.mapstate import map as jmap
from orb_slam2_tpu.pipeline import loop_closing as jlc
from orb_slam2_tpu.pipeline import mapping_ops as jmo
from orb_slam2_tpu.utils.config import SlamConfig

from orb_slam2_tpu_torch.bow import database as tdb
from orb_slam2_tpu_torch.mapstate import map as tmap
from orb_slam2_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_tpu_torch.pipeline import mapping_ops as tmo
from orb_slam2_tpu_torch.solvers import sim3_solver as tsolver
from orb_slam2_tpu_torch.utils import convert

from test_loop_closing import K, N, P, build_drifted_map, cfg as lc_cfg, project

SIM3_TOL = 1e-5
MAP_TOL = 1e-5
GBA_TOL = 1e-4


@pytest.fixture(scope="module")
def drifted():
    c, m, kf0, kf1, _, drift_t = build_drifted_map(np.random.default_rng(0))
    return dict(c=c, m=m, kf0=kf0, kf1=kf1, drift=drift_t, tc=convert.config_from_jax(c),
                tm=convert.mapstate_from_numpy(m, "cpu"))


@pytest.fixture(scope="module")
def sim3(drifted):
    """compute_sim3 in both packages, the port handed the reference's draws."""
    d = drifted
    mp = pytest.MonkeyPatch()
    orig = tsolver.ransac_sim3

    def with_reference_draws(*args, generator=None, **kw):
        key = jax.random.PRNGKey(d["kf1"] * 977 + d["kf0"])
        n_valid = max(int(args[4].sum()), 1)
        draws = np.array(jax.random.randint(key, (128, 3), 0, n_valid))
        return orig(*args, draws=torch.from_numpy(draws), **kw)

    mp.setattr(tsolver, "ransac_sim3", with_reference_draws)
    try:
        j = jlc.compute_sim3(d["c"], d["m"], d["kf1"], d["kf0"])
        t = tlc.compute_sim3(d["tc"], d["tm"], d["kf1"], d["kf0"])
    finally:
        mp.undo()
    return j, t


def _same_map(tm, jm, tol, what):
    got = convert.mapstate_to_numpy(tm)
    for f in jmap.MapState._fields:
        g, w = got[f], np.asarray(getattr(jm, f))
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def test_compute_sim3(sim3):
    (jok, jS, jn), (tok, tS, tn) = sim3
    assert jok and tok and tn == jn > 40
    for f in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(tS, f).numpy(), np.asarray(getattr(jS, f)),
                                   atol=SIM3_TOL)


def test_bow_match_counts(drifted):
    d = drifted
    cands = np.array([d["kf0"], -1, d["kf1"], 2, -1, -1, -1, d["kf0"]], np.int32)
    j = jlc.bow_match_counts(d["c"], d["m"], d["kf1"], jnp.asarray(cands))
    t = tlc.bow_match_counts(d["tc"], d["tm"], d["kf1"], torch.from_numpy(cands))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t[0] > 40 and t[1] == 0


def test_detect_loop_consistency_gate(drifted):
    """The reference test's gate (consistency threshold 2: rejected on the
    first two sightings, accepted on the third), both packages call by
    call: candidates, group state and the loop-gap early return."""
    d = drifted
    m = d["m"]
    slots1 = m.kf_obs[d["kf1"]]
    m, kf2 = jmap.add_keyframe(m, m.kf_pose[d["kf1"]], m.kf_xy[d["kf1"]], m.kf_level[d["kf1"]],
                               m.kf_angle[d["kf1"]], m.kf_desc[d["kf1"]], m.kf_ur[d["kf1"]],
                               m.kf_depth[d["kf1"]], m.kf_feat_valid[d["kf1"]], slots1, 11, 0.0)
    m = jmap.update_connections(m, kf2)
    m = jmap.update_connections(m, d["kf1"])
    c2 = SlamConfig(**{**d["c"].__dict__, "covis_consistency_th": 2, "loop_kf_gap": 5,
                       "max_keypoints": N})
    tc2 = convert.config_from_jax(c2)
    tm = convert.mapstate_from_numpy(m, "cpu")
    ws = np.full(32, np.iinfo(np.int32).max, np.int32)
    ws[:8] = np.arange(8)
    wv = np.zeros(32, np.float32)
    wv[:8] = 1 / 8
    jdb_ = jdb.BowDatabase.empty(K, 32).add(d["kf0"], (jnp.asarray(ws), jnp.asarray(wv)))
    tdb_ = tdb.BowDatabase.empty(K, 32, device="cpu").add(
        d["kf0"], (torch.from_numpy(ws), torch.from_numpy(wv)))
    js, ts = jlc.LoopState(), tlc.LoopState()
    got = []
    for seq in (20, 21, 22, 23):
        jc = jlc.detect_loop(c2, m, jdb_, (jnp.asarray(ws), jnp.asarray(wv)), d["kf1"], js, seq)
        tcands = tlc.detect_loop(tc2, tm, tdb_, (torch.from_numpy(ws), torch.from_numpy(wv)),
                                 d["kf1"], ts, seq)
        assert tcands == jc, seq
        np.testing.assert_array_equal(ts.groups.numpy(), np.asarray(js.groups))
        np.testing.assert_array_equal(ts.cons.numpy(), np.asarray(js.cons))
        got.append(tcands)
    assert got[:2] == [[], []] and got[2] == [d["kf0"]]
    # within loop_kf_gap of the last loop: no detection, the groups untouched
    ts.last_loop_kf_seq = js.last_loop_kf_seq = 22
    groups = ts.groups.clone()
    assert tlc.detect_loop(tc2, tm, tdb_, (torch.from_numpy(ws), torch.from_numpy(wv)),
                           d["kf1"], ts, 24) == []
    assert torch.equal(ts.groups, groups)
    # the converted state continues the same
    ts2 = convert.loop_state_from_numpy(js, "cpu")
    np.testing.assert_array_equal(ts2.cons.numpy(), np.asarray(js.cons))


@pytest.mark.parametrize("run_gba", [False, True], ids=["no_gba", "gba"])
def test_correct_loop(drifted, sim3, run_gba):
    d = drifted
    (_, jS, _), _ = sim3
    jm2 = jlc.correct_loop(d["c"], d["m"], d["kf1"], d["kf0"], jS, run_gba=run_gba)
    tm2 = tlc.correct_loop(d["tc"], d["tm"], d["kf1"], d["kf0"],
                           convert.sim3_from_numpy(jS, "cpu"), run_gba=run_gba)
    _same_map(tm2, jm2, GBA_TOL if run_gba else MAP_TOL, "correct_loop")
    P0, P1 = tm2.kf_pose[d["kf0"]].numpy(), tm2.kf_pose[d["kf1"]].numpy()
    c0, c1 = -P0[:3, :3].T @ P0[:3, 3], -P1[:3, :3].T @ P1[:3, 3]
    assert np.linalg.norm(c0 - c1) < 0.5 * np.linalg.norm(d["drift"])
    np.testing.assert_array_equal(tm2.loop_edges.numpy()[0], [d["kf1"], d["kf0"]])
    if not run_gba:
        # the deferred global BA on the corrected map, standalone
        j3 = jlc.run_global_ba(d["c"], jm2, n_iters=3)
        t3 = tlc.run_global_ba(d["tc"], tm2, n_iters=3)
        _same_map(t3, j3, GBA_TOL, "run_global_ba")


def test_loop_edges_and_essential_edges(drifted, sim3):
    """add_loop_edge fills the first free row; build_essential_edges gives
    the reference's list, and a second closure keeps the first edge."""
    d = drifted
    (_, jS, _), _ = sim3
    jm2 = jlc.correct_loop(d["c"], d["m"], d["kf1"], d["kf0"], jS, run_gba=False)
    tm2 = convert.mapstate_from_numpy(jm2, "cpu")
    for i, j in ((d["kf0"], d["kf1"]), (d["kf1"], d["kf0"])):
        assert tlc.build_essential_edges(d["tc"], tm2, i, j) == \
            jlc.build_essential_edges(d["c"], jm2, i, j)
    jm3 = jmap.add_loop_edge(jm2, 2, d["kf0"])
    tm3 = tmap.add_loop_edge(tm2, 2, d["kf0"])
    np.testing.assert_array_equal(tm3.loop_edges.numpy(), np.asarray(jm3.loop_edges))
    jm3 = jm3._replace(kf_valid=jm3.kf_valid.at[2].set(True))
    tm3 = tm3._replace(kf_valid=tm3.kf_valid.index_fill(0, torch.tensor([2]), True))
    te = tlc.build_essential_edges(d["tc"], tm3, 2, d["kf1"])
    assert te == jlc.build_essential_edges(d["c"], jm3, 2, d["kf1"])
    keys = {(min(e), max(e)) for e in te}
    assert (min(d["kf0"], d["kf1"]), max(d["kf0"], d["kf1"])) in keys and (0, 2) in keys
    np.testing.assert_array_equal(tmap.loop_protected_keyframes(tm3).numpy(),
                                  np.asarray(jmap.loop_protected_keyframes(jm3)))
    # a full table drops the write
    full = tm3._replace(loop_edges=torch.zeros_like(tm3.loop_edges))
    assert torch.equal(tmap.add_loop_edge(full, 5, 6).loop_edges, full.loop_edges)


def test_essential_graph_measurements_before_and_after(drifted, sim3):
    """Tree and covisibility edges measure the poses before the correction,
    the loop edge and in-group edges the poses after it."""
    d = drifted
    _, (_, tS, _) = sim3
    tm = d["tm"]
    before = tm.kf_pose.clone()
    tm2, group = tlc._propagate_and_fuse(d["tc"], tm, d["kf1"], d["kf0"], tS)
    prob = tlc.essential_problem(d["tc"], tm2, before, d["kf1"], d["kf0"], group)
    g = group.numpy()
    for n in range(int(prob.edge_valid.sum())):
        i, j = int(prob.edge_i[n]), int(prob.edge_j[n])
        after = {i, j} == {d["kf1"], d["kf0"]} or (g[i] and g[j])
        poses = (tm2.kf_pose if after else before).numpy()
        rel = poses[j] @ np.linalg.inv(poses[i])
        np.testing.assert_allclose(prob.edge_meas.R[n].numpy(), rel[:3, :3], atol=1e-6)
        np.testing.assert_allclose(prob.edge_meas.t[n].numpy(), rel[:3, 3], atol=1e-6)
    assert not torch.equal(tm2.kf_pose[d["kf1"]], before[d["kf1"]])


def test_loop_keyframe_survives_culling():
    """tests/test_loop_closing.py's five identical-view keyframes: the one
    holding a loop edge is never culled; both packages cull the same."""
    rng = np.random.default_rng(0)
    c = lc_cfg()
    m = jmap.empty(K, P, N)
    Xw = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1.0, 1.0, N),
                   rng.uniform(3.0, 5.0, N)], -1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, size=(N, 8), dtype=np.uint32)
    uv = project(Xw)
    in_img = (uv[:, 0] > 10) & (uv[:, 0] < 310) & (uv[:, 1] > 10) & (uv[:, 1] < 230)
    kfs, slots = [], None
    for fid in range(5):
        m, k = jmap.add_keyframe(m, jnp.eye(4), jnp.asarray(uv), jnp.zeros(N, jnp.int32),
                                 jnp.zeros(N, jnp.float32), jnp.asarray(desc), jnp.full(N, -1.0),
                                 jnp.full(N, -1.0), jnp.asarray(in_img),
                                 jnp.full(N, -1, jnp.int32), fid, 0.0)
        kfs.append(int(k))
        if slots is None:
            slots = jmap.allocate_points(m, jnp.asarray(in_img))
            m = jmap.add_points(m, slots, jnp.asarray(Xw), jnp.asarray(desc), k, 0)
        m = jmap.bind_observations(m, k, jnp.arange(N), slots, jnp.asarray(in_img) & (slots >= 0))
        m = jmap.update_connections(m, k)
    tm = tmap.add_loop_edge(convert.mapstate_from_numpy(m, "cpu"), kfs[1], kfs[4])
    m = jmap.add_loop_edge(m, kfs[1], kfs[4])
    _, jculled = jmo.cull_keyframes(c, m, jnp.asarray(kfs[4]))
    _, tculled = tmo.cull_keyframes(convert.config_from_jax(c), tm, torch.tensor(kfs[4]))
    np.testing.assert_array_equal(tculled.numpy(), np.asarray(jculled))
    assert not tculled[kfs[1]] and not tculled[kfs[4]] and (tculled[kfs[2]] or tculled[kfs[3]])
