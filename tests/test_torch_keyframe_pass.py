"""The port's keyframe event (`orb_slam2_tpu_torch/pipeline/mapping_ops.py`
`keyframe_pass`, `mapping_pass` and its stages, and the map functions of
`mapstate/map.py` they use) against the JAX reference on the CPU, at a small
size: 240x320 RGB-D, 300 features, 16 keyframe slots (the reference's
triangulation takes the top 10 covisible keyframes, so it needs 10 or more),
4096 points, local BA with 4 + 4 cameras, 1024 points and 8 observations
per point.

The JAX reference builds the map: RGB-D initialization on frame 0, its
tracking step on frames 1-6, `keyframe_pass` on frames 2 and 4. The last
event (frame 6, four keyframes, so local BA runs) is the one under test:
- whole: the port's `keyframe_pass` on the snapshot before it;
- stage by stage: the keyframe inserted, every 3rd of its features freed so
  triangulation has work (as `tests/test_triangulate_pallas.py` does), then
  each stage of the reference's mapping pass
  (`scripts/chip_smoke_reference.jax_mapping_stages`) run by both packages
  on the reference's own input snapshot of that stage.

Tolerances, and why:
- map functions, point culling, the fusion decisions and targets, keyframe
  culling: exact (integer logic on identical inputs);
- triangulation: integer fields exact, floats within 1e-4 absolute plus
  1e-4 relative (the DLT's 3x3 solve and libm's atan2/cos round differently
  in the last place: measured 1.1e-4 m on one scale band of 5.4 m; no
  creation decision sits that close to its threshold on this data);
- local BA: poses within 1e-4 and points within 1e-3 (absolute plus
  relative), the outlier erasures and table fields exact (solve order and
  Cholesky rounding differ in float32);
- the whole event and `mapping_pass`: the summary exact, every integer
  field exact, floats as for local BA (normals 1e-4, scale bands 1e-3); the
  cached table's invariants of `tests/test_mapstate.py:294-329` hold; the
  reference's stage recomposition gives the reference `keyframe_pass`'s map
  (`assert_same_map`, floats within its `STAGE_TOL`), so the statistics
  taken from its stages are the event's.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.mapstate import map as jmap
from orb_slam2_tpu.pipeline import mapping_ops as jmo
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig

from orb_slam2_tpu_torch.mapstate import map as tmap
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.pipeline import mapping_ops as tmo
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import synthetic as tsyn

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import chip_smoke_reference as ref  # noqa: E402

torch.set_num_threads(1)
H, W, FX = 240, 320, 260.0
CAPS = dict(max_keyframes=16, max_map_points=4096, max_local_points=1024, ba_local_cams=4,
            ba_fixed_cams=4, ba_max_points=1024, ba_max_obs=8)
N_FRAMES, KF_EVERY = 7, 2


def _cfgs():
    kw = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H, bf=0.25 * FX,
              sensor=jconfig.SENSOR_RGBD, fps=30.0, th_depth=40.0, n_features=300, **CAPS)
    jcfg = jconfig.SlamConfig(use_pallas=0, **kw)
    return jcfg, convert.config_from_jax(jcfg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(m):
    return convert.mapstate_from_numpy(m, device="cpu")


@pytest.fixture(scope="module")
def seq():
    jcfg, tcfg = _cfgs()
    world = tsyn.PlateWorld(FX, FX, W / 2, H / 2, W, H, z0=5.0)
    poses = tsyn.loop_trajectory(181, radius=3.0, overshoot=0.5, spiral=0.12)[:N_FRAMES]
    tf = []
    for T in poses:
        gray, depth = world.render_with_depth(T)
        gray = np.clip(np.round(gray), 0, 255).astype(np.uint8)
        tf.append(tframe.make_frame_rgbd(torch.from_numpy(gray), torch.from_numpy(depth), tcfg))
    jf = [ref.jax_frame(f) for f in tf]
    N = jcfg.max_keypoints
    eye = jnp.eye(4, dtype=jnp.float32)
    m, kf = jmo.insert_keyframe(jcfg, jmap.empty(jcfg.max_keyframes, jcfg.max_map_points, N),
                                jf[0], eye, jnp.full((N,), -1, jnp.int32), 0, 0.0,
                                all_depth=True)
    lm = m.kf_obs[kf]
    lp, lpv = ref.jax_last(jcfg, m, jf[0], eye, lm)
    last, T_last, vel, has_vel, rkf = jf[0], eye, eye, False, kf
    for i in range(1, N_FRAMES):
        r = jts.full_tracking_step(jcfg, ref.copy_map(m), jf[i], last, lp, lpv, lm, T_last,
                                   vel, jnp.asarray(has_vel), rkf, 30)
        assert int(r.scalars[0]) == 1
        m = r.m
        if i == N_FRAMES - 1:
            break
        if i % KF_EVERY == 0:
            m, _, summary = jmo.keyframe_pass(jcfg, ref.copy_map(m), jf[i], r.Tcw,
                                              r.matched_pt, i, i / 30)
            lm = m.kf_obs[summary[0]]
            lp, lpv = ref.jax_last(jcfg, m, jf[i], r.Tcw, lm)
            rkf = summary[0]
        else:
            lm, lp, lpv, rkf = r.matched_pt, r.next_pts, r.next_pts_valid, r.ref_kf
        last, T_last, vel, has_vel = jf[i], r.Tcw, r.next_vel, True
    i = N_FRAMES - 1
    event = (r.Tcw, r.matched_pt, i, i / 30)
    m_pre = m
    m_kf, _, summary = jmo.keyframe_pass(jcfg, ref.copy_map(m_pre), jf[i], *event)

    # the staged event: keyframe inserted, every 3rd feature freed
    m_ins, kf_new = jmo.insert_keyframe(jcfg, ref.copy_map(m_pre), jf[i], *event,
                                        update_stats=False, table_fresh=True)
    m_ins = m_ins._replace(kf_obs=m_ins.kf_obs.at[kf_new].set(
        jnp.where(jnp.arange(N) % 3 == 0, -1, m_ins.kf_obs[kf_new])))
    st = ref.jax_mapping_stages(jcfg, m_ins, kf_new)
    return dict(jcfg=jcfg, tcfg=tcfg, tf=tf, m_pre=m_pre, event=event, m_kf=m_kf,
                summary=summary, m_ins=m_ins, kf=kf_new, st=st)


def _assert_map(got, want, atol=0.0, fields=None, close=()):
    """got (port MapState) against want (reference MapState): integer and
    bool fields exact, float fields within atol (or the per-field atol of
    close)."""
    g = convert.mapstate_to_numpy(got)
    for name in fields or tmap.MapState._fields:
        w = np.asarray(getattr(want, name))
        assert g[name].dtype == w.dtype and g[name].shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            tol = dict(close).get(name, atol)
            np.testing.assert_allclose(g[name], w, rtol=tol, atol=tol, err_msg=name)
        else:
            np.testing.assert_array_equal(g[name], w, err_msg=name)


def _kf(seq):
    return torch.tensor(int(seq["kf"]))


def test_the_event_has_work(seq):
    """The fixture exercises every stage: new points, fusion
    replacements, BA outlier erasures."""
    st = seq["st"]
    assert st["n_new"] >= 10 and st["n_replaced"] > 0 and st["n_outliers"] > 0, \
        (st["n_new"], st["n_replaced"], st["n_outliers"])
    assert int(st["stats"].n_keyframes) == 4 and len(st["rounds"]) >= 2


def test_map_functions_match(seq):
    """covisible_keyframes, loop_protected_keyframes, erase_points(_fast),
    replace_points(_fast), table_revalidate_points: exact."""
    st, kf = seq["st"], seq["kf"]
    m_j = st["tri"]
    m_t = _port(m_j)
    for k in (3, 8):
        for g, w in zip(tmap.covisible_keyframes(m_t, _kf(seq), k),
                        jmap.covisible_keyframes(m_j, kf, k)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ml_j = jmap.add_loop_edge(m_j, 1, 2)
    np.testing.assert_array_equal(tmap.loop_protected_keyframes(_port(ml_j)).numpy(),
                                  np.asarray(jmap.loop_protected_keyframes(ml_j)))
    rng = np.random.default_rng(0)
    kill = rng.random(m_j.capacity_pt) < 0.3
    _assert_map(tmap.erase_points(m_t, _t(kill)), jmap.erase_points(m_j, jnp.asarray(kill)))
    for max_killed in (4096, 8):          # the table path, and the overflow sweep
        _assert_map(tmap.erase_points_fast(m_t, _t(kill), extra_row=_kf(seq),
                                           max_killed=max_killed),
                    jmap.erase_points_fast(m_j, jnp.asarray(kill), extra_row=kf,
                                           max_killed=max_killed))
    m_j, mapping = st["pre_replace"], st["mapping"]
    m_t = _port(m_j)
    _assert_map(tmap.replace_points(m_t, _t(mapping)), jmap.replace_points(m_j, mapping))
    for max_rep in (2048, 2):
        _assert_map(tmap.replace_points_fast(m_t, _t(mapping), max_replaced=max_rep),
                    jmap.replace_points_fast(m_j, mapping, max_replaced=max_rep))
    flag = rng.random(m_j.capacity_pt) < 0.05
    for max_pts in (512, 4):
        _assert_map(tmap.table_revalidate_points(m_t, _t(flag), max_pts=max_pts),
                    jmap.table_revalidate_points(m_j, jnp.asarray(flag), max_pts=max_pts))


def test_cull_map_points_matches(seq):
    st = seq["st"]
    _assert_map(tmo.cull_map_points(seq["tcfg"], _port(seq["m_ins"]), cur_kf=_kf(seq)),
                st["culled_pts"])
    _assert_map(tmo.cull_map_points(seq["tcfg"], _port(seq["m_ins"])),
                jmo.cull_map_points(seq["jcfg"], seq["m_ins"]))


def test_epi_match_batch_on_the_map(seq):
    """K8's inputs as the port builds them and its twin's result, against
    the reference's Pallas kernel (interpret mode) on the same keyframes:
    bit-exact on this map."""
    st, kf = seq["st"], seq["kf"]
    m_j = st["culled_pts"]
    got = tmo._epi_match_batch(seq["tcfg"], _port(m_j), _kf(seq), _t(st["covis_ids"]))
    want = jmo._epi_match_batch(seq["jcfg"], m_j, kf, st["covis_ids"], interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_triangulate_batch_matches(seq):
    st = seq["st"]
    m, n = tmo.triangulate_batch(seq["tcfg"], _port(st["culled_pts"]), _kf(seq),
                                 _t(st["covis_ids"]))
    assert int(n) == st["n_new"]
    _assert_map(m, st["tri"], atol=1e-4)
    # the single-neighbour form
    nb = int(st["covis_ids"][0])
    m1, n1 = tmo.triangulate_with_neighbor(seq["tcfg"], _port(st["culled_pts"]), _kf(seq), nb)
    m1_j, n1_j = jmo.triangulate_with_neighbor(seq["jcfg"], st["culled_pts"], seq["kf"], nb)
    assert int(n1) == int(n1_j) > 0
    _assert_map(m1, m1_j, atol=1e-4)


def test_fusion_matches(seq):
    """The fusion targets, every decide round (the current keyframe's
    points into each target, then the targets' union into the current
    keyframe) and the fused map: exact; the standalone fuse_into_keyframe
    too."""
    st, tcfg, kf = seq["st"], seq["tcfg"], _kf(seq)
    m_t = _port(st["tri"])
    for g, w in zip(tmo._fusion_targets(m_t, kf, 10, 30),
                    jmo._fusion_targets(st["tri"], seq["kf"], 10, 30)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cur = m_t.kf_obs[kf]
    for nb, kf_obs, want in st["rounds"]:
        got = tmo._fuse_decide(tcfg, m_t._replace(kf_obs=_t(kf_obs)), m_t.pt_obs_cnt, nb,
                               cur, cur >= 0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pts, ok, m_u, want = st["union"]
    got = tmo._fuse_decide(tcfg, _port(m_u), m_t.pt_obs_cnt, kf, _t(pts), _t(ok))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sum(int(np.asarray(d[4]).sum()) for _, _, d in st["rounds"]) > 0   # replacements

    want = jmo.fuse_into_keyframe(seq["jcfg"], st["tri"], seq["kf"], pts, ok)
    _assert_map(tmo.fuse_into_keyframe(tcfg, m_t, kf, _t(pts), _t(ok)), want)


def test_local_ba_matches(seq):
    st = seq["st"]
    obs = tuple(_t(o) for o in st["obs"])
    m = tmo.local_ba(seq["tcfg"], _port(st["stats"]), _kf(seq), n_local=4, n_fixed=4,
                     max_pts=1024, max_obs=8, obs=obs)
    _assert_map(m, st["ba"], close=(("kf_pose", 1e-4), ("pt_pos", 1e-3)))
    erased = (st["stats"].kf_obs >= 0) & (m.kf_obs.numpy() < 0)
    assert int(erased.sum()) == st["n_outliers"] > 0


def test_cull_keyframes_matches(seq):
    st = seq["st"]
    obs = tuple(_t(o) for o in st["obs"])
    m, culled = tmo.cull_keyframes(seq["tcfg"], _port(st["ba"]), _kf(seq), obs=obs)
    m_j, culled_j = jmo.cull_keyframes(seq["jcfg"], st["ba"], seq["kf"], obs=st["obs"])
    np.testing.assert_array_equal(culled.numpy(), np.asarray(culled_j))
    _assert_map(m, m_j)
    # a keyframe made redundant: with four more table entries at its own
    # octave for every point keyframe 1 sees, both packages cull it and
    # re-parent its children
    m_r = st["ba"]
    obs_r = tuple(np.array(o) for o in st["obs"])
    row = np.asarray(m_r.kf_obs[1])
    for f in np.nonzero(row >= 0)[0]:
        free = np.nonzero(obs_r[0][row[f]] < 0)[0][:4]
        obs_r[0][row[f], free], obs_r[1][row[f], free], obs_r[2][row[f], free] = 1, f, True
    m, culled = tmo.cull_keyframes(seq["tcfg"], _port(m_r), _kf(seq),
                                   obs=tuple(_t(o) for o in obs_r))
    m_j, culled_j = jmo.cull_keyframes(seq["jcfg"], m_r, seq["kf"],
                                       obs=tuple(jnp.asarray(o) for o in obs_r))
    assert bool(culled[1]) and not bool(culled[0])
    np.testing.assert_array_equal(culled.numpy(), np.asarray(culled_j))
    _assert_map(m, m_j)


def _table_invariants(m):
    """`tests/test_mapstate.py:294-329`: every table entry backed by kf_obs,
    rows left-packed, and missing entries a small minority."""
    g = convert.mapstate_to_numpy(m)
    ref_kf, ref_ft, _ = tmap.point_observations(m, tmap.OBS_W)
    ref_kf, ref_ft = ref_kf.numpy(), ref_ft.numpy()
    got_kf, got_ft, kf_obs = g["obs_kf"], g["obs_ft"], g["kf_obs"]
    valid_pts = np.nonzero(g["pt_valid"])[0]
    for p in valid_pts:
        for k, f in zip(got_kf[p], got_ft[p]):
            if k >= 0:
                assert kf_obs[k, f] == p, (p, k, f, kf_obs[k, f])
    assert not ((got_kf[:, 1:] >= 0) & (got_kf[:, :-1] < 0)).any()
    n_mismatch = 0
    for p in valid_pts:
        want = {(int(k), int(f)) for k, f in zip(ref_kf[p], ref_ft[p]) if k >= 0}
        have = {(int(k), int(f)) for k, f in zip(got_kf[p], got_ft[p]) if k >= 0}
        if len(want) < tmap.OBS_W and want != have:
            assert have <= want, (p, have - want)
            n_mismatch += 1
    assert n_mismatch <= 0.15 * len(valid_pts)


def test_keyframe_pass_matches(seq):
    """The whole event from the snapshot before it: summary, statistics
    (against the stage recomposition of the same snapshot), every field,
    the table invariants, and the event's two host reads."""
    Tcw, matched, i, ts = seq["event"]
    tmo.HOST_READS["count"] = 0
    m, culled, summary = tmo.keyframe_pass(seq["tcfg"], _port(seq["m_pre"]), seq["tf"][i],
                                           _t(Tcw), _t(matched), i, ts)
    assert tmo.HOST_READS["count"] == 2
    np.testing.assert_array_equal(summary[:4].numpy(), np.asarray(seq["summary"]))
    m_in, kf_j = jmo.insert_keyframe(seq["jcfg"], ref.copy_map(seq["m_pre"]),
                                     ref.jax_frame(seq["tf"][i]), Tcw, matched, i, ts,
                                     update_stats=False, table_fresh=True)
    st = ref.jax_mapping_stages(seq["jcfg"], m_in, kf_j)
    ref.assert_same_map(st["out"], seq["m_kf"], "stages vs keyframe_pass")
    np.testing.assert_array_equal(summary[4:].numpy(), [st["n_new"], st["n_replaced"],
                                                        st["n_outliers"], st["n_culled"],
                                                        len(st["rounds"])])
    assert not culled.any() and int(summary[4]) > 0
    _assert_map(m, seq["m_kf"], close=(("kf_pose", 1e-4), ("pt_pos", 1e-3),
                                       ("pt_normal", 1e-4), ("pt_max_dist", 1e-3),
                                       ("pt_min_dist", 1e-3)))
    _table_invariants(m)
    # mapping_pass alone, on the map with the keyframe inserted
    m2, culled2 = tmo.mapping_pass(seq["tcfg"], _port(m_in), torch.tensor(int(kf_j)))
    np.testing.assert_array_equal(culled2.numpy(), np.asarray(st["culled"]))
    _assert_map(m2, st["out"], close=(("kf_pose", 1e-4), ("pt_pos", 1e-3), ("pt_normal", 1e-4),
                                      ("pt_max_dist", 1e-3), ("pt_min_dist", 1e-3)))
