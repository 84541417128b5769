"""The port's map state, keyframe insertion, local-map selection and the
whole tracking step (`orb_slam2_tpu_torch/mapstate/map.py`,
`pipeline/mapping_ops.py`, `pipeline/tracking_ops.py`,
`pipeline/tracking_step.py`) against the JAX reference on the CPU, at a small
size: 240x320 RGB-D, 300 features, 8 keyframes, 4096 points, 1024 local
points.

The frames are rendered from the plate world and extracted once by the
port; both packages get the same FrameData. The JAX reference builds the
map (RGB-D initialization on frame 0, one tracked frame, a keyframe
inserted from it); the port is handed the same snapshots.

Tolerances, and why:
- conversion round trip, integer and bool fields of an inserted keyframe,
  local-map selection: exact;
- float fields of an inserted keyframe: 1e-5 absolute (positions and
  normals of points ~5 m away in float32);
- the whole step: Tcw within 1e-3 (the pose solves differ in LU rounding
  and summation order), the ok flag and the branch scalars equal, inlier
  counts within 1 %, >= 99 % of the keypoints bound to the same map point.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.mapstate import map as jmap
from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import mapping_ops as jmo
from orb_slam2_tpu.pipeline import tracking_ops as jto
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig

from orb_slam2_tpu_torch.mapstate import map as tmap
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.pipeline import mapping_ops as tmo
from orb_slam2_tpu_torch.pipeline import tracking_ops as tto
from orb_slam2_tpu_torch.pipeline import tracking_step as tts
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
H, W, FX = 240, 320, 260.0
CAPS = dict(max_keyframes=8, max_map_points=4096, max_local_points=1024)


def _cfgs():
    kw = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H, bf=0.25 * FX,
              sensor=jconfig.SENSOR_RGBD, fps=30.0, th_depth=40.0, n_features=300,
              **CAPS)
    jcfg = jconfig.SlamConfig(use_pallas=0, **kw)
    return jcfg, convert.config_from_jax(jcfg)


def _jframe(f):
    return jframe.FrameData(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(f).items()})


def _jlast(cfg, m, f, Tcw, matched):
    """The next frame's inputs after a keyframe (SlamSystem._set_last):
    bound map points, plus close-depth points of the unbound keypoints."""
    P = m.capacity_pt
    pos = m.pt_pos[jnp.clip(matched, 0, P - 1)]
    has = (matched >= 0) & m.pt_valid[jnp.clip(matched, 0, P - 1)]
    z = jnp.maximum(f.depth, 1e-6)
    pc = jnp.stack([(f.xy[:, 0] - cfg.cx) / cfg.fx * z, (f.xy[:, 1] - cfg.cy) / cfg.fy * z,
                    z], -1)
    pw = jts.se3.apply(jts.se3.inverse(Tcw), pc)
    temporal = (f.depth > 0) & (f.depth < cfg.th_depth * cfg.baseline) & ~has & f.valid
    return jnp.where(temporal[:, None], pw, pos), has | temporal


@pytest.fixture(scope="module")
def seq():
    """JAX snapshots: the initialized map, one tracked frame, the map with
    a keyframe inserted from it, and the inputs of the next step."""
    jcfg, tcfg = _cfgs()
    world = tsyn.PlateWorld(FX, FX, W / 2, H / 2, W, H, z0=5.0)
    poses = tsyn.loop_trajectory(181, radius=3.0, overshoot=0.5, spiral=0.12)[:3]
    tf = []
    for T in poses:
        gray, depth = world.render_with_depth(T)
        gray = np.clip(np.round(gray), 0, 255).astype(np.uint8)
        tf.append(tframe.make_frame_rgbd(torch.from_numpy(gray), torch.from_numpy(depth), tcfg))
    jf = [_jframe(f) for f in tf]
    N = jcfg.max_keypoints
    eye = jnp.eye(4, dtype=jnp.float32)
    none = jnp.full((N,), -1, jnp.int32)
    m0 = jmap.empty(jcfg.max_keyframes, jcfg.max_map_points, N)
    m1, kf0 = jmo.insert_keyframe(jcfg, m0, jf[0], eye, none, 0, 0.0, all_depth=True)
    lm1 = m1.kf_obs[kf0]
    lp1, lpv1 = _jlast(jcfg, m1, jf[0], eye, lm1)
    step1 = (jf[0], lp1, lpv1, lm1, eye, eye, jnp.asarray(False), kf0, 30)
    r1 = jts.full_tracking_step(jcfg, jax.tree.map(jnp.copy, m1), jf[1], *step1)
    m2, kf1 = jmo.insert_keyframe(jcfg, r1.m, jf[1], r1.Tcw, r1.matched_pt, 1, 1 / 30)
    lm2 = m2.kf_obs[kf1]
    lp2, lpv2 = _jlast(jcfg, m2, jf[1], r1.Tcw, lm2)
    step2 = (jf[1], lp2, lpv2, lm2, r1.Tcw, r1.next_vel, jnp.asarray(True), kf1, 30)
    r2 = jts.full_tracking_step(jcfg, jax.tree.map(jnp.copy, m2), jf[2], *step2)
    return dict(jcfg=jcfg, tcfg=tcfg, tf=tf, jf=jf, m0=m0, m1=m1, kf0=kf0, r1=r1,
                m2=m2, kf1=kf1, step2=step2, r2=r2)


def _fields_equal(got: dict, want, atol=1e-5):
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_mapstate_and_result_round_trip(seq):
    m = convert.mapstate_from_numpy(seq["m2"], device="cpu")
    assert len(tmap.MapState._fields) == len(jmap.MapState._fields) == 31
    assert m.kf_desc.dtype == torch.int32 and m.pt_desc.dtype == torch.int32
    _fields_equal(convert.mapstate_to_numpy(m), seq["m2"], atol=0)
    r = convert.track_result_from_numpy(seq["r1"], device="cpu")
    back = convert.track_result_to_numpy(r)
    _fields_equal(back["m"], seq["r1"].m, atol=0)
    _fields_equal(back["frame"], seq["r1"].frame, atol=0)
    for name in ("Tcw", "matched_pt", "next_pts", "scalars", "next_vel"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(seq["r1"], name)))
    empty = tmap.empty(8, 64, 32, device="cpu")
    for name in tmap.MapState._fields:              # the same record, empty
        w = np.asarray(getattr(jmap.empty(8, 64, 32), name))
        g = convert.mapstate_to_numpy(empty)[name]
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("all_depth", [True, False])
def test_insert_keyframe_matches(seq, all_depth):
    """RGB-D initialization (all_depth) on the empty map, and a keyframe
    from the tracked frame 1 (its matches bound, the 100 nearest / close
    unmatched features spawning points) on the initialized map."""
    tcfg, jcfg = seq["tcfg"], seq["jcfg"]
    if all_depth:
        m_in, i, Tcw = seq["m0"], 0, np.eye(4, dtype=np.float32)
        matched = np.full((jcfg.max_keypoints,), -1, np.int32)
        want, kf = seq["m1"], seq["kf0"]
    else:
        m_in, i, Tcw, matched = seq["r1"].m, 1, seq["r1"].Tcw, seq["r1"].matched_pt
        want, kf = seq["m2"], seq["kf1"]
    m, kf_t = tmo.insert_keyframe(tcfg, convert.mapstate_from_numpy(m_in, device="cpu"), seq["tf"][i],
                                  torch.from_numpy(np.array(Tcw)),
                                  torch.from_numpy(np.array(matched)), i, i / 30,
                                  all_depth=all_depth)
    assert int(kf_t) == int(kf)
    _fields_equal(convert.mapstate_to_numpy(m), want)
    assert int(m.n_points) > int(m_in.n_points) + 50


def test_select_local_map_exact(seq):
    r1, m2 = seq["r1"], seq["m2"]
    want = jto.select_local_map(m2, r1.matched_pt, max_kf=8, max_pts=1024)
    got = tto.select_local_map(convert.mapstate_from_numpy(m2, device="cpu"),
                               torch.from_numpy(np.array(r1.matched_pt)), max_kf=8,
                               max_pts=1024)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[4].sum()) > 200                 # a populated local map


def test_step_matches_reference(seq):
    """One JAX snapshot (two keyframes) and one frame through both
    `_step`s: the motion model, local-map search and pose solves."""
    tcfg, r2 = seq["tcfg"], seq["r2"]
    last, lp, lpv, lm, T_last, vel, has_vel, ref_kf, min_inl = seq["step2"]
    tt = lambda a: torch.from_numpy(np.array(a))
    tts.HOST_READS["count"] = 0
    got = tts.full_tracking_step(
        tcfg, convert.mapstate_from_numpy(seq["m2"], device="cpu"), seq["tf"][2],
        convert.frame_from_numpy(last, device="cpu"), tt(lp), tt(lpv), tt(lm), tt(T_last), tt(vel),
        bool(has_vel), tt(ref_kf), min_inl)
    assert tts.HOST_READS["count"] == 2             # the two branch decisions
    sc_g, sc_w = got.scalars.numpy(), np.asarray(r2.scalars)
    assert sc_g[0] == sc_w[0] == 1                  # ok
    np.testing.assert_array_equal(sc_g[[7, 8, 9]], sc_w[[7, 8, 9]])   # branches, ref KF
    assert sc_g[10] == 0                            # no wide-window retry
    for k in (1, 2, 3):                             # matches and inlier counts
        assert abs(int(sc_g[k]) - int(sc_w[k])) <= 0.01 * int(sc_w[k]), k
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(r2.Tcw), rtol=0, atol=1e-3)
    same = got.matched_pt.numpy() == np.asarray(r2.matched_pt)
    bound = np.asarray(r2.matched_pt) >= 0
    assert same.mean() >= 0.99 and bound.sum() > 100
    np.testing.assert_allclose(got.next_vel.numpy(), np.asarray(r2.next_vel), atol=1e-3)
    assert int(got.m.pt_found.sum()) == pytest.approx(int(np.asarray(r2.m.pt_found).sum()),
                                                      rel=0.01)
