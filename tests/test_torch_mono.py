"""The port's monocular path against the JAX reference on the CPU, on the
monocular scene of tests/test_e2e.py:92-104 (the plane world at 320x240,
1000 features, 12 frames of `lateral_trajectory` with a 5 cm step, the
small caps of tests/test_e2e.py), loop closing on with loop_kf_gap 0. The
keypoint capacity is 1024 (the default would be 2048): the doubled
initialization budget is capped there, which still gives the 100 level-0
matches initialization needs (400 features do not), and it keeps the
CPU twins' (N, N) searches small.

Both systems see the same frames: the port extracts them (`track_monocular`,
its own front end, with the doubled budget before initialization) and the
reference is handed each frame the port built, converted, through its
frame-given path; the port's initializer is handed the reference's RANSAC
draws (`jax.random.randint(PRNGKey(frame_id), (200, 8), 0, n_valid)`, the
port's CPU generator seed being the frame id), so both bootstrap from the
same sets.

Held, and why these bounds:
- `search_for_initialization` (K4's window form's twin) on the first two
  frames: indices, distances and validity bit for bit;
- the initial map right after initialization: the keyframes' poses within
  1e-4 and the points within 1e-3 (the two-view BA's float32 sums run in
  another order), every integer field equal;
- the first monocular keyframe event (`keyframe_pass` on the reference's
  snapshot: the median-depth baseline gate, K8 with the epipole gate,
  triangulation without depth, local BA on monocular edges): the summary
  and every integer field equal, floats within the RGB-D event test's
  bounds (poses 1e-4, points and scale bands 1e-3);
- the whole run: the same initialization frame, the same state after
  every frame, the same keyframe frames, local-map inliers within 1 %, Tcw
  within 1e-3 per entry (measured 1.7e-4) and the same number of points
  after every frame. At the default capacity of 2048 keypoints the maps
  part one event after the first monocular keyframe (one triangulation of
  633: the float32 local BA moves low-parallax depths by up to 2.8e-3);
  at 1024 they do not, on this sequence.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import matching as jmatching
from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import mapping_ops as jmo
from orb_slam2_tpu.pipeline import system as jsystem
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig

from orb_slam2_tpu_torch.mapstate import map as tmap
from orb_slam2_tpu_torch.ops import matching as tmatching
from orb_slam2_tpu_torch.pipeline import mapping_ops as tmo
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.pipeline import tracking_step as tts
from orb_slam2_tpu_torch.solvers import initializer as tinit
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import trajectory as ttraj
from orb_slam2_tpu_torch.utils.synthetic import PlaneWorld, lateral_trajectory

from test_torch_initializer import jax_draws

torch.set_num_threads(2)
N_FRAMES, STEP = 12, 0.05
TCW_TOL = 1e-3


def _cfgs():
    fx = 300.0
    jcfg = jconfig.SlamConfig(
        fx=fx, fy=fx, cx=160.0, cy=120.0, width=320, height=240, n_features=1000, fps=10.0,
        th_depth=60.0, sensor=jconfig.SENSOR_MONOCULAR, bf=0.0, max_keypoints=1024,
        max_keyframes=32,
        max_map_points=1 << 13, ba_local_cams=8, ba_fixed_cams=8, ba_max_points=1 << 10,
        ba_max_obs=6, max_local_keyframes=16, max_local_points=1 << 11, loop_kf_gap=0,
        use_pallas=0)
    return jcfg, convert.config_from_jax(jcfg)


def _jax_frame(f):
    return jframe.FrameData(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(f).items()})


def _map_close(got, want, close):
    """The port's MapState against the reference's: integer and bool
    fields exact, float fields within close's tolerance (0 otherwise)."""
    g = convert.mapstate_to_numpy(got)
    for name in tmap.MapState._fields:
        w = np.asarray(getattr(want, name))
        if np.issubdtype(w.dtype, np.floating):
            tol = dict(close).get(name, 0.0)
            np.testing.assert_allclose(g[name], w, rtol=tol, atol=tol, err_msg=name)
        else:
            np.testing.assert_array_equal(g[name], w, err_msg=name)


@pytest.fixture(scope="module")
def run():
    """Both systems over the sequence, synchronously; records the frames
    the port built, the maps after each frame and the reference's
    keyframe events' inputs."""
    jcfg, tcfg = _cfgs()
    mp = pytest.MonkeyPatch()
    built, events = [], []
    try:
        for mod in (tsystem, tts):
            make = mod.make_frame_monocular

            def record(*args, _make=make, **kw):
                built.append(_make(*args, **kw))
                return built[-1]
            mp.setattr(mod, "make_frame_monocular", record)
        init = tinit.initialize

        def keyed(p1, p2, valid, *rest, generator=None, **kw):
            draws = jax_draws(valid.numpy(), key=generator.initial_seed())
            return init(p1, p2, valid, *rest, draws=torch.from_numpy(draws), **kw)
        mp.setattr(tinit, "initialize", keyed)
        mp.setattr(jts, "full_tracking_step_from_images",
                   lambda cfg, m, f, *rest: jts.full_tracking_step(cfg, m, f, *rest[:-1]))
        kf_pass = jmo.keyframe_pass

        def record_event(cfg, m, *args):
            events.append((jax.tree.map(jnp.copy, m), args))
            return kf_pass(cfg, m, *args)
        mp.setattr(jmo, "keyframe_pass", record_event)

        world = PlaneWorld(tcfg.fx, tcfg.fy, tcfg.cx, tcfg.cy, 320, 240, z0=4.0)
        gt = lateral_trajectory(N_FRAMES, step=STEP, yaw_rate=0.0)
        js = jsystem.SlamSystem(jcfg)
        ts = tsystem.SlamSystem(tcfg, device="cpu")
        states, frames, maps, tcw = [], [], [], []
        for i, T in enumerate(gt):
            t = i / tcfg.fps
            built.clear()
            ts.track_monocular(world.render(T), t)
            frames.append(built[-1])
            if js.state != jsystem.OK:
                js._flush_pipeline()
            js._track(_jax_frame(built[-1]), t)
            states.append((ts.state, js.state))
            maps.append((ts.m, jax.tree.map(jnp.copy, js.m)))   # the next step donates js.m
            tcw.append((ts.last_Tcw, None if js.last_Tcw is None else np.asarray(js.last_Tcw)))
        js.flush()
        ts.flush()
    finally:
        mp.undo()
    return dict(jcfg=jcfg, tcfg=tcfg, gt=gt, js=js, ts=ts, states=states, frames=frames,
                maps=maps, tcw=tcw, events=events)


def _init_frame(states, side):
    return next(i for i, s in enumerate(states) if s[side] == tsystem.OK)


def test_search_for_initialization_bit_exact(run):
    f1, f2 = run["frames"][0], run["frames"][1]
    got = tmatching.search_for_initialization(f1.xy, f1.level, f1.desc, f1.valid, f1.angle,
                                              f2.xy, f2.level, f2.desc, f2.valid, f2.angle)
    j1, j2 = _jax_frame(f1), _jax_frame(f2)
    want = jmatching.search_for_initialization(j1.xy, j1.level, j1.desc, j1.valid, j1.angle,
                                               j2.xy, j2.level, j2.desc, j2.valid, j2.angle)
    assert int(want.valid.sum()) >= 100
    for a, b, name in zip(got, want, ("idx", "dist", "valid")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_initial_map_matches(run):
    i = _init_frame(run["states"], 0)
    assert i == _init_frame(run["states"], 1)
    got, want = run["maps"][i]
    assert int(got.n_keyframes) == 2 and int(got.n_points) >= 100
    _map_close(got, want, (("kf_pose", 1e-4), ("pt_pos", 1e-3), ("pt_normal", 1e-4),
                           ("pt_max_dist", 1e-3), ("pt_min_dist", 1e-3)))
    np.testing.assert_allclose(run["tcw"][i][0], run["tcw"][i][1], atol=1e-4)


def test_first_keyframe_event_matches(run):
    """The reference's first monocular keyframe event, replayed by the
    port on the same snapshot."""
    m_j, (f, Tcw, matched, fid, ts) = run["events"][0]
    want, culled_j, summary_j = jmo.keyframe_pass(run["jcfg"], jax.tree.map(jnp.copy, m_j), f,
                                                  Tcw, matched, fid, ts)
    got, culled, summary = tmo.keyframe_pass(
        run["tcfg"], convert.mapstate_from_numpy(m_j, device="cpu"),
        convert.frame_from_numpy(f, device="cpu"), torch.from_numpy(np.array(Tcw)),
        torch.from_numpy(np.array(matched)), fid, ts)
    np.testing.assert_array_equal(summary[:4].numpy(), np.asarray(summary_j))
    np.testing.assert_array_equal(culled.numpy(), np.asarray(culled_j))
    assert int(want.n_points) > int(m_j.n_points)          # it triangulated
    _map_close(got, want, (("kf_pose", 1e-4), ("pt_pos", 1e-3), ("pt_normal", 1e-4),
                           ("pt_max_dist", 1e-3), ("pt_min_dist", 1e-3)))


def _kf_frames(s):
    return sorted(e["frame"] for e in s.metrics if e.get("kf"))


def test_mono_scene_matches_reference(run):
    js, ts, states = run["js"], run["ts"], run["states"]
    assert all(a == b for a, b in states), states
    assert _init_frame(states, 0) == _init_frame(states, 1) <= 3
    assert _kf_frames(ts) == _kf_frames(js) and len(_kf_frames(ts)) >= 2
    for a, b in zip(ts.metrics, js.metrics):
        assert a["frame"] == b["frame"] and abs(a["inliers"] - b["inliers"]) <= 0.01 * b["inliers"]
    for (a, b), (mt, mj) in zip(run["tcw"], run["maps"]):
        assert int(mt.n_points) == int(mj.n_points)
        if b is not None:
            np.testing.assert_allclose(a, b, atol=TCW_TOL)
    tt, jt = ts.get_trajectory(), js.get_trajectory()
    assert [t for t, _ in tt] == [t for t, _ in jt] and len(tt) >= N_FRAMES - 3
    for (_, a), (_, b) in zip(tt, jt):
        np.testing.assert_allclose(a, b, atol=TCW_TOL)
    gt = [(i / run["tcfg"].fps, T) for i, T in enumerate(run["gt"])]
    ate_t = ttraj.ate_rmse(tt, gt, with_scale=True)
    ate_j = ttraj.ate_rmse(jt, gt, with_scale=True)
    assert ate_t < 0.12 and abs(ate_t - ate_j) < TCW_TOL, (ate_t, ate_j)
