"""The port's `SlamSystem` (`pipeline/system.py`, device="cpu") against the
JAX reference's on the same RGB-D sequence: the natural keyframe policy,
the pipelined stream, relocalization after a kidnap, reset, with loop
closing on (the reference's default).

The sequence is the plane world of tests/test_e2e.py (320x240, 400
features, its small caps), 12 frames of `lateral_trajectory` with a step
wide enough for the natural policy to insert keyframes (frames 9 and 11 of
the sync lap); the vocabulary is trained on the fly, loop closing is off.
Both systems see the same frames: the port extracts them from the images
(its own front end, `track_rgbd`), and the reference is handed the port's
frames converted (`utils/convert.py`) through its frame-given tracking
path, so the comparison starts from the same keypoints. Loop detection
runs on every keyframe once the vocabulary exists (loop_kf_gap = 0), so
both sides' candidate lists, consistency groups and closures are compared
too (the lateral sequence closes no loop).

Required, and why these bounds: the same state after every frame and the
same keyframe frames and count (integer decisions); local-map inliers per
frame within 1 % (measured equal); camera centres within
1e-3 m (the two pose solves sum float32 in other orders; the centres part
by 1.1e-4 m on the sync lap, 2.8e-4 m in the stream); after a kidnap, relocalization to the same keyframe within
5 cm of the truth (tests/test_e2e.py:43-66), each side with its own RANSAC
draws; `reset()` leaving the same fields.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import loop_closing as jlc
from orb_slam2_tpu.pipeline import system as jsystem
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig

from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import trajectory as ttraj
from orb_slam2_tpu_torch.utils.synthetic import PlaneWorld, lateral_trajectory

torch.set_num_threads(2)
N_FRAMES, STEP, REVISIT = 12, 0.15, 4
CENTRE_TOL = 1e-3


def _cfgs():
    fx = 300.0
    jcfg = jconfig.SlamConfig(
        fx=fx, fy=fx, cx=160.0, cy=120.0, width=320, height=240, n_features=400, fps=10.0,
        th_depth=60.0, sensor=jconfig.SENSOR_RGBD, bf=fx * 0.1, max_keyframes=32,
        max_map_points=1 << 13, ba_local_cams=8, ba_fixed_cams=8, ba_max_points=1 << 10,
        ba_max_obs=6, max_local_keyframes=16, max_local_points=1 << 11, loop_kf_gap=0,
        use_pallas=0)
    return jcfg, convert.config_from_jax(jcfg)


@pytest.fixture(scope="module")
def seq():
    jcfg, tcfg = _cfgs()
    world = PlaneWorld(tcfg.fx, tcfg.fy, tcfg.cx, tcfg.cy, 320, 240, z0=4.0)
    gt = lateral_trajectory(N_FRAMES, step=STEP, yaw_rate=0.004)
    images = [world.render_with_depth(T) for T in gt + [gt[REVISIT]]]
    frames = [jframe.FrameData(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(
        tframe.make_frame_rgbd(torch.from_numpy(g), torch.from_numpy(d), tcfg)).items()})
              for g, d in images]
    return dict(jcfg=jcfg, tcfg=tcfg, gt=gt, images=images, frames=frames)


def _jax_track(s, f, ts):
    """The reference's track_rgbd with the frame handed in: its
    frame-given step in place of the extraction (the stream's step is
    patched to take the frame as its images)."""
    if s.state == jsystem.OK:
        if s.pipeline_depth > 0:
            return s._track_stream(f, ts, "rgbd")
        return s._track(f, ts)
    s._flush_pipeline()
    return s._track(f, ts)


def _recording(monkeypatch, module, calls):
    """Record each loop detection's candidates (keyframe ids) past
    ComputeSim3's first gate: the reference gates them in its dispatch, the
    port on the host's copy (`bow_gate`)."""
    name = "bow_gate" if module is tlc else "detect_loop_dispatch"
    step = getattr(module, name)

    def record(*args):
        cands = step(*args)
        calls.append([int(c) for c in np.asarray(cands) if c >= 0])
        return cands

    monkeypatch.setattr(module, name, record)


def _run(seq, depth, monkeypatch):
    monkeypatch.setattr(jts, "full_tracking_step_from_images",
                        lambda cfg, m, f, *rest: jts.full_tracking_step(cfg, m, f, *rest[:-1]))
    jcalls, tcalls = [], []
    _recording(monkeypatch, jlc, jcalls)
    _recording(monkeypatch, tlc, tcalls)
    js = jsystem.SlamSystem(seq["jcfg"], pipeline_depth=depth)
    ts = tsystem.SlamSystem(seq["tcfg"], pipeline_depth=depth, device="cpu")
    js.detections, ts.detections = jcalls, tcalls
    states, outs = [], []
    for i in range(N_FRAMES):
        t = i / seq["tcfg"].fps
        jo = _jax_track(js, seq["frames"][i], t)
        to = ts.track_rgbd(*seq["images"][i], t)
        states.append((ts.state, js.state))
        outs.append((to is None, to is tsystem.PENDING, jo is None, jo is jsystem.PENDING))
    js.flush()
    ts.flush()
    return js, ts, states, outs


def _kf_frames(s):
    return sorted(e["frame"] for e in s.metrics if e.get("kf"))


def _compare(js, ts, states, outs, gt, fps):
    assert all(a == b for a, b in states), states
    # loop closing: the same detections call by call, groups and closures
    assert ts.detections == js.detections and len(ts.detections) >= 1
    assert ts.n_loops_closed == js.n_loops_closed == 0
    np.testing.assert_array_equal(ts.loop_state.groups.numpy(), np.asarray(js.loop_state.groups))
    np.testing.assert_array_equal(ts.loop_state.cons.numpy(), np.asarray(js.loop_state.cons))
    np.testing.assert_array_equal(ts.m.loop_edges.numpy(), np.asarray(js.m.loop_edges))
    assert all(o[:2] == o[2:] for o in outs), outs
    assert _kf_frames(ts) == _kf_frames(js) and len(_kf_frames(ts)) >= 1
    assert [e["frame"] for e in ts.metrics] == [e["frame"] for e in js.metrics]
    for a, b in zip(ts.metrics, js.metrics):
        assert abs(a["inliers"] - b["inliers"]) <= 0.01 * b["inliers"], (a, b)
    assert int(ts.m.n_keyframes) == int(js.m.n_keyframes) == 1 + len(_kf_frames(ts))
    np.testing.assert_array_equal(ts.m.kf_frame_id.numpy(), np.asarray(js.m.kf_frame_id))
    tt, jt = ts.get_trajectory(), js.get_trajectory()
    assert [t for t, _ in tt] == [t for t, _ in jt] and len(tt) == len(gt)
    dc = max(np.linalg.norm(a[:3, 3] - b[:3, 3]) for (_, a), (_, b) in zip(tt, jt))
    assert dc <= CENTRE_TOL, dc
    gtt = [(i / fps, T) for i, T in enumerate(gt)]
    return ttraj.ate_rmse(tt, gtt), ttraj.ate_rmse(jt, gtt)


@pytest.fixture(scope="module")
def sync_lap(seq):
    mp = pytest.MonkeyPatch()
    try:
        yield _run(seq, 0, mp)
    finally:
        mp.undo()


def test_sync_lap_matches_reference(seq, sync_lap):
    js, ts, states, outs = sync_lap
    ate_t, ate_j = _compare(js, ts, states, outs, seq["gt"], seq["tcfg"].fps)
    assert ate_t < 0.05 and abs(ate_t - ate_j) < CENTRE_TOL
    assert ts.voc is not None and ts.voc.n_words == js.voc.n_words
    assert np.array_equal(ts.voc.word_id.numpy(), np.asarray(js.voc.word_id))
    stats_t, stats_j = ts.get_map_stats(), js.get_map_stats()
    for k in ("n_keyframes", "state", "frame_id", "n_loops_closed"):
        assert stats_t[k] == stats_j[k], k
    assert abs(stats_t["n_map_points"] - stats_j["n_map_points"]) <= 0.01 * stats_j["n_map_points"]
    np.testing.assert_array_equal(ts.get_tracked_keypoints_un()[1],
                                  js.get_tracked_keypoints_un()[1])
    same = (ts.get_tracked_map_points() == js.get_tracked_map_points()).mean()
    assert same >= 0.99, same


def test_stream_depth_2_matches_reference(seq, monkeypatch):
    js, ts, states, outs = _run(seq, 2, monkeypatch)
    assert sum(o[1] for o in outs) == 2            # the first two frames in flight
    ate_t, _ = _compare(js, ts, states, outs, seq["gt"], seq["tcfg"].fps)
    assert ate_t < 0.05


def test_kidnap_relocalizes_to_the_same_keyframe(seq, sync_lap):
    js, ts, _, _ = sync_lap
    js.state = jsystem.LOST
    ts.state = tsystem.LOST
    t = 99.0
    T_t = ts.track_rgbd(*seq["images"][N_FRAMES], t)
    T_j = _jax_track(js, seq["frames"][N_FRAMES], t)
    assert T_t is not None and T_j is not None
    assert ts.state == js.state == tsystem.OK
    assert ts.ref_kf == js.ref_kf and ts.last_reloc_frame_id == js.last_reloc_frame_id
    truth = seq["gt"][REVISIT][:3, 3]
    for T in (T_t, T_j):
        assert np.linalg.norm(np.linalg.inv(T)[:3, 3] - truth) < 0.05
    assert ts.trajectory[-1].ref_kf == js.trajectory[-1].ref_kf and not ts.trajectory[-1].lost


FIELDS = ("state", "velocity", "last_frame", "ref_kf", "last_kf_frame_id",
          "last_reloc_frame_id", "trajectory", "_kf_seq_host", "_kf_blackout_fid",
          "_n_kf_host", "_chain")


def test_reset_clears_the_same_fields(seq, monkeypatch):
    js, ts, _, _ = _run(seq, 2, monkeypatch)
    js.reset()
    ts.reset()
    for name in FIELDS:
        assert getattr(ts, name) == getattr(js, name), name
    assert len(ts._pending) == len(js._pending) == 0
    assert int(ts.m.n_keyframes) == int(js.m.n_keyframes) == 0 and int(ts.m.n_points) == 0
    assert not bool(ts.db.valid.any()) and not bool(np.asarray(js.db.valid).any())
    assert ts.get_trajectory() == js.get_trajectory() == []
    # and tracking starts over: the next frame initializes a new map
    ts.track_rgbd(*seq["images"][0], 5.0)
    assert ts.state == tsystem.OK and int(ts.m.n_keyframes) == 1


def test_unported_options_raise(seq):
    cfg = seq["tcfg"]
    # loop closing (item 3) is ported: the default constructs with it on,
    # and so does the periodic global BA
    s = tsystem.SlamSystem(cfg, device="cpu")
    assert s.enable_loop_closing
    tsystem.SlamSystem(dataclasses.replace(cfg, gba_every_n_kf=5), device="cpu")
    # multi-device (item 5) is ported: a mesh and a mapping device construct
    # (tests/test_torch_parallel.py and tests/test_torch_pipeline_split.py
    # hold them against the reference)
    mesh = object()
    assert tsystem.SlamSystem(cfg, gba_mesh=mesh, device="cpu").gba_mesh is mesh
    split = tsystem.SlamSystem(cfg, enable_loop_closing=False, pipeline_depth=2,
                               mapping_device="cpu", device="cpu")
    assert split.mapping_device == torch.device("cpu") and split._mapper is not None
    # monocular and stereo tracking (item 4) are ported: both entry points
    # construct and take a frame (tests/test_torch_mono.py and
    # tests/test_torch_stereo.py hold them against the reference)
    gray = seq["images"][0][0]
    mono = tsystem.SlamSystem(dataclasses.replace(cfg, sensor=jconfig.SENSOR_MONOCULAR, bf=0.0),
                              device="cpu")
    assert mono.track_monocular(gray, 0.0) is None          # the initial frame, kept
    assert mono.init_frame is not None and mono.frame_id == 1
    stereo = tsystem.SlamSystem(dataclasses.replace(cfg, sensor=jconfig.SENSOR_STEREO),
                                device="cpu")
    stereo.track_stereo(gray, gray, 0.0)
    assert stereo.frame_id == 1 and stereo.last_frame is not None
    with pytest.raises(NotImplementedError, match="item 6"):
        s.draw_current_frame(gray)
