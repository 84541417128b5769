"""The port's tracking / mapping split (`SlamSystem(pipeline_depth > 0,
mapping_device=...)`, `pipeline/system.py`) on the CPU, against the JAX
package's split and against the port's own stream (the counterparts of
`tests/test_pipeline_split.py`): every keyframe's mapping pass runs on the
split's worker thread while the stream goes on tracking against the map as
it was, and the next retire adopts the pass's map. On the CPU the worker
runs the twins with no CUDA stream (the card's two streams are
`tests/test_torch_kernels_gpu.py`'s and `chip_smoke.py`'s).

The sequence is tests/test_torch_system.py's plane world (320x240, 400
features), 24 frames of `lateral_trajectory` at 8 cm a frame: long enough
for the natural policy to insert keyframes, short enough for tier-1. At
10-15 cm a frame the split loses a frame right after a correction: the
corrected retire restarts tracking from the keyframe's frame, which the
adoption delay leaves 3-4 frames behind; the reference's split loses the
same frame (ROADMAP Queue 3).

Against the reference: the JAX `SlamSystem(pipeline_depth=2,
mapping_device=jax.devices()[1])` (conftest's virtual CPU devices), handed
the port's frames through its frame-given path as in
tests/test_torch_system.py, with and without a correction at an adoption.
Required: the same state after every call, the same keyframe frames (the
split inserts one the stream does not: a frame tracked before the adoption
sees the map without the pass's points), every pass adopted, camera
centres within tests/test_torch_system.py's 1e-3 m. Against the stream,
the reference test's bounds: the split's ATE below max(3x the stream's,
3 cm) (the two differ by the one-event adoption delay), keyframes within
3, the map on the tracking device.
"""
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import system as jsystem
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig

from orb_slam2_tpu_torch.ops import cuda_ba, cuda_pose, launch
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.pipeline import loop_closing, system as tsystem
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils.config import device_table
from orb_slam2_tpu_torch.utils.synthetic import PlaneWorld, lateral_trajectory
from orb_slam2_tpu_torch.utils.trajectory import ate_rmse

torch.set_num_threads(2)
N_FRAMES, STEP, DEPTH = 24, 0.08, 2
CENTRE_TOL = 1e-3           # m, tests/test_torch_system.py's


@pytest.fixture(scope="module")
def seq():
    fx = 300.0
    jcfg = jconfig.SlamConfig(
        fx=fx, fy=fx, cx=160.0, cy=120.0, width=320, height=240, n_features=400, fps=10.0,
        th_depth=60.0, sensor=jconfig.SENSOR_RGBD, bf=fx * 0.1, max_keyframes=32,
        max_map_points=1 << 13, ba_local_cams=8, ba_fixed_cams=8, ba_max_points=1 << 10,
        ba_max_obs=6, max_local_keyframes=16, max_local_points=1 << 11, use_pallas=0)
    cfg = convert.config_from_jax(jcfg)
    world = PlaneWorld(cfg.fx, cfg.fy, cfg.cx, cfg.cy, 320, 240, z0=4.0)
    gt = lateral_trajectory(N_FRAMES, step=STEP, yaw_rate=0.004)
    return cfg, gt, [world.render_with_depth(T) for T in gt], jcfg


def _run(cfg, frames, mapping_device=None, loop_closing_on=False, states=None):
    s = tsystem.SlamSystem(cfg, enable_loop_closing=loop_closing_on, pipeline_depth=DEPTH,
                           mapping_device=mapping_device, device="cpu")
    for i, (img, depth) in enumerate(frames):
        s.track_rgbd(img, depth, i / cfg.fps)
        if states is not None:
            states.append(s.state)
    s.flush()
    return s


def _jax_run(jcfg, cfg, frames, loop_closing_on, states, monkeypatch):
    """The reference's split on the port's frames: its track_rgbd with the
    frame handed in (the stream's step patched to take the frame as its
    images)."""
    monkeypatch.setattr(jts, "full_tracking_step_from_images",
                        lambda c, m, f, *rest: jts.full_tracking_step(c, m, f, *rest[:-1]))
    s = jsystem.SlamSystem(jcfg, enable_loop_closing=loop_closing_on, pipeline_depth=DEPTH,
                           mapping_device=jax.devices()[1])
    for i, (img, depth) in enumerate(frames):
        f = jframe.FrameData(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(
            tframe.make_frame_rgbd(torch.from_numpy(img), torch.from_numpy(depth), cfg)).items()})
        if s.state == jsystem.OK:
            s._track_stream(f, i / cfg.fps, "rgbd")
        else:
            s._flush_pipeline()
            s._track(f, i / cfg.fps)
        states.append(s.state)
    s.flush()
    return s


def _kf_frames(s):
    return sorted(e["frame"] for e in s.metrics if e.get("kf"))


@pytest.mark.parametrize("correction", [False, True], ids=["plain", "correction"])
def test_split_matches_reference(seq, correction, monkeypatch):
    """The port's split against the JAX package's on the same frames; with
    `correction` the periodic global BA every 2 keyframes corrects the poses
    at adoptions (loop closing on), the reference's drain branch."""
    cfg, gt, frames, jcfg = seq
    if correction:
        cfg = dataclasses.replace(cfg, gba_every_n_kf=2, gba_total_iters=4)
        jcfg = dataclasses.replace(jcfg, gba_every_n_kf=2, gba_total_iters=4)
    j_states, t_states = [], []
    js = _jax_run(jcfg, cfg, frames, correction, j_states, monkeypatch)
    ts = _run(cfg, frames, mapping_device="cpu", loop_closing_on=correction, states=t_states)
    assert t_states == j_states and all(st == tsystem.OK for st in t_states), (t_states, j_states)
    assert _kf_frames(ts) == _kf_frames(js) and len(_kf_frames(ts)) >= 2, (_kf_frames(ts),
                                                                            _kf_frames(js))
    assert int(ts.m.n_keyframes) == int(js.m.n_keyframes)
    np.testing.assert_array_equal(ts.m.kf_frame_id.numpy(), np.asarray(js.m.kf_frame_id))
    assert ts.n_mapping_adopted == ts.n_mapping_dispatched == len(_kf_frames(ts))
    assert ts._pending_mapping is None and js._pending_mapping is None
    tt, jt = ts.get_trajectory(), js.get_trajectory()
    assert [t for t, _ in tt] == [t for t, _ in jt] and len(tt) == len(gt)
    dc = max(np.linalg.norm(a[:3, 3] - b[:3, 3]) for (_, a), (_, b) in zip(tt, jt))
    assert dc <= CENTRE_TOL, dc


def _ate(s, cfg, gt):
    traj = s.get_trajectory()
    assert len(traj) >= 0.95 * len(gt), f"tracked {len(traj)}/{len(gt)}"
    return ate_rmse(traj, [(i / cfg.fps, T) for i, T in enumerate(gt)])


def test_split_matches_single_device(seq):
    cfg, gt, frames, _ = seq
    one = _run(cfg, frames)
    two = _run(cfg, frames, mapping_device="cpu")
    ate_one, ate_two = _ate(one, cfg, gt), _ate(two, cfg, gt)
    assert ate_two < max(3.0 * ate_one, 0.03), (ate_two, ate_one)
    # the passes ran on the worker and were adopted at a later retire
    assert two.n_mapping_dispatched >= 2
    assert two.n_mapping_adopted == two.n_mapping_dispatched
    assert one.n_mapping_dispatched == 0
    assert two.stage_ms.get("mapping_adopt_wall") is not None
    assert two._pending_mapping is None
    assert abs(int(two.m.n_keyframes) - int(one.m.n_keyframes)) <= 3
    assert two.m.kf_pose.device == torch.device("cpu")


def test_split_survives_pose_correction(seq, monkeypatch):
    """The periodic global BA every 2 keyframes corrects the poses at an
    adoption: the retire drains the frames in flight, restarts from the
    keyframe and returns its pose (the reference's IndexError guard)."""
    cfg, gt, frames, _ = seq
    cfg = dataclasses.replace(cfg, gba_every_n_kf=2, gba_total_iters=4)
    calls = []
    run_gba = loop_closing.run_global_ba

    def counted(*args, **kw):
        calls.append(1)
        return run_gba(*args, **kw)

    monkeypatch.setattr(loop_closing, "run_global_ba", counted)
    s = _run(cfg, frames, mapping_device="cpu", loop_closing_on=True)
    traj = s.get_trajectory()
    assert len(traj) >= 0.9 * len(gt), f"tracked {len(traj)}/{len(gt)}"
    assert calls and int(s.m.n_keyframes) >= 3
    assert s.n_mapping_adopted == s.n_mapping_dispatched >= 2
    assert all(e["state"] == "OK" for e in s.metrics)


def test_launch_counter_and_tables_across_threads():
    """The split launches from two host threads: under many threads and a
    short switch interval the launch counter loses no count, and each
    cached device table is built once and shared."""
    n_threads, n = 16, 2000
    tables = [None] * n_threads
    dev = torch.device("cpu")

    def work(i):
        for _ in range(n):
            launch.count("proj_match")
        tables[i] = (device_table((1.0, 2.0, 3.0 + i % 2), dev), device_table((7.0,), dev),
                     cuda_pose.triangle(dev), cuda_ba.symmetric_index(6, dev))

    launch.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert launch.LAUNCHES["proj_match"] == n_threads * n
    for k in range(1, 4):
        assert all(t[k] is tables[0][k] for t in tables)
    assert all(t[0] is tables[i % 2][0] for i, t in enumerate(tables))
    assert not torch.equal(tables[0][0], tables[1][0])
    launch.reset_launches()
    assert not any(launch.LAUNCHES.values())
