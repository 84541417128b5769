"""A loop closure through the port's `SlamSystem` against the JAX reference's,
with drift injected into the sensor (marked slow; the CPU twins).

`tests/test_loop_e2e.py`'s revisit sequence (PlateWorld 320x240, one lap
of `loop_trajectory` and a third of another, RGB-D) through a depth sensor
whose scale creeps up by DEPTH_CREEP per frame: the map built late in the
lap is stretched against the map built early, so the revisit cannot be
tracked back into the old map and a closure must fire (without the creep
the drift can stay small enough for the revisit to remain covisible, and
then no loop is a correct outcome: `tests/test_hard_synthetic.py:85`).
Both systems get the same frames: the port extracts them itself, the
reference is handed the port's frames through its frame-given path.

Required: both close a loop, as many as each other, each closure at the
reference's keyframe sequence number within covis_consistency_th (3) with
the reference's candidate or one of its covisible keyframes; the same
tracking states; the port's ATE within 2x the reference's + 1 cm, and
below the reference test's 35 cm bound.
"""
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
from orb_slam2_tpu_torch.utils.synthetic import PlateWorld, loop_trajectory

N_FRAMES = 130
DEPTH_CREEP = 4e-4     # the depth's scale error grows by this much per frame (5 % at the end)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _recording(monkeypatch, module, out, owner):
    """Record each closure: the keyframe sequence number of owner[0] (the
    system), the keyframe's and the candidate's frames, the candidate's
    covisible keyframes' frames."""
    correct = module.correct_loop

    def record(cfg, m, kf_id, cand_id, Scm, **kw):
        fid = _np(m.kf_frame_id)
        nb = (_np(m.covis)[cand_id] > 0) & _np(m.kf_valid)
        out.append(dict(kf_seq=owner[0]._kf_seq_host, kf_frame=int(fid[kf_id]),
                        cand_frame=int(fid[cand_id]), neighbours={int(f) for f in fid[nb]}))
        return correct(cfg, m, kf_id, cand_id, Scm, **kw)

    monkeypatch.setattr(module, "correct_loop", record)


@pytest.mark.slow
def test_loop_closure_with_injected_drift_matches_reference(monkeypatch):
    fx = 300.0
    jcfg = jconfig.SlamConfig(
        fx=fx, fy=fx, cx=160.0, cy=120.0, width=320, height=240, n_features=500,
        bf=fx * 0.25, sensor=jconfig.SENSOR_RGBD, fps=10.0, th_depth=40.0, max_keyframes=128,
        max_map_points=1 << 14, ba_local_cams=16, ba_fixed_cams=16, ba_max_points=1 << 11,
        ba_max_obs=8, max_local_keyframes=32, max_local_points=1 << 12, use_pallas=0)
    tcfg = convert.config_from_jax(jcfg)
    world = PlateWorld(fx, fx, 160.0, 120.0, 320, 240, z0=5.0)
    gt = loop_trajectory(N_FRAMES, radius=3.0)
    images = []
    for i, T in enumerate(gt):
        gray, depth = world.render_with_depth(T)
        images.append((gray, (depth * (1.0 + DEPTH_CREEP * i)).astype(np.float32)))

    monkeypatch.setattr(jts, "full_tracking_step_from_images",
                        lambda cfg, m, f, *rest: jts.full_tracking_step(cfg, m, f, *rest[:-1]))
    jclosures, tclosures, jown, town = [], [], [None], [None]
    _recording(monkeypatch, jlc, jclosures, jown)
    _recording(monkeypatch, tlc, tclosures, town)
    js = jown[0] = jsystem.SlamSystem(jcfg)
    ts = town[0] = tsystem.SlamSystem(tcfg, device="cpu")
    states = []
    for i, (gray, depth) in enumerate(images):
        t = i / tcfg.fps
        ts.track_rgbd(gray, depth, t)
        f = tframe.make_frame_rgbd(torch.from_numpy(gray), torch.from_numpy(depth), tcfg)
        jf = jframe.FrameData(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(f).items()})
        if js.state != jsystem.OK:
            js._flush_pipeline()
        js._track(jf, t)
        states.append((ts.state, js.state))
    js.flush()
    ts.flush()

    assert all(a == b for a, b in states), states
    assert js.n_loops_closed >= 1 and ts.n_loops_closed == js.n_loops_closed
    for c, r in zip(tclosures, jclosures):
        assert abs(c["kf_seq"] - r["kf_seq"]) <= tcfg.covis_consistency_th, (tclosures, jclosures)
        assert (c["cand_frame"] == r["cand_frame"] or c["cand_frame"] in r["neighbours"] or
                r["cand_frame"] in c["neighbours"]), (tclosures, jclosures)
    gtt = [(i / tcfg.fps, T) for i, T in enumerate(gt)]
    tt, jt = ts.get_trajectory(), js.get_trajectory()
    assert len(tt) == len(jt) >= 0.95 * N_FRAMES
    ate_t, ate_j = ttraj.ate_rmse(tt, gtt), ttraj.ate_rmse(jt, gtt)
    assert ate_t <= 2 * ate_j + 0.01 and ate_t < 0.35, (ate_t, ate_j)
    edges = {tuple(e) for e in ts.m.loop_edges.tolist()}
    assert all((c["kf"], c["cand"]) in edges for c in ts.loop_closures)
