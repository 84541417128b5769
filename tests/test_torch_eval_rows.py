"""EVAL.md's rows in the port (`orb_slam2_tpu_torch/examples/eval_synthetic_hard.row`)
against the JAX evaluation's definitions (`examples/eval_synthetic_hard.py`,
rebuilt here with the JAX package's `synthetic` functions), the torture row's
first frames through both SlamSystems, and the rows' bands
(`chip_smoke.check_row`, which `scripts/chip_eval_rows.py` holds each row to).

Held, and why these bounds:
- each of the nine rows at both sizes: the same ground-truth poses within
  1e-12 (both packages compute them in float64 by the same formulas) and
  the same SlamConfig (the port has no `use_pallas` field); at the small
  size the same ImperfectCamera parameters, the first two frames from
  `row_frames` (its thread pool and noise order) and frame 135 (the last
  frame where the row is shorter) rendered exactly equal, the noise of the
  frames before drawn in order (block-rgbd's after block-stereo's, as the
  evaluation shares one camera between them);
- the torture row's first TORTURE_FRAMES frames at the small size (its
  capacities cut to CAPS) through the port's `run_sequence(device="cpu")`
  and the JAX SlamSystem handed the port's frames
  (tests/test_torch_system.py's pattern): the same state after every frame,
  the same keyframe frames and fallbacks (integer decisions), camera
  centres within 1e-3 m (the pose solves sum float32 in other orders);
- `check_row` accepts the reference's own record and rejects each band's
  violation: 94 % tracked, an extra closure that is not genuine, an ATE over
  2x + 1 cm, keyframes off by 25 %.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import system as jsystem
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig
from orb_slam2_tpu.utils import synthetic as jsyn

from orb_slam2_tpu_torch.examples import eval_synthetic_hard as ev
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import trajectory as ttraj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import chip_eval_rows  # noqa: E402
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(2)
POSE_TOL = 1e-12
CENTRE_TOL = 1e-3
TORTURE_FRAMES = 12     # keyframes at frames 9 and 10 besides the first
# the torture lap's capacities: tests/test_torch_system.py's small caps, so
# both systems run it in seconds on the CPU (at the row's own 8,192 local
# points and 32-camera local BA a frame takes ~1 s there)
CAPS = dict(max_keyframes=32, max_map_points=1 << 13, ba_local_cams=8, ba_fixed_cams=8,
            ba_max_points=1 << 10, ba_max_obs=6, max_local_keyframes=16,
            max_local_points=1 << 11)
FRAME_CHECKED = 135     # the torture row's gain-0.75 trough


def _jax_row(name, small):
    """The JAX evaluation's definition of row `name`
    (`examples/eval_synthetic_hard.py:158-273`): (config, ImperfectCamera,
    poses, sensor, loops on, noise draws before frame 0)."""
    if small:
        W, H, fx, nf = 320, 240, 260.0, 600
        n_survey, n_loop, n_long = 160, 110, 400
    else:
        W, H, fx, nf = 640, 480, 517.3, 1000
        n_survey, n_loop, n_long = 500, 360, 1200
    cx, cy = W / 2, H / 2
    cfg = jconfig.SlamConfig(fx=fx, fy=fx, cx=cx, cy=cy, width=W, height=H, bf=fx * 0.25,
                             sensor=jconfig.SENSOR_RGBD, fps=30.0, th_depth=40.0,
                             n_features=nf, use_pallas=not small, max_keyframes=128,
                             max_map_points=1 << 14)
    mono = dataclasses.replace(cfg, sensor=jconfig.SENSOR_MONOCULAR, bf=0.0)
    big = cfg if small else dataclasses.replace(cfg, max_keyframes=256,
                                                max_map_points=1 << 15)
    plate = lambda **kw: jsyn.PlateWorld(fx, fx, cx, cy, W, H, z0=5.0, **kw)  # noqa: E731
    if name == "survey-rgbd":
        return (cfg, jsyn.ImperfectCamera(plate(extent=14.0, n_plates=300)),
                jsyn.survey_trajectory(n_survey, extent=9.0, rows=6), "rgbd", False, 0)
    if name == "loop-rgbd":
        return (cfg, jsyn.ImperfectCamera(plate()), jsyn.loop_trajectory(n_loop, radius=3.0),
                "rgbd", True, 0)
    if name == "loop-mono":
        return (mono, jsyn.ImperfectCamera(plate(), noise_sigma=2.0),
                jsyn.loop_trajectory(n_loop, radius=3.0), "mono", True, 0)
    if name == "long-forward-rgbd":
        world = plate(extent=30.0, n_plates=900, seed=11)
        return (big, jsyn.ImperfectCamera(world, exposure_amp=0.15, noise_sigma=3.0),
                jsyn.forward_trajectory(n_long, speed=0.08, close_loop=True), "rgbd", True, 0)
    if name == "torture-forward-rgbd":
        world = plate(extent=30.0, n_plates=900, seed=11)
        return (big, jsyn.ImperfectCamera(world, exposure_amp=0.25, noise_sigma=3.0),
                jsyn.forward_trajectory(400 if small else 900, speed=0.12, close_loop=True),
                "rgbd", True, 0)
    if name in ("fig8-rgbd", "fig8-mono"):
        world = plate(extent=14.0, n_plates=400, seed=5)
        gt = jsyn.figure_eight_trajectory(220 if small else 560, radius=3.2)
        if name == "fig8-rgbd":
            return cfg, jsyn.ImperfectCamera(world, noise_sigma=3.0), gt, "rgbd", True, 0
        return mono, jsyn.ImperfectCamera(world, noise_sigma=2.0), gt, "mono", True, 0
    world = jsyn.BlockWorld(fx, fx, cx, cy, W, H)
    gt = jsyn.city_block_trajectory(300 if small else 780, corner_radius=6.0, speed=0.15,
                                    overshoot=0.12)
    cam = jsyn.ImperfectCamera(world, noise_sigma=3.0, exposure_amp=0.15)
    if name == "block-stereo":
        return (dataclasses.replace(cfg, sensor=jconfig.SENSOR_STEREO, bf=fx * 0.5), cam, gt,
                "stereo", True, 0)
    # the evaluation runs block-rgbd through block-stereo's camera
    return cfg, cam, gt, "rgbd", True, 2 * len(gt)


def _draw(cam, n):
    """n frames' noise (one image each) drawn from cam's generator."""
    for _ in range(n):
        cam.rng.normal(0.0, cam.noise_sigma, (cam.world.h, cam.world.w))


def _jax_render(cam, sensor, cfg, T, i):
    if sensor == "stereo":
        left, right, _ = cam.render_stereo(T, cfg.bf / cfg.fx, i)
        return left, right
    img, depth = cam.render_with_depth(T, i)
    return img, (depth if sensor == "rgbd" else None)


def _port_render(cam, sensor, cfg, T, i):
    if sensor == "stereo":
        left, right, _ = cam.render_stereo(T, cfg.baseline, i)
        return left, right
    img, depth = cam.render_with_depth(T, i)
    return img, (depth if sensor == "rgbd" else None)


def _equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ev.ROWS)
def test_row_matches_reference_definition(name):
    # full size: the config and the poses (handed the reference's camera,
    # which the row keeps as it is)
    jcfg, jcam, jgt, sensor, loops, _ = _jax_row(name, False)
    r = ev.row(name, False, cam=jcam)
    assert (r.name, r.sensor, r.enable_loops, r.cam) == (name, sensor, loops, jcam)
    assert r.cfg == convert.config_from_jax(jcfg)
    np.testing.assert_allclose(np.stack(r.gt), np.stack(jgt), rtol=0, atol=POSE_TOL)
    # small size: the config, the poses, the camera and the renders
    r = ev.row(name, True)
    jcfg, jcam, jgt, sensor, loops, skip = _jax_row(name, True)
    assert (r.name, r.sensor, r.enable_loops) == (name, sensor, loops)
    assert r.cfg == convert.config_from_jax(jcfg)
    np.testing.assert_allclose(np.stack(r.gt), np.stack(jgt), rtol=0, atol=POSE_TOL)
    for k in ("noise_sigma", "exposure_amp", "exposure_period"):
        assert getattr(r.cam, k) == getattr(jcam, k), k
    np.testing.assert_array_equal(r.cam.vig, jcam.vig)
    assert type(r.cam.world).__name__ == type(jcam.world).__name__
    _draw(jcam, skip)
    got = list(ev.row_frames(r, 2, ahead=2, workers=2))
    for i in range(2):
        want = _jax_render(jcam, sensor, jcfg, jgt[i], i)
        assert got[i][0] == sensor
        _equal(got[i][1], want[0])
        _equal(got[i][2], want[1])
    j = min(FRAME_CHECKED, len(jgt) - 1)
    per = 2 if sensor == "stereo" else 1
    r = ev.row(name, True)
    _draw(r.cam, per * j)
    _draw(jcam, per * (j - 2))
    a = _port_render(r.cam, sensor, r.cfg, r.gt[j], j)
    b = _jax_render(jcam, sensor, jcfg, jgt[j], j)
    _equal(a[0], b[0])
    _equal(a[1], b[1])


def test_torture_lap_matches_reference(tmp_path, monkeypatch):
    r = ev.row("torture-forward-rgbd", True)
    r = r._replace(cfg=dataclasses.replace(r.cfg, **CAPS))
    n = TORTURE_FRAMES
    monkeypatch.setenv("EVAL_METRICS_DIR", str(tmp_path))
    res = ev.run_sequence(r.cfg, r.cam, r.gt[:n], "rgbd", "torture", result_dir=str(tmp_path),
                          device="cpu")
    with open(tmp_path / "torture_metrics.json") as f:
        t_metrics = json.load(f)
    t_traj = np.loadtxt(tmp_path / "torture_frames_tum.txt")

    # the reference, handed the port's frames of the same renders
    monkeypatch.setattr(jts, "full_tracking_step_from_images",
                        lambda cfg, m, f, *rest: jts.full_tracking_step(cfg, m, f, *rest[:-1]))
    jcfg = dataclasses.replace(_jax_row("torture-forward-rgbd", True)[0], use_pallas=0, **CAPS)
    assert convert.config_from_jax(jcfg) == r.cfg
    r = ev.row("torture-forward-rgbd", True)
    js = jsystem.SlamSystem(jcfg)
    for i, (_, g, d) in enumerate(ev.row_frames(r, n, ahead=4, workers=2)):
        f = tframe.make_frame_rgbd(torch.from_numpy(g), torch.from_numpy(d), r.cfg)
        f = jframe.FrameData(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(f).items()})
        if js.state != jsystem.OK:
            js._flush_pipeline()
        js._track(f, i / jcfg.fps)
    js.flush()
    ttraj.save_tum(str(tmp_path / "reference_tum.txt"),
                   [(t, np.asarray(T)) for t, T in js.get_trajectory()])
    j_traj = np.loadtxt(tmp_path / "reference_tum.txt")

    assert res["tracked"] == len(js.get_trajectory()) == n
    assert [(e["frame"], e["state"]) for e in t_metrics] == \
        [(e["frame"], e["state"]) for e in js.metrics]
    kf = lambda ms: sorted(e["frame"] for e in ms if e.get("kf"))  # noqa: E731
    assert kf(t_metrics) == kf(js.metrics) and kf(js.metrics)
    assert res["kf_seq_total"] == js._kf_seq_host
    ok = lambda ms: [e.get("fallback") for e in ms if e["state"] == "OK"]  # noqa: E731
    assert ok(t_metrics) == ok(js.metrics)
    np.testing.assert_array_equal(t_traj[:, 0], j_traj[:, 0])
    np.testing.assert_allclose(t_traj[:, 1:4], j_traj[:, 1:4], rtol=0, atol=CENTRE_TOL)


@pytest.mark.parametrize("name", chip_eval_rows.ROWS)
def test_row_checks(name):
    ref = chip_eval_rows.REFERENCE_ROWS[name]
    # a camera handed in: only the poses are read, so no row draws noise
    poses = ev.row(name, cam=ev.row("loop-rgbd", True).cam).gt
    runs = ref if isinstance(ref, list) else [ref]
    check = lambda rec: cs.check_row(rec, ref, poses)  # noqa: E731
    for run in runs:
        assert check(dict(run)) == [], run
    one = runs[0]
    n = one["frames"]
    assert check(dict(one, tracked=int(0.94 * n)))
    worst = max(r["ate_m"] for r in runs)
    assert check(dict(one, ate_m=2 * worst + 0.01 + 1e-4))
    assert check(dict(one, keyframes_inserted=round(1.25 * max(r["keyframes_inserted"]
                                                            for r in runs))))
    assert check(dict(one, keyframes_inserted=round(0.75 * min(r["keyframes_inserted"]
                                                            for r in runs))))
    # an extra closure between the two frames farthest apart in truth
    far = int(np.argmax([np.linalg.norm(T[:3, 3] - poses[0][:3, 3]) for T in poses]))
    extra = dict(kf_seq=one["keyframes_inserted"], kf_frame=far, cand_frame=0,
                 cand_neighbour_frames=[0])
    assert not cs._genuine(poses, extra)
    assert check(dict(one, loops=one["loops"] + 1, closures=one["closures"] + [extra]))
