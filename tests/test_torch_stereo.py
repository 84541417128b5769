"""The port's stereo path against the JAX reference on the CPU.

- `ops/stereo.compute_stereo_matches` on the street canyon
  (`BlockWorld`, `city_block_trajectory` and `ImperfectCamera`, as
  EVAL.md's block-stereo row, at 320x240 and 400 features), both packages
  handed the same keypoints and pyramids (the port's), images quantized to
  uint8 and left float32;
- `pipeline/frame.make_frame_stereo` against the reference's on the same
  uint8 pairs, each package with its own extraction (the keypoints under
  tests/test_torch_extract_frame.py's bounds);
- the stereo scene of tests/test_e2e.py:68-90 (the plane world, a 0.25 m
  baseline, 12 frames of `lateral_trajectory` with a 15 cm step so the
  natural policy inserts keyframes) through both `SlamSystem`s, the
  reference handed the port's frames through its frame-given path, a
  synchronous lap and a stream at depth 2.

Bounds, and why: the coarse search is integer logic; the SAD sums 121
float32 terms, in another order in XLA than in torch. On an integer-valued
level (level 0 of a uint8 image) every sum is exact, so u_right and depth
are equal bit for bit there; above level 0, and on float32 images, the
sums round differently and u_right is held within 1e-3 px (measured
1.5e-5 px) and the disparity bf / depth alike, with at most 0.5 % of the
rows matched on one side only (a SAD argmin or the median cull flipped;
measured 0). The systems: the same state after every frame, the same
keyframe frames, local-map inliers within 1 %, Tcw within 1e-3 per entry
(measured 3.6e-5 on the sync lap).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import stereo as jstereo
from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import system as jsystem
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig

from orb_slam2_tpu_torch.ops import extractor as tex
from orb_slam2_tpu_torch.ops import stereo as tstereo
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils.synthetic import (BlockWorld, ImperfectCamera, PlaneWorld,
                                                 city_block_trajectory, lateral_trajectory)

from test_torch_extract_frame import _compare_keypoints

torch.set_num_threads(2)
H, W, FX = 240, 320, 260.0
UR_TOL = 1e-3        # px, wherever a sum may round
FLIP_FLOOR = 0.005   # rows matched on one side only
PAIRS = (0, 20, 39)  # frames of the canyon sequence
N_FRAMES, STEP = 12, 0.15
TCW_TOL = 1e-3


def _canyon_cfgs():
    jcfg = jconfig.SlamConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                              n_features=400, sensor=jconfig.SENSOR_STEREO, bf=FX * 0.5,
                              use_pallas=0)
    return jcfg, convert.config_from_jax(jcfg)


@pytest.fixture(scope="module")
def pairs():
    world = BlockWorld(FX, FX, W / 2, H / 2, W, H)
    poses = city_block_trajectory(PAIRS[-1] + 1, corner_radius=6.0, speed=0.15, overshoot=0.12)
    cam = ImperfectCamera(world, noise_sigma=3.0, exposure_amp=0.15)
    out = {}
    for i, T in enumerate(poses):
        left, right, _ = cam.render_stereo(T, 0.5, i)     # the noise drawn in frame order
        if i in PAIRS:
            out[i] = (left, right)
    return out


def _images(pair, dtype):
    if dtype == "uint8":
        return tuple(np.clip(np.round(x), 0, 255).astype(np.uint8) for x in pair)
    return pair


def _jax_keys(k):
    return (jnp.asarray(k.xy.numpy()), jnp.asarray(k.level.numpy()),
            jnp.asarray(k.desc.numpy().view(np.uint32)), jnp.asarray(k.valid.numpy()))


def _assert_stereo_close(ur, depth, level, ur_j, depth_j, bf, exact_level0):
    """u_right / depth against the reference's (module docstring)."""
    on, on_j = ur >= 0, ur_j >= 0
    assert (on != on_j).mean() <= FLIP_FLOOR, int((on != on_j).sum())
    both = on & on_j
    assert both.sum() >= 50
    close = both & ~(exact_level0 & (level == 0))
    np.testing.assert_allclose(ur[close], ur_j[close], rtol=0, atol=UR_TOL)
    np.testing.assert_allclose(bf / depth[close], bf / depth_j[close], rtol=0, atol=UR_TOL)
    if exact_level0:
        lv0 = both & (level == 0)
        assert lv0.sum() >= 20
        np.testing.assert_array_equal(ur[lv0], ur_j[lv0])
        np.testing.assert_array_equal(depth[lv0], depth_j[lv0])
    assert (ur[~on] == -1).all() and (depth[~on] == -1).all()


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("frame", PAIRS)
def test_compute_stereo_matches(pairs, frame, dtype):
    jcfg, tcfg = _canyon_cfgs()
    left, right = (torch.from_numpy(x).to(torch.float32) for x in _images(pairs[frame], dtype))
    kl, pl = tex.extract_with_pyramid(left, tcfg)
    kr, pr = tex.extract_with_pyramid(right, tcfg)
    ur, depth = tstereo.compute_stereo_matches(kl.xy, kl.level, kl.desc, kl.valid, kr.xy,
                                               kr.level, kr.desc, kr.valid, pl, pr,
                                               tcfg.scale_factors, tcfg.bf, tcfg.fx)
    ur_j, depth_j = jax.jit(jstereo.compute_stereo_matches, static_argnums=(10, 11, 12))(
        *_jax_keys(kl), *_jax_keys(kr), [jnp.asarray(x.numpy()) for x in pl],
        [jnp.asarray(x.numpy()) for x in pr], tuple(jcfg.scale_factors), jcfg.bf, jcfg.fx)
    _assert_stereo_close(ur.numpy(), depth.numpy(), kl.level.numpy(), np.asarray(ur_j),
                         np.asarray(depth_j), tcfg.bf, exact_level0=dtype == "uint8")


@pytest.mark.parametrize("frame", PAIRS[1:])
def test_make_frame_stereo(pairs, frame):
    """Each package with its own extraction of a uint8 pair, as a camera
    delivers it: the left keypoints under the extraction test's bounds
    (the same keypoints, their angles, BRIEF bits and responses within the
    pyramid's float32 rounding), then u_right and depth of the keypoints
    both found as for compute_stereo_matches."""
    jcfg, tcfg = _canyon_cfgs()
    left, right = _images(pairs[frame], "uint8")
    got = tframe.make_frame_stereo(torch.from_numpy(left), torch.from_numpy(right), tcfg)
    want = jax.tree.map(np.asarray, jframe.make_frame_stereo(jnp.asarray(left),
                                                             jnp.asarray(right), jcfg))
    ir, ig = _compare_keypoints(want, got, min_valid=300)
    g = convert.frame_to_numpy(got)
    np.testing.assert_array_equal(g["xy"], g["xy_raw"])
    _assert_stereo_close(g["ur"][ig], g["depth"][ig], g["level"][ig], want.ur[ir],
                         want.depth[ir], tcfg.bf, exact_level0=True)


def _scene_cfgs():
    fx = 300.0
    jcfg = jconfig.SlamConfig(
        fx=fx, fy=fx, cx=160.0, cy=120.0, width=320, height=240, n_features=400, fps=10.0,
        th_depth=60.0, sensor=jconfig.SENSOR_STEREO, bf=fx * 0.25, max_keyframes=32,
        max_map_points=1 << 13, ba_local_cams=8, ba_fixed_cams=8, ba_max_points=1 << 10,
        ba_max_obs=6, max_local_keyframes=16, max_local_points=1 << 11, loop_kf_gap=0,
        use_pallas=0)
    return jcfg, convert.config_from_jax(jcfg)


@pytest.fixture(scope="module")
def scene():
    jcfg, tcfg = _scene_cfgs()
    world = PlaneWorld(tcfg.fx, tcfg.fy, tcfg.cx, tcfg.cy, 320, 240, z0=4.0)
    gt = lateral_trajectory(N_FRAMES, step=STEP, yaw_rate=0.004)
    images = []
    for T in gt:
        T_r = T.copy()
        T_r[:3, 3] = T[:3, 3] + T[:3, :3] @ np.array([tcfg.baseline, 0.0, 0.0])
        images.append((world.render(T), world.render(T_r)))
    frames = [jframe.FrameData(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(
        tframe.make_frame_stereo(torch.from_numpy(l), torch.from_numpy(r), tcfg)).items()})
              for l, r in images]
    return dict(jcfg=jcfg, tcfg=tcfg, gt=gt, images=images, frames=frames)


@pytest.mark.parametrize("depth", [0, 2])
def test_stereo_scene_matches_reference(scene, depth, monkeypatch):
    monkeypatch.setattr(jts, "full_tracking_step_from_images",
                        lambda cfg, m, f, *rest: jts.full_tracking_step(cfg, m, f, *rest[:-1]))
    js = jsystem.SlamSystem(scene["jcfg"], pipeline_depth=depth)
    ts = tsystem.SlamSystem(scene["tcfg"], pipeline_depth=depth, device="cpu")
    states, outs = [], []
    for i in range(N_FRAMES):
        t = i / scene["tcfg"].fps
        if js.state == jsystem.OK:
            jo = js._track_stream(scene["frames"][i], t, "stereo") if depth else \
                js._track(scene["frames"][i], t)
        else:
            js._flush_pipeline()
            jo = js._track(scene["frames"][i], t)
        to = ts.track_stereo(*scene["images"][i], t)
        states.append((ts.state, js.state))
        outs.append((to is None, to is tsystem.PENDING, jo is None, jo is jsystem.PENDING))
    js.flush()
    ts.flush()
    assert all(a == b for a, b in states), states
    assert all(o[:2] == o[2:] for o in outs), outs
    assert sum(o[1] for o in outs) >= depth                # in flight at the start
    kf = [sorted(e["frame"] for e in s.metrics if e.get("kf")) for s in (ts, js)]
    assert kf[0] == kf[1] and len(kf[0]) >= 1, kf
    for a, b in zip(ts.metrics, js.metrics):
        assert a["frame"] == b["frame"] and abs(a["inliers"] - b["inliers"]) <= 0.01 * b["inliers"]
    np.testing.assert_array_equal(ts.m.kf_frame_id.numpy(), np.asarray(js.m.kf_frame_id))
    tt, jt = ts.get_trajectory(), js.get_trajectory()
    assert [t for t, _ in tt] == [t for t, _ in jt] and len(tt) == N_FRAMES
    for (_, a), (_, b) in zip(tt, jt):
        np.testing.assert_allclose(a, b, rtol=0, atol=TCW_TOL)
    assert abs(int(ts.m.n_points) - int(js.m.n_points)) <= 0.01 * int(js.m.n_points)
