"""The port's ORB extraction and frame construction end to end against the
JAX reference (`orb_slam2_tpu`) on the CPU, plus the pieces around them:
config, camera, RGB-D depth association, synthetic renders and the state
conversion between the packages."""
import dataclasses
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geometry import camera as jcamera
from orb_slam2_tpu.ops import stereo as jstereo
from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.utils import config as jconfig
from orb_slam2_tpu.utils import synthetic as jsyn

from orb_slam2_tpu_torch.geometry import camera as tcamera
from orb_slam2_tpu_torch.ops import extractor as tex
from orb_slam2_tpu_torch.ops import stereo as tstereo
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.utils import config as tconfig
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
H, W = 240, 320
FX = 260.0


def _jax_cfg(**kw):
    return jconfig.SlamConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                              bf=0.25 * FX, n_levels=4, n_features=300,
                              use_pallas=0, **kw)


@pytest.fixture(scope="module")
def scene():
    """One rendered RGB-D frame of the plate world, uint8 gray as a camera
    delivers it."""
    world = jsyn.PlateWorld(FX, FX, W / 2, H / 2, W, H, z0=5.0)
    T = jsyn.loop_trajectory(40, radius=1.0)[3]
    gray, depth = world.render_with_depth(T)
    return np.clip(np.round(gray), 0, 255).astype(np.uint8), depth


def _key(xy, level, valid):
    return {tuple(r): i for i, r in zip(np.nonzero(valid)[0],
                                        np.c_[xy[valid], level[valid]].tolist())}


def _compare_keypoints(ref, got, min_valid):
    """ref: reference record of numpy arrays; got: the port's. Returns the
    indices of the keypoints both found, after the shared checks."""
    rv, gv = np.asarray(ref.valid), got.valid.numpy()
    xy_r = np.asarray(ref.xy_raw)
    xy_g = (got.xy_raw if hasattr(got, "xy_raw") else got.xy).numpy()
    kr, kg = _key(xy_r, np.asarray(ref.level), rv), _key(xy_g, got.level.numpy(), gv)
    common = sorted(set(kr) & set(kg))
    assert rv.sum() >= min_valid
    # measured: 100 % identical on these frames; the pyramid's f32 sums
    # differ from the reference's dot by <= 5e-5 gray, which could only
    # reorder near-equal FAST responses
    assert len(common) >= 0.99 * rv.sum() and gv.sum() == rv.sum()
    ir = np.array([kr[k] for k in common])
    ig = np.array([kg[k] for k in common])
    lvl = np.asarray(ref.level)[ir]
    d = np.abs(np.asarray(ref.angle)[ir] - got.angle.numpy()[ig])
    d = np.minimum(d, 360.0 - d)
    # level 0 is the same image on both sides: atan2/ULP only. Levels >= 1
    # inherit the pyramid's <= 5e-5 gray, which a low-contrast patch's small
    # moments amplify (measured <= 0.021 deg at 240x320)
    assert d[lvl == 0].max() <= 1e-3
    assert d.max() <= 0.1
    desc_r = np.asarray(ref.desc, np.uint32)[ir]
    flips = int(np.unpackbits((desc_r ^ got.desc.numpy().view(np.uint32)[ig])
                              .view(np.uint8)).sum())
    # BRIEF compares blurred samples; the pyramid's ULPs and the angle
    # differences above flip a pair only where it compares within that
    # margin (measured 3 bits of 76,800): bound 0.05 % of the bits
    assert flips <= 0.0005 * 256 * len(common), flips
    np.testing.assert_allclose(got.response.numpy()[ig], np.asarray(ref.response)[ir],
                               rtol=0, atol=1e-3)
    return ir, ig


@pytest.fixture(scope="module")
def rgbd_cfg():
    return _jax_cfg(sensor=jconfig.SENSOR_RGBD, k1=0.05, k2=-0.01)


@pytest.fixture(scope="module")
def ref_rgbd(scene, rgbd_cfg):
    """The reference's RGB-D frame (its keypoint fields are `extract`'s
    output: one compile serves both tests)."""
    gray, depth = scene
    return jax.tree.map(np.asarray, jframe.make_frame_rgbd(
        jnp.asarray(gray), jnp.asarray(depth), rgbd_cfg))


def test_extract_matches(scene, rgbd_cfg, ref_rgbd):
    gray, _ = scene
    got = tex.extract(torch.from_numpy(gray.astype(np.float32)),
                      convert.config_from_jax(rgbd_cfg))
    assert got.desc.dtype == torch.int32 and got.desc.shape == (rgbd_cfg.max_keypoints, 8)
    _compare_keypoints(ref_rgbd, got, min_valid=290)
    # the padded tail is empty
    assert not got.valid[sum(rgbd_cfg.features_per_level()):].any()


def test_make_frame_rgbd_matches(scene, rgbd_cfg, ref_rgbd):
    gray, depth = scene
    ref = ref_rgbd
    got = tframe.make_frame_rgbd(torch.from_numpy(gray), torch.from_numpy(depth),
                                 convert.config_from_jax(rgbd_cfg))
    ir, ig = _compare_keypoints(ref, got, min_valid=290)
    # depth is looked up at the same pixel: exact
    np.testing.assert_array_equal(got.depth.numpy()[ig], ref.depth[ir])
    assert (ref.depth[ir] > 0).mean() > 0.5
    # undistortion: 10 fixed-point steps in f32, XLA may contract to FMA
    np.testing.assert_allclose(got.xy.numpy()[ig], ref.xy[ir], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.ur.numpy()[ig], ref.ur[ir], rtol=0, atol=1e-3)
    assert (got.ur.numpy()[~got.valid.numpy()] == -1).all()
    # uint16 depth (a raw depth map) casts on the device like the reference
    got16 = tframe.make_frame(convert.config_from_jax(rgbd_cfg), torch.from_numpy(gray),
                              depth_img=torch.from_numpy((depth * 1000).astype(np.uint16)))
    assert torch.equal(got16.valid, got.valid)


def test_make_frame_monocular_init_matches(scene):
    gray, _ = scene
    cfg = _jax_cfg()
    ref = jax.tree.map(np.asarray, jframe.make_frame_monocular(jnp.asarray(gray), cfg,
                                                               init=True))
    got = tframe.make_frame_monocular(torch.from_numpy(gray),
                                      convert.config_from_jax(cfg), init=True)
    assert got.valid.shape == (cfg.max_keypoints,)
    # twice the features, capped at max_keypoints (512 at 300 features)
    assert cfg.max_keypoints == 512
    _compare_keypoints(ref, got, min_valid=500)
    assert (got.ur.numpy() == -1).all() and (got.depth.numpy() == -1).all()


def test_make_frame_stereo_not_ported():
    """The stereo front end is ported: make_frame dispatches a stereo
    config to make_frame_stereo, which matches part of the left keypoints
    (tests/test_torch_stereo.py holds it against the reference)."""
    cfg = convert.config_from_jax(_jax_cfg(sensor=jconfig.SENSOR_STEREO))
    world = tsyn.PlaneWorld(260.0, 260.0, 160.0, 120.0, 320, 240, z0=4.0)
    T = np.eye(4)
    T_r = T.copy()
    T_r[0, 3] = cfg.baseline
    left, right = (torch.from_numpy(world.render(P)) for P in (T, T_r))
    got = tframe.make_frame(cfg, left, right)
    want = tframe.make_frame_stereo(left, right, cfg)
    for name, a, b in zip(tframe.FrameData._fields, got, want):
        assert torch.equal(a, b), name
    assert int((got.ur >= 0).sum()) > 0.3 * int(got.n)


def test_stereo_from_rgbd_matches():
    rng = np.random.default_rng(9)
    n, h, w = 300, 48, 64
    xy_raw = rng.uniform(-2, 66, (n, 2)).astype(np.float32)
    xy_raw[:8, 0] = np.arange(8) + 0.5               # half-way cases round to even
    xy_und = xy_raw + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    valid = rng.random(n) > 0.2
    depth = rng.uniform(0, 3, (h, w)).astype(np.float32)
    depth[depth < 0.5] = 0.0
    ref = jstereo.stereo_from_rgbd(jnp.asarray(xy_raw), jnp.asarray(xy_und),
                                   jnp.asarray(valid), jnp.asarray(depth), 40.0, 0.5)
    got = tstereo.stereo_from_rgbd(torch.from_numpy(xy_raw), torch.from_numpy(xy_und),
                                   torch.from_numpy(valid), torch.from_numpy(depth), 40.0, 0.5)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_undistort_pixels_matches():
    rng = np.random.default_rng(2)
    uv = rng.uniform(0, 640, (500, 2)).astype(np.float32)
    k = dict(k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026, k3=1.1633)
    ref = jcamera.undistort_pixels(jcamera.Camera.make(517.3, 516.5, 318.6, 255.3, **k),
                                   jnp.asarray(uv))
    got = tcamera.undistort_pixels(tcamera.Camera.make(517.3, 516.5, 318.6, 255.3, **k,
                                                       device="cpu"),
                                   torch.from_numpy(uv))
    # f32 fixed-point iteration, FMA contraction on the XLA side: 1e-3 px
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_config_matches_reference(tmp_path):
    yml = tmp_path / "TUM1.yaml"
    yml.write_text("%YAML:1.0\nCamera.fx: 517.306408\nCamera.fy:516.469215\n"
                   "Camera.k1: 0.262383\nCamera.fps: 30.0\nCamera.bf: 40.0\n"
                   "DepthMapFactor: 5000.0\nORBextractor.nFeatures: 1000\n"
                   "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n")
    ref = jconfig.SlamConfig.from_yaml(str(yml), sensor=jconfig.SENSOR_RGBD)
    got = tconfig.SlamConfig.from_yaml(str(yml), sensor=tconfig.SENSOR_RGBD)
    want = dataclasses.asdict(ref)
    want.pop("use_pallas")
    assert dataclasses.asdict(got) == want
    assert convert.config_from_jax(ref) == got
    for cfg_r, cfg_g in ((ref, got), (jconfig.SlamConfig(n_features=300, n_levels=4),
                                      tconfig.SlamConfig(n_features=300, n_levels=4))):
        assert cfg_g.features_per_level() == cfg_r.features_per_level()
        assert cfg_g.scale_factors == cfg_r.scale_factors
        assert cfg_g.level_sigma2 == cfg_r.level_sigma2
        assert cfg_g.max_keypoints == cfg_r.max_keypoints
        assert cfg_g.mapper_busy_frames_effective == cfg_r.mapper_busy_frames_effective
    cam = got.camera(device="cpu")
    assert float(cam.fx) == np.float32(517.306408) and cam.width == 640


def test_synthetic_renders_identical():
    kw = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H, z0=5.0,
              tex_size=512, n_plates=40)
    ref_w, got_w = jsyn.PlateWorld(**kw), tsyn.PlateWorld(**kw)
    poses_r = jsyn.loop_trajectory(30, radius=2.0, overshoot=0.5, spiral=0.12)
    poses_g = tsyn.loop_trajectory(30, radius=2.0, overshoot=0.5, spiral=0.12)
    np.testing.assert_array_equal(np.stack(poses_g), np.stack(poses_r))
    for T in poses_r[::10]:
        for a, b in zip(ref_w.render_with_depth(T), got_w.render_with_depth(T)):
            np.testing.assert_array_equal(b, a)
    plane_r = jsyn.PlaneWorld(FX, FX, W / 2, H / 2, W, H, tex_size=256)
    plane_g = tsyn.PlaneWorld(FX, FX, W / 2, H / 2, W, H, tex_size=256)
    np.testing.assert_array_equal(plane_g.render(poses_r[5]), plane_r.render(poses_r[5]))


class _RefFrame(NamedTuple):
    """Stands in for the reference's FrameData (same field names)."""
    xy: np.ndarray
    xy_raw: np.ndarray
    level: np.ndarray
    angle: np.ndarray
    response: np.ndarray
    desc: np.ndarray
    valid: np.ndarray
    ur: np.ndarray
    depth: np.ndarray


def test_convert_round_trip_bit_exact():
    rng = np.random.default_rng(11)
    n = 64
    ref = _RefFrame(
        xy=rng.random((n, 2)).astype(np.float32), xy_raw=rng.random((n, 2)).astype(np.float32),
        level=rng.integers(0, 8, n).astype(np.int32), angle=rng.random(n).astype(np.float32),
        response=rng.random(n).astype(np.float32),
        desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32),
        valid=rng.random(n) > 0.5, ur=rng.random(n).astype(np.float32),
        depth=rng.random(n).astype(np.float32))
    ref.desc[0, 0] = 0xFFFFFFFF
    ref.desc[1, 3] = 0x80000000
    f = convert.frame_from_numpy(ref, device="cpu")
    assert f.desc.dtype == torch.int32
    back = convert.frame_to_numpy(f)
    for name in _RefFrame._fields:
        a, b = getattr(ref, name), back[name]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    kp = convert.keypoints_from_numpy(ref, device="cpu")
    assert torch.equal(kp.desc, f.desc) and torch.equal(kp.valid, f.valid)
