"""The port's small functions of the periphery against the JAX reference on
the CPU: the camera model's projection helpers (`geometry/camera.py`),
the map's observation counts and scale prediction (`mapstate/map.py`), the
survey and forward trajectories (`utils/synthetic.py`), and the ORB
extractor at 160x120, where the top pyramid levels are too small for the
intensity-centroid patch of a padded slot (the reference clamps the patch
into the level; the port's ic_angles does the same since it indexes out of
bounds otherwise).

Tolerances: float32 arithmetic in another operation order (XLA may fuse
and contract) moves projections by at most a few float32 ulps of a pixel
coordinate, so 1e-4 px / 1e-5 relative; integers and trajectories (NumPy
in both packages) exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geometry import camera as jcamera
from orb_slam2_tpu.mapstate import map as jmap
from orb_slam2_tpu.ops import extractor as jex
from orb_slam2_tpu.utils import config as jconfig
from orb_slam2_tpu.utils import synthetic as jsyn

from orb_slam2_tpu_torch.geometry import camera as tcamera
from orb_slam2_tpu_torch.mapstate import map as tmap
from orb_slam2_tpu_torch.ops import extractor as tex
from orb_slam2_tpu_torch.utils import config as tconfig
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
TUM1 = dict(k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)
LENSES = {"pinhole": {}, "tum1": TUM1}


def _cams(lens, bf=40.0):
    args = (517.3, 516.5, 318.6, 255.3)
    return (jcamera.Camera.make(*args, bf=bf, **LENSES[lens]),
            tcamera.Camera.make(*args, bf=bf, **LENSES[lens], device="cpu"))


@pytest.mark.parametrize("lens", sorted(LENSES))
def test_camera_functions(lens, rng):
    jc, tc = _cams(lens)
    pc = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                   rng.uniform(0.5, 8, 200)], -1).astype(np.float32)
    pc[0, 2] = 0.0                                      # the guarded division
    xn = (pc[:, :2] / np.maximum(pc[:, 2:], 0.5)).astype(np.float32)
    uv = rng.uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    depth = rng.uniform(0.3, 9, 200).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (jcamera.distort_normalized(jc, jnp.asarray(xn)), tcamera.distort_normalized(tc, t(xn))),
        (jcamera.project(jc, jnp.asarray(pc[1:])), tcamera.project(tc, t(pc[1:]))),
        (jcamera.project_stereo(jc, jnp.asarray(pc[1:])), tcamera.project_stereo(tc, t(pc[1:]))),
        (jcamera.backproject(jc, jnp.asarray(uv), jnp.asarray(depth)),
         tcamera.backproject(tc, t(uv), t(depth))),
        (jnp.stack(jcamera.image_bounds(jc)), torch.stack(tcamera.image_bounds(tc)))]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    # z = 0 takes the 1e-12 guard on both sides
    np.testing.assert_allclose(tcamera.project(tc, t(pc[:1])).numpy(),
                               np.asarray(jcamera.project(jc, jnp.asarray(pc[:1]))), rtol=1e-6)
    assert tc.has_distortion == jc.has_distortion == (lens != "pinhole")
    assert float(tc.baseline) == pytest.approx(float(jc.baseline), rel=1e-7)


def _map_pair(rng):
    """A reference MapState with random observations (mono and stereo), and
    the port's copy of it."""
    K, P, N = 6, 64, 32
    m = jmap.empty(K, P, N)
    obs = np.where(rng.random((K, N)) < 0.6, rng.integers(0, P, (K, N)), -1).astype(np.int32)
    ur = np.where(rng.random((K, N)) < 0.5, rng.uniform(0, 600, (K, N)), -1.0).astype(np.float32)
    max_dist = rng.uniform(0.5, 20, P).astype(np.float32)
    m = m._replace(kf_obs=jnp.asarray(obs), kf_ur=jnp.asarray(ur),
                   kf_valid=jnp.ones(K, bool), pt_valid=jnp.asarray(rng.random(P) < 0.9),
                   pt_max_dist=jnp.asarray(max_dist))
    return m, convert.mapstate_from_numpy(m, device="cpu")


def test_map_counts_and_scale(rng):
    jm, tm = _map_pair(rng)
    np.testing.assert_array_equal(tmap.count_observations(tm).numpy(),
                                  np.asarray(jmap.count_observations(jm)))
    np.testing.assert_array_equal(tmap.refresh_obs_count(tm).pt_obs_cnt.numpy(),
                                  np.asarray(jmap.refresh_obs_count(jm).pt_obs_cnt))
    dist = rng.uniform(0.01, 30, jm.capacity_pt).astype(np.float32)
    dist[:3] = [0.0, 1e-12, 1e6]
    log_sf = float(np.log(1.2))
    np.testing.assert_array_equal(
        tmap.predict_scale(tm, torch.from_numpy(dist), log_sf, 8).numpy(),
        np.asarray(jmap.predict_scale(jm, jnp.asarray(dist), log_sf, 8)))


@pytest.mark.parametrize("name, kw", [
    ("survey_trajectory", dict(n_frames=50, extent=9.0, rows=6)),
    ("survey_trajectory", dict(n_frames=7)),
    ("forward_trajectory", dict(n_frames=60, speed=0.08, close_loop=True)),
    ("forward_trajectory", dict(n_frames=40))])
def test_trajectories(name, kw):
    ref, got = getattr(jsyn, name)(**kw), getattr(tsyn, name)(**kw)
    assert len(ref) == len(got) == kw["n_frames"]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_extract_small_levels():
    """160x120 with 8 levels: the top levels are 45x33 and 37x28 pixels, so
    a padded slot at (19, 19) has no whole 31x31 patch inside them."""
    kw = dict(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120, n_features=250)
    jcfg, tcfg = jconfig.SlamConfig(use_pallas=0, **kw), tconfig.SlamConfig(**kw)
    world = tsyn.PlateWorld(130.0, 130.0, 80.0, 60.0, 160, 120, z0=4.0)
    img = world.render(tsyn.lateral_trajectory(2, step=0.12)[1])
    got = tex.extract(torch.from_numpy(img), tcfg)
    ref = jex.extract(jnp.asarray(img), jcfg)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.xy.numpy()[valid], np.asarray(ref.xy)[valid])
    np.testing.assert_array_equal(got.level.numpy()[valid], np.asarray(ref.level)[valid])
    # IC angles: the port is closer to float64 than the reference (ROADMAP
    # Queue 3's parity findings: within 3.1e-3 degrees)
    d = np.abs(got.angle.numpy()[valid] - np.asarray(ref.angle)[valid])
    assert float(np.minimum(d, 360 - d).max()) < 5e-3
