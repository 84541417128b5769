"""Map checkpoints across the packages: the port's `utils/checkpoint.py`
against the JAX reference's on the same npz layout (`map_<field>`,
`extra_<key>`, descriptors as uint32 words), and a resume in localization
mode (tests/test_checkpoint.py:40-69).

The map is the port's after 10 RGB-D frames of a plate world at 160x120
(three keyframes, a few hundred points). Each package loads what the other
saved with every field equal, floats bit for bit. Both rebuild the derived
caches on load (the observation table and its weighted counts, integers),
so a loaded map equals the saved one with those caches refreshed (the
live map's counts may lag a BA's outlier erasures). Also a checkpoint
written before the newer fields existed (their defaults filled). Then a fresh port system in localization mode, seeded at the
newest keyframe's frame, tracks the next frame within 5 cm of the truth
and inserts no keyframe.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.mapstate import map as jmap
from orb_slam2_tpu.utils import checkpoint as jckpt

from orb_slam2_tpu_torch.mapstate import map as tmap
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.pipeline.frame import make_frame_rgbd
from orb_slam2_tpu_torch.utils import checkpoint as tckpt
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils.config import SENSOR_RGBD, SlamConfig
from orb_slam2_tpu_torch.utils.synthetic import PlateWorld, lateral_trajectory

torch.set_num_threads(2)
N_FRAMES = 10
NEWER = ("loop_edges", "pt_obs_cnt", "pt_forward", "obs_kf", "obs_ft")


def small_config():
    fx = 130.0
    return SlamConfig(fx=fx, fy=fx, cx=80.0, cy=60.0, width=160, height=120, n_features=250,
                      bf=fx * 0.25, sensor=SENSOR_RGBD, fps=10.0, th_depth=40.0,
                      max_keyframes=16, max_map_points=1 << 11, ba_local_cams=8,
                      ba_fixed_cams=8, ba_max_points=1 << 9, ba_max_obs=6,
                      max_local_keyframes=8, max_local_points=1 << 10)


def small_run(n=N_FRAMES):
    """The port's system over n frames: (system, ground truth, renders)."""
    cfg = small_config()
    world = PlateWorld(cfg.fx, cfg.fy, cfg.cx, cfg.cy, 160, 120, z0=4.0)
    gt = lateral_trajectory(n + 1, step=0.09, yaw_rate=0.004)
    images = [world.render_with_depth(T) for T in gt]
    s = tsystem.SlamSystem(cfg, device="cpu")
    for i in range(n):
        s.track_rgbd(*images[i], i / cfg.fps)
    return s, gt, images


@pytest.fixture(scope="module")
def run():
    s, gt, images = small_run()
    assert int(s.m.n_keyframes) >= 2 and int(s.m.n_points) > 100
    return s, gt, images


def _equal(port_m, jax_m):
    got = convert.mapstate_to_numpy(port_m)
    for name in jmap.MapState._fields:
        want = np.asarray(getattr(jax_m, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_port_to_reference(run, tmp_path):
    s = run[0]
    path = str(tmp_path / "port.npz")
    tckpt.save_map(path, s.m, extra=dict(frame_id=s.frame_id))
    jm, extra = jckpt.load_map(path)
    assert int(extra["frame_id"]) == s.frame_id
    saved = tmap.refresh_obs_table(s.m)
    _equal(saved, jm)
    back, extra = tckpt.load_map(path, device="cpu")
    for name in s.m._fields:
        assert torch.equal(getattr(back, name), getattr(saved, name)), name


def test_reference_to_port(run, tmp_path):
    s = run[0]
    jm = jmap.MapState(**{k: jnp.asarray(v) for k, v in convert.mapstate_to_numpy(s.m).items()})
    path = str(tmp_path / "jax.npz")
    jckpt.save_map(path, jm, extra=dict(frame_id=s.frame_id))
    m, extra = tckpt.load_map(path, device="cpu")
    assert int(extra["frame_id"]) == s.frame_id
    _equal(m, jckpt.load_map(path)[0])
    _equal(tmap.refresh_obs_table(s.m), jckpt.load_map(path)[0])


def test_older_checkpoint_defaults(run, tmp_path):
    """A checkpoint without the newer fields: both packages fill the same
    defaults and rebuild the same observation table."""
    s = run[0]
    arrays = {f"map_{k}": v for k, v in convert.mapstate_to_numpy(s.m).items() if k not in NEWER}
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, **arrays)
    jm, _ = jckpt.load_map(path)
    m, _ = tckpt.load_map(path, device="cpu")
    _equal(m, jm)
    saved = tmap.refresh_obs_table(s.m)
    assert torch.equal(m.obs_kf, saved.obs_kf) and torch.equal(m.pt_obs_cnt, saved.pt_obs_cnt)


def test_resume_in_localization_mode(run, tmp_path):
    s, gt, images = run
    path = str(tmp_path / "map.npz")
    tckpt.save_map(path, s.m)
    m2, _ = tckpt.load_map(path, device="cpu")
    cfg = s.cfg
    s2 = tsystem.SlamSystem(cfg, device="cpu")
    s2.m = m2
    s2.activate_localization_mode()
    valid = np.nonzero(m2.kf_valid.numpy())[0]
    fid = m2.kf_frame_id.numpy()
    kf = int(valid[np.argmax(fid[valid])])
    i = int(fid[kf])
    s2.state, s2.ref_kf = tsystem.OK, kf
    g, d = images[i]
    s2._set_last(make_frame_rgbd(torch.from_numpy(g), torch.from_numpy(d), cfg),
                 m2.kf_pose[kf], m2.kf_obs[kf])
    n_kf = int(m2.n_keyframes)
    Tcw = s2.track_rgbd(*images[i + 1], 99.0)
    assert Tcw is not None
    err = np.linalg.norm(np.linalg.inv(Tcw)[:3, 3] - (np.linalg.inv(gt[0]) @ gt[i + 1])[:3, 3])
    assert err < 0.05, err
    assert int(s2.m.n_keyframes) == n_kf
