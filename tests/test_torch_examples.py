"""The port's example scripts (`orb_slam2_tpu_torch/examples/`) against the JAX
package's (`examples/`) on the same sequences on disk, and the scripts
without a counterpart on files (run_synthetic, eval_synthetic_hard's
run_sequence) on a few frames. The monocular script's case is in
tests/test_torch_examples_mono.py (its own file, so it runs beside these).

Each sequence is 6 frames of a plate world at 160x120 (the monocular one
320x240: initialization needs 100 level-0 matches), written in the
dataset's layout with a settings YAML (`chip_smoke.write_png`,
`chip_smoke._settings`). The RGB-D depth PNGs hold millimetres: the
port's YAML gives DepthMapFactor 1000 (units per metre, TUM's convention,
which the port's from_yaml inverts), the reference's 0.001 (the
multiplier, which its from_yaml keeps as read), so both scale by 0.001.
Both scripts run as a user
runs them (the port's `main(argv, device="cpu")`, the reference's script
with its command line) and write their three trajectory files. The
capacities are cut to the small caps of tests/test_e2e.py through
`from_yaml`'s overrides in both packages (a YAML does not carry them).

Both systems see the same frames: the reference's frame construction is
handed the frames the port's script built, in order (the pattern of
tests/test_torch_system.py), and the monocular initializer of the port is
handed the reference's RANSAC draws (tests/test_torch_mono.py). Held: the
frame and keyframe TUM files and the KITTI file equal within 1e-4 (the
pose solves sum float32 in other orders; tests/test_torch_system.py
measures 1.1e-4 m between camera centres on a longer run, this run's
6 frames stay below 1e-4).
"""
import os
import runpy
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig

import chip_smoke
from orb_slam2_tpu_torch.examples import (eval_synthetic_hard, mono_tum, rgbd_tum,
                                          run_synthetic, stereo_euroc, stereo_kitti)
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.pipeline import tracking_step as tts
from orb_slam2_tpu_torch.solvers import initializer as tinit
from orb_slam2_tpu_torch.utils import config as tconfig
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import trajectory as ttraj
from orb_slam2_tpu_torch.utils.synthetic import (ImperfectCamera, PlateWorld,
                                                 lateral_trajectory)

from test_torch_initializer import jax_draws

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 6
TRAJ_TOL = 1e-4
CAPS = dict(max_keyframes=32, max_map_points=1 << 11, ba_local_cams=8, ba_fixed_cams=8,
            ba_max_points=1 << 9, ba_max_obs=6, max_local_keyframes=8,
            max_local_points=1 << 10)
MAKERS = ("make_frame_rgbd", "make_frame_stereo", "make_frame_monocular")


def _cfg(sensor, wide=False):
    w, h, fx = (320, 240, 260.0) if wide else (160, 120, 130.0)
    return tconfig.SlamConfig(fx=fx, fy=fx, cx=w / 2, cy=h / 2, width=w, height=h,
                              n_features=1000 if wide else 250, fps=10.0, th_depth=40.0,
                              bf=0.0 if sensor == tconfig.SENSOR_MONOCULAR else fx * 0.25,
                              sensor=sensor)


def _renders(cfg, n=N_FRAMES, step=0.06):
    world = PlateWorld(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.width, cfg.height, z0=4.0)
    gt = lateral_trajectory(n, step=step, yaw_rate=0.004)
    q = lambda x: np.clip(np.round(x), 0, 255).astype(np.uint8)  # noqa: E731
    return world, gt, q


def write_tum_rgbd(root):
    cfg = _cfg(tconfig.SENSOR_RGBD)
    world, gt, q = _renders(cfg)
    seq = os.path.join(root, "tum")
    os.makedirs(os.path.join(seq, "rgb"))
    os.makedirs(os.path.join(seq, "depth"))
    rgb, depth = [], []
    for i, T in enumerate(gt):
        g, d = world.render_with_depth(T)
        chip_smoke.write_png(os.path.join(seq, "rgb", f"{i}.png"),
                             np.repeat(q(g)[..., None], 3, -1))
        chip_smoke.write_png(os.path.join(seq, "depth", f"{i}.png"),
                             np.round(d * 1000).astype(np.uint16))
        rgb.append(f"{i / cfg.fps:.6f} rgb/{i}.png")
        depth.append(f"{i / cfg.fps + 0.004:.6f} depth/{i}.png")
    for name, lines in (("rgb.txt", rgb), ("depth.txt", depth)):
        with open(os.path.join(seq, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    # the depth PNGs hold millimetres: the port's YAML says so as TUM's do
    # (DepthMapFactor 1000, units per metre), the reference's gives the
    # multiplier its from_yaml keeps as read (0.001)
    chip_smoke._settings(os.path.join(root, "settings.yaml"), cfg, depth_factor=1000.0)
    chip_smoke._settings(os.path.join(root, "settings_ref.yaml"), cfg, depth_factor=0.001)
    return [os.path.join(root, "settings.yaml"), seq], \
        [os.path.join(root, "settings_ref.yaml"), seq]


def write_tum_mono(root):
    cfg = _cfg(tconfig.SENSOR_MONOCULAR, wide=True)
    world, gt, q = _renders(cfg, step=0.05)
    seq = os.path.join(root, "tum")
    os.makedirs(os.path.join(seq, "rgb"))
    lines = []
    for i, T in enumerate(gt):
        chip_smoke.write_png(os.path.join(seq, "rgb", f"{i}.png"), q(world.render(T)))
        lines.append(f"{i / cfg.fps:.6f} rgb/{i}.png")
    with open(os.path.join(seq, "rgb.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    chip_smoke._settings(os.path.join(root, "settings.yaml"), cfg)
    return [os.path.join(root, "settings.yaml"), seq], None


def _pairs(cfg):
    world, gt, q = _renders(cfg)
    out = []
    for T in gt:
        right = T.copy()
        right[:3, 3] += T[:3, :3] @ np.array([cfg.baseline, 0.0, 0.0])
        out.append((q(world.render(T)), q(world.render(right))))
    return out


def write_kitti(root):
    cfg = _cfg(tconfig.SENSOR_STEREO)
    seq = os.path.join(root, "00")
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, cam))
    for i, (l, r) in enumerate(_pairs(cfg)):
        chip_smoke.write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), l)
        chip_smoke.write_png(os.path.join(seq, "image_1", f"{i:06d}.png"), r)
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.write("".join(f"{i / cfg.fps:.6e}\n" for i in range(N_FRAMES)))
    chip_smoke._settings(os.path.join(root, "settings.yaml"), cfg)
    return [os.path.join(root, "settings.yaml"), seq], None


def write_euroc(root):
    cfg = _cfg(tconfig.SENSOR_STEREO)
    ns = [1403636579763555584 + i * 100_000_000 for i in range(N_FRAMES)]
    pairs = _pairs(cfg)
    for k, cam in enumerate(("cam0", "cam1")):
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d)
        for t, pair in zip(ns, pairs):
            chip_smoke.write_png(os.path.join(d, f"{t}.png"), pair[k])
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "".join(f"{t},{t}.png\n" for t in ns))
    chip_smoke._settings(os.path.join(root, "settings.yaml"), cfg, stereo_rect=True)
    return [os.path.join(root, "settings.yaml"), root], None


def _patch_configs(mp, caps):
    """from_yaml with the small caps in both packages (and the reference's
    XLA path)."""
    for mod, extra in ((tconfig, {}), (jconfig, dict(use_pallas=0))):
        load = mod.SlamConfig.from_yaml

        def small(path, sensor=0, _load=load, _extra=extra, **kw):
            return _load(path, sensor, **{**caps, **_extra, **kw})
        mp.setattr(mod.SlamConfig, "from_yaml", staticmethod(small))


def _run_both(tmp_path, write, port_main, script):
    """The port's example script, then the reference's on the same files handed the
    frames the port built. Returns the two output prefixes."""
    mp = pytest.MonkeyPatch()
    built = []
    try:
        # a monocular map parts from the reference's one event after its
        # first keyframe at 2048 keypoints, not at 1024 (tests/test_torch_mono.py)
        _patch_configs(mp, {**CAPS, "max_keypoints": 1024} if port_main is mono_tum.main
                       else CAPS)
        for mod in (tsystem, tts):
            for name in MAKERS:
                make = getattr(mod, name)

                def record(*args, _make=make, **kw):
                    built.append(_make(*args, **kw))
                    return built[-1]
                mp.setattr(mod, name, record)
        init = tinit.initialize

        def keyed(p1, p2, valid, *rest, generator=None, **kw):
            draws = jax_draws(valid.numpy(), key=generator.initial_seed())
            return init(p1, p2, valid, *rest, draws=torch.from_numpy(draws), **kw)
        mp.setattr(tinit, "initialize", keyed)
        argv, ref_argv = write(str(tmp_path))
        port_prefix, ref_prefix = str(tmp_path / "port"), str(tmp_path / "ref")
        extra = [""] if port_main is rgbd_tum.main else []
        s = port_main(argv + extra + [port_prefix], device="cpu")
        assert len(built) == N_FRAMES

        frames = iter([jframe.FrameData(**{k: jnp.asarray(v) for k, v in
                                          convert.frame_to_numpy(f).items()}) for f in built])
        for name in MAKERS:
            mp.setattr(jframe, name, lambda *a, **k: next(frames))
        mp.setattr(jts, "full_tracking_step_from_images",
                   lambda cfg_, m, images, *rest: jts.full_tracking_step(cfg_, m, next(frames),
                                                                         *rest[:-1]))
        mp.setattr(sys, "argv", [script] + (ref_argv or argv) + extra + [ref_prefix])
        mp.syspath_prepend(os.path.join(REPO, "examples"))
        runpy.run_path(os.path.join(REPO, "examples", script), run_name="__main__")
        assert next(frames, None) is None
    finally:
        mp.undo()
    return s, port_prefix, ref_prefix


def _same_files(port_prefix, ref_prefix):
    n = 0
    for suffix in ("_FrameTrajectory_TUM.txt", "_KeyFrameTrajectory_TUM.txt"):
        got, want = ttraj.load_tum(port_prefix + suffix), ttraj.load_tum(ref_prefix + suffix)
        assert len(got) == len(want), suffix
        for (t0, T0), (t1, T1) in zip(got, want):
            assert t0 == t1
            np.testing.assert_allclose(T0, T1, rtol=0, atol=TRAJ_TOL, err_msg=suffix)
        n = max(n, len(got))
    got = np.loadtxt(port_prefix + "_CameraTrajectory_KITTI.txt", ndmin=2)
    want = np.loadtxt(ref_prefix + "_CameraTrajectory_KITTI.txt", ndmin=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_TOL)
    return n


def check_example(tmp_path, write, port_main, script):
    s, port_prefix, ref_prefix = _run_both(tmp_path, write, port_main, script)
    n = _same_files(port_prefix, ref_prefix)
    # every frame tracked (a monocular system from its initialization on)
    assert n == len(s.get_trajectory()) >= N_FRAMES - (3 if port_main is mono_tum.main else 0)


@pytest.mark.parametrize("write, port_main, script", [
    (write_tum_rgbd, rgbd_tum.main, "rgbd_tum.py"),
    (write_kitti, stereo_kitti.main, "stereo_kitti.py"),
    (write_euroc, stereo_euroc.main, "stereo_euroc.py")],
    ids=["rgbd_tum", "stereo_kitti", "stereo_euroc"])
def test_example_matches_reference(tmp_path, write, port_main, script):
    check_example(tmp_path, write, port_main, script)


def test_run_synthetic():
    rmse = run_synthetic.main(["--frames", "6", "--width", "160", "--height", "120",
                               "--features", "250", "--step", "0.05", "--cpu"])
    assert rmse is not None and rmse < 0.05


def test_eval_run_sequence(tmp_path):
    cfg = tconfig.SlamConfig(**{**vars(_cfg(tconfig.SENSOR_RGBD)), **CAPS, "max_keypoints": None})
    world, gt, _ = _renders(cfg, step=0.05)
    res = eval_synthetic_hard.run_sequence(cfg, ImperfectCamera(world), gt, "rgbd", "small",
                                           result_dir=str(tmp_path), device="cpu")
    assert res["tracked"] == N_FRAMES and res["status"] == "ok" and res["ate_cm"] < 5.0
    assert os.path.exists(tmp_path / "small_frames_tum.txt")
