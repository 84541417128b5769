"""AR demo: SLAM + dominant-plane detection + virtual cube overlay.

The headless analogue of the reference's ROS AR demo
(`Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc`, launched by `ros_mono_ar`):
runs the pipeline on the synthetic world (or a TUM RGB-D sequence with
--dataset), fits a plane to the tracked map points once tracking is stable,
and writes frames with the virtual cube drawn on the plane (8-bit gray PNGs
through matplotlib's writer).

The dataset path hands the system the raw depth, as rgbd_tum does: the
port's `SlamConfig.from_yaml` stores 1/DepthMapFactor, so the system scales
the sensor's units to metres itself. (`examples/ar_demo.py` of the JAX
package divides by the factor first, because its config keeps the factor
as read.)

Usage:
  python -m orb_slam2_tpu_torch.examples.ar_demo [--frames 25] [--out /tmp/ar] [--cpu]
  python -m orb_slam2_tpu_torch.examples.ar_demo --dataset <tum_seq_dir> --settings <TUM1.yaml>
"""
import argparse
import os

import numpy as np


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--out", default="/tmp/ar_demo")
    ap.add_argument("--cube", type=float, default=0.4)
    ap.add_argument("--dataset", default=None, help="TUM RGB-D sequence dir")
    ap.add_argument("--settings", default=None, help="settings YAML (with --dataset)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.cpu:
        device = "cpu"

    from .. import ar
    from ..pipeline.system import SlamSystem
    from ..utils.config import SENSOR_RGBD, SlamConfig
    from ..utils.synthetic import PlaneWorld, lateral_trajectory

    os.makedirs(args.out, exist_ok=True)
    ds = None
    if args.dataset:
        from ..utils.datasets import TumRGBD
        cfg = SlamConfig.from_yaml(args.settings, sensor=SENSOR_RGBD)
        ds = TumRGBD(args.dataset)
        frames = iter(ds)
    else:
        fx = fy = 300.0
        cfg = SlamConfig(fx=fx, fy=fy, cx=160.0, cy=120.0, width=320,
                         height=240, n_features=500, bf=fx * 0.1,
                         sensor=SENSOR_RGBD, fps=10.0, th_depth=40.0,
                         max_keyframes=64, max_map_points=1 << 14,
                         ba_local_cams=16, ba_fixed_cams=16,
                         ba_max_points=1 << 11, ba_max_obs=8,
                         max_local_keyframes=32, max_local_points=1 << 12)
        world = PlaneWorld(fx, fy, 160.0, 120.0, 320, 240, z0=5.0)
        gt = lateral_trajectory(args.frames, step=0.03, yaw_rate=0.004)
        frames = ((i * 0.1, *world.render_with_depth(T)) for i, T in enumerate(gt))

    s = SlamSystem(cfg, device=device)
    plane = None
    written = []
    try:
        for i, (ts, img, depth) in enumerate(frames):
            Tcw = s.track_rgbd(img, depth, ts)
            if Tcw is None:
                continue
            matched = s.get_tracked_map_points()
            if plane is None and i >= 5 and matched is not None:
                ids = matched[matched >= 0]
                pts = s.m.pt_pos.cpu().numpy()[ids]
                plane = ar.detect_plane(pts, Tcw, iterations=50)
                if plane is not None:
                    print(f"frame {i}: plane detected, normal={plane.normal}, "
                          f"{int(plane.inliers.sum())}/{len(pts)} inliers")
            if plane is not None:
                over = ar.draw_cube(np.asarray(img), plane, Tcw, args.cube,
                                    cfg.fx, cfg.fy, cfg.cx, cfg.cy)
                import matplotlib.image
                path = os.path.join(args.out, f"ar_{i:04d}.png")
                matplotlib.image.imsave(path, np.clip(over, 0, 255).astype(np.uint8),
                                        cmap="gray", vmin=0, vmax=255)
                written.append(path)
            if args.frames and i + 1 >= args.frames:
                break
    finally:
        if ds is not None:
            ds.close()
    print(f"wrote {len(written)} AR frames to {args.out}")
    return plane, written


if __name__ == "__main__":
    main()
