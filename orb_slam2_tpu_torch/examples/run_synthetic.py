"""End-to-end SLAM on the synthetic textured-plane world.

The repository's example (the analogue of the reference's
`Examples/RGB-D/rgbd_tum.cc` etc., with a generated dataset): runs the whole
pipeline and reports the ATE RMSE against the generating trajectory.

Usage: python -m orb_slam2_tpu_torch.examples.run_synthetic [--frames 30] \
    [--sensor rgbd|mono|stereo] [--cpu]
"""
import argparse
import time

import numpy as np


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--sensor", default="rgbd", choices=["rgbd", "mono", "stereo"])
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--features", type=int, default=500)
    ap.add_argument("--step", type=float, default=0.03)
    ap.add_argument("--trajectory", default="lateral", choices=["lateral", "loop"],
                    help="'loop' = closed circular survey that revisits its "
                         "start (exercises loop closing)")
    ap.add_argument("--radius", type=float, default=3.0,
                    help="loop trajectory radius (world units)")
    ap.add_argument("--baseline", type=float, default=0.25,
                    help="stereo/RGBD baseline in world units (z0=5 -> "
                         "z/b ~ 20, comparable to TUM fr1 geometry)")
    ap.add_argument("--world", default="plates", choices=["plates", "plane"],
                    help="'plates' adds 3D relief (realistic geometry); "
                         "'plane' is the degenerate single-plane scene")
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="pipelined tracking stream: the device runs ahead of "
                         "the host by this many frames (0 = synchronous)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--plot", default=None, help="save a map/trajectory PNG")
    ap.add_argument("--live-view", action="store_true",
                    help="run the LiveViewer thread (PNG stream / window)")
    args = ap.parse_args(argv)
    if args.cpu:
        device = "cpu"

    from ..pipeline.system import PENDING, SlamSystem
    from ..utils.config import SENSOR_MONOCULAR, SENSOR_RGBD, SENSOR_STEREO, SlamConfig
    from ..utils.synthetic import (PlaneWorld, PlateWorld, ate_rmse, lateral_trajectory,
                                   loop_trajectory)

    sensor = dict(mono=SENSOR_MONOCULAR, stereo=SENSOR_STEREO, rgbd=SENSOR_RGBD)[args.sensor]
    fx = fy = 300.0
    cx, cy = args.width / 2, args.height / 2
    baseline = args.baseline
    loop = args.trajectory == "loop"
    cfg = SlamConfig(
        fx=fx, fy=fy, cx=cx, cy=cy, width=args.width, height=args.height,
        n_features=args.features, bf=fx * baseline if sensor != SENSOR_MONOCULAR else 0.0,
        sensor=sensor, fps=10.0, th_depth=40.0,
        max_keyframes=128 if loop else 64, max_map_points=1 << 14,
        ba_local_cams=16, ba_fixed_cams=16, ba_max_points=1 << 11, ba_max_obs=8,
        max_local_keyframes=32, max_local_points=1 << 12,
    )
    world_cls = PlateWorld if args.world == "plates" else PlaneWorld
    world = world_cls(fx, fy, cx, cy, args.width, args.height, z0=5.0)
    if loop:
        gt = loop_trajectory(args.frames, radius=args.radius)
    else:
        gt = lateral_trajectory(args.frames, step=args.step, yaw_rate=0.004)

    sys_ = SlamSystem(cfg, enable_loop_closing=not args.no_loop_closing,
                      pipeline_depth=args.pipeline_depth, device=device)
    live = None
    if args.live_view:
        from ..viewer import LiveViewer
        live = LiveViewer(sys_, out_dir=".", fps=1.0)
    times = []
    for i, T_wc in enumerate(gt):
        t0 = time.time()
        if sensor == SENSOR_RGBD:
            img, depth = world.render_with_depth(T_wc)
            Tcw = sys_.track_rgbd(img, depth, i * 0.1)
        elif sensor == SENSOR_STEREO:
            img = world.render(T_wc)
            T_right = T_wc.copy()
            T_right[:3, 3] += T_wc[:3, :3] @ np.array([baseline, 0, 0])
            img_r = world.render(T_right)
            Tcw = sys_.track_stereo(img, img_r, i * 0.1)
        else:
            img = world.render(T_wc)
            Tcw = sys_.track_monocular(img, i * 0.1)
        dt = time.time() - t0
        times.append(dt)
        if live is not None:
            live.update(img)
        state = sys_.metrics[-1] if sys_.metrics else {}
        kf = state.get('n_kf') or '-'
        pts = state.get('n_pts') or '-'
        tracked = "pending" if Tcw is PENDING else Tcw is not None
        print(f"frame {i:3d}  {dt*1000:7.1f} ms  tracked={tracked} "
              f"inliers={state.get('inliers', '-')} kf={kf} pts={pts}")

    sys_.flush()   # retire the frames still in flight
    if live is not None:
        live.join()
        print(f"live viewer: {live.n_renders} renders (map_live.png / frame_live.png)")
    traj = sys_.get_trajectory()
    print(f"\ntracked {len(traj)}/{args.frames} frames; "
          f"median frame time {np.median(times[2:])*1000:.1f} ms")
    print(f"keyframes: {int(sys_.m.n_keyframes)}  map points: "
          f"{int(sys_.m.n_points)}  loops closed: {sys_.n_loops_closed}")
    if args.plot:
        from .. import viewer
        viewer.plot_map(sys_.m, list(traj), path=args.plot, title=f"synthetic {args.sensor}")
        print("map plot:", args.plot)
    if len(traj) >= args.frames * 0.9:
        gt_traj = [(i * 0.1, T) for i, T in enumerate(gt)]
        rmse = ate_rmse(traj, gt_traj, with_scale=sensor == SENSOR_MONOCULAR)
        print(f"ATE RMSE: {rmse*100:.2f} cm over {args.step*(args.frames-1):.2f} m trajectory")
        return rmse
    print("TRACKING FAILED")
    return None


if __name__ == "__main__":
    main()
