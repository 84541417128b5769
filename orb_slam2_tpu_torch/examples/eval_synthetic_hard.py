"""Hard synthetic evaluation: long noisy surveys and loop revisits (EVAL.md).

The accuracy benchmark standing in for TUM / KITTI where no real sequence
is at hand: a PlateWorld relief scene under an ImperfectCamera (exposure
hunting, pixel noise, vignetting), trajectories:

  survey : 500-frame lawn-mower raster, no revisit -> open-loop drift
  loop   : 360-frame circular survey with revisit -> loop-closure accuracy
  mono-loop : the same revisit sequence monocular -> 7-DoF loop correction
  long   : 1000+-frame forward-motion drive closing one big loop
           (KITTI-00-flavoured; exercises capacity paths: DB erase,
           trajectory rehoming, covisibility at scale) [--long]

Run on the card:
  python -u -m orb_slam2_tpu_torch.examples.eval_synthetic_hard --json results.json
On the CPU (slow, smaller):
  python -m orb_slam2_tpu_torch.examples.eval_synthetic_hard --small --cpu
"""
import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np


def run_sequence(cfg, world_cam, gt, sensor, label, enable_loops=True,
                 pipeline_depth=0, vocabulary=None, result_dir=None, device="cuda"):
    from ..pipeline.system import SlamSystem
    from ..utils import trajectory as traj_io
    from ..utils.synthetic import ate_rmse

    s = SlamSystem(cfg, vocabulary=vocabulary,
                   enable_loop_closing=enable_loops,
                   pipeline_depth=pipeline_depth, device=device)
    t0 = time.time()
    lost = 0
    for i, T in enumerate(gt):
        if sensor == "stereo":
            left, right, _ = world_cam.render_stereo(T, cfg.baseline, i)
            Tcw = s.track_stereo(left, right, i / cfg.fps)
        else:
            img, depth = world_cam.render_with_depth(T, i)
            if sensor == "rgbd":
                Tcw = s.track_rgbd(img, depth, i / cfg.fps)
            else:
                Tcw = s.track_monocular(img, i / cfg.fps)
        if Tcw is None:
            lost += 1
        if i % 50 == 0:
            print(f"  [{label}] frame {i}/{len(gt)} kf={s.get_map_stats()['n_keyframes']} "
                  f"lost={lost} ({time.time()-t0:.0f}s)", flush=True)
    s.flush()
    wall = time.time() - t0

    traj = s.get_trajectory()
    est = [T for _, T in traj]
    gt_traj = [(i / cfg.fps, T) for i, T in enumerate(gt)]
    mono = sensor == "mono"
    rmse = ate_rmse(traj, gt_traj, with_scale=mono) if len(est) >= 2 else float("inf")
    path_len = sum(np.linalg.norm(gt[i + 1][:3, 3] - gt[i][:3, 3])
                   for i in range(len(gt) - 1))
    # Coverage semantics of the TUM evaluation tool the reference defers to
    # (include/System.h:130): an ATE over tracked frames only is meaningless
    # under heavy loss, so a row tracking < 90% of its frames is a sequence
    # FAILURE whatever its RMSE.
    tracked_frac = len(est) / max(len(gt), 1)
    status = "ok" if tracked_frac >= 0.9 else "FAIL(coverage)"
    res = dict(label=label, frames=len(gt), tracked=len(est), lost=lost,
               tracked_frac=round(tracked_frac, 4), status=status,
               kf=int(s.m.n_keyframes), pts=int(s.m.n_points),
               kf_seq_total=s._kf_seq_host,
               loops=s.n_loops_closed, ate_cm=rmse * 100,
               path_m=path_len, wall_s=wall,
               ms_per_frame=wall / len(gt) * 1e3)
    print(f"  [{label}] {status} ATE {rmse*100:.1f} cm over {path_len:.1f} m "
          f"(tracked {100*tracked_frac:.1f}%), "
          f"kf={res['kf']} (inserted {res['kf_seq_total']}) "
          f"loops={res['loops']} lost={lost} ({wall:.0f}s)", flush=True)
    if result_dir:
        # trajectory artifacts, as the reference's committed
        # result/{Camera,KeyFrame}Trajectory files (SURVEY.md section 4.2)
        os.makedirs(result_dir, exist_ok=True)
        traj_io.save_tum(os.path.join(result_dir, f"{label}_frames_tum.txt"),
                         traj)
        traj_io.save_tum(os.path.join(result_dir, f"{label}_keyframes_tum.txt"),
                         s.keyframe_trajectory())
    if os.environ.get("EVAL_METRICS_DIR"):
        # per-frame tracking metrics (inliers, state, KF events): why
        # tracking dies, from what the system already records
        md = os.environ["EVAL_METRICS_DIR"]
        os.makedirs(md, exist_ok=True)
        with open(os.path.join(md, f"{label}_metrics.json"), "w") as fh:
            json.dump(s.metrics, fh)
    return res


# EVAL.md's rows, in the order main runs them
ROWS = ("survey-rgbd", "loop-rgbd", "loop-mono", "long-forward-rgbd", "torture-forward-rgbd",
        "fig8-rgbd", "fig8-mono", "block-stereo", "block-rgbd")


class Row(NamedTuple):
    """One row of the evaluation: its config, the camera its frames render
    through (`cam.render_with_depth(T, i)` / `cam.render_stereo(T, cfg.baseline,
    i)` in frame order), the ground-truth camera-to-world poses, the sensor
    ("rgbd", "mono" or "stereo") and whether loop closing runs."""
    name: str
    cfg: object
    cam: object
    gt: list
    sensor: str
    enable_loops: bool


def _base_config(small):
    from ..utils.config import SENSOR_RGBD, SlamConfig
    if small:
        W, H, fx, nf = 320, 240, 260.0, 600
    else:
        W, H, fx, nf = 640, 480, 517.3, 1000
    # the capacities of bench.py's configuration
    return SlamConfig(fx=fx, fy=fx, cx=W / 2, cy=H / 2, width=W, height=H, bf=fx * 0.25,
                      sensor=SENSOR_RGBD, fps=30.0, th_depth=40.0, n_features=nf,
                      max_keyframes=128, max_map_points=1 << 14)


def row(name, small=False, cam=None):
    """The row `name` of ROWS, with the parameters of the evaluation
    (`--small`: the reduced CPU size). `cam`: the ImperfectCamera to render
    through, where a caller shares one between rows; by default a fresh one.
    main runs block-rgbd through block-stereo's camera, so its noise
    continues where block-stereo's 2 draws a frame ended: a fresh
    block-rgbd camera draws those first."""
    import dataclasses

    from ..utils.config import SENSOR_MONOCULAR, SENSOR_STEREO
    from ..utils.synthetic import (BlockWorld, ImperfectCamera, PlateWorld,
                                   city_block_trajectory, figure_eight_trajectory,
                                   forward_trajectory, loop_trajectory, survey_trajectory)

    if name not in ROWS:
        raise ValueError(f"no row {name!r}; the rows are {ROWS}")
    cfg = _base_config(small)
    fx, W, H, cx, cy = cfg.fx, cfg.width, cfg.height, cfg.cx, cfg.cy
    n_loop = 110 if small else 360
    if name == "survey-rgbd":
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0, extent=14.0, n_plates=300)
        return Row(name, cfg, cam or ImperfectCamera(world),
                   survey_trajectory(160 if small else 500, extent=9.0, rows=6), "rgbd", False)
    if name == "loop-rgbd":
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0)
        return Row(name, cfg, cam or ImperfectCamera(world),
                   loop_trajectory(n_loop, radius=3.0), "rgbd", True)
    if name == "loop-mono":
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0)
        return Row(name, dataclasses.replace(cfg, sensor=SENSOR_MONOCULAR, bf=0.0),
                   cam or ImperfectCamera(world, noise_sigma=2.0),
                   loop_trajectory(n_loop, radius=3.0), "mono", True)
    if name in ("long-forward-rgbd", "torture-forward-rgbd"):
        # KITTI-00-scale drive: one big loop, hundreds of keyframes (DB
        # erase, trajectory rehoming, covisibility and the K-capacity
        # guard), with capacities that let the keyframe count climb past
        # 200 before culling bounds it
        if not small:
            cfg = dataclasses.replace(cfg, max_keyframes=256, max_map_points=1 << 15)
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0, extent=30.0, n_plates=900, seed=11)
        if name == "long-forward-rgbd":
            # softer photometrics: this row tests capacity at scale, and at
            # VGA the default amp=0.25 crest clips ~25% of texture pixels;
            # 0.08 m/frame = 8.3 px/frame optical flow at VGA/517fx/z=5,
            # inside the motion-model matcher's ~13 px/frame envelope
            return Row(name, cfg, cam or ImperfectCamera(world, exposure_amp=0.15,
                                                         noise_sigma=3.0),
                       forward_trajectory(400 if small else 1200, speed=0.08, close_loop=True),
                       "rgbd", True)
        # the torture photometrics: exposure 0.25 and 0.12 m/frame, the
        # values documented as fatal (inliers crash at the gain-0.75 trough);
        # the wide-window retry and the RGB-D th=3 local search
        # (src/Tracking.cc:1804-1807) must carry it
        return Row(name, cfg, cam or ImperfectCamera(world, exposure_amp=0.25, noise_sigma=3.0),
                   forward_trajectory(400 if small else 900, speed=0.12, close_loop=True),
                   "rgbd", True)
    if name in ("fig8-rgbd", "fig8-mono"):
        # the figure eight: drift disconnects each crossover revisit, so
        # detect -> Sim3 -> correct -> essential graph -> global BA fires
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0, extent=14.0, n_plates=400, seed=5)
        gt = figure_eight_trajectory(220 if small else 560, radius=3.2)
        if name == "fig8-rgbd":
            return Row(name, cfg, cam or ImperfectCamera(world, noise_sigma=3.0), gt, "rgbd",
                       True)
        return Row(name, dataclasses.replace(cfg, sensor=SENSOR_MONOCULAR, bf=0.0),
                   cam or ImperfectCamera(world, noise_sigma=2.0), gt, "mono", True)
    # the street-canyon circuit (the KITTI regime): optical axis along the
    # motion, a depth-stratified scene, 90-degree turns, one loop around the
    # block; stereo with a 0.5 m baseline (th_depth * b = 20 m, like KITTI's
    # 35 * 0.54) and RGB-D
    world = BlockWorld(fx, fx, cx, cy, W, H)
    gt = city_block_trajectory(300 if small else 780, corner_radius=6.0, speed=0.15,
                               overshoot=0.12)
    if name == "block-stereo":
        return Row(name, dataclasses.replace(cfg, sensor=SENSOR_STEREO, bf=fx * 0.5),
                   cam or ImperfectCamera(world, noise_sigma=3.0, exposure_amp=0.15), gt,
                   "stereo", True)
    if cam is None:
        cam = ImperfectCamera(world, noise_sigma=3.0, exposure_amp=0.15)
        for _ in range(2 * len(gt)):
            cam.rng.normal(0.0, cam.noise_sigma, (H, W))
    return Row(name, cfg, cam, gt, "rgbd", True)


def row_frames(r, n=None, ahead=48, workers=8):
    """Row r's first n frames (all by default) in frame order, as
    `run_sequence` renders them: ("rgbd", gray, depth), ("mono", gray, None)
    or ("stereo", left, right) float32 images. The clean renders run on a
    thread pool at most `ahead` frames ahead of the consumer; the camera's
    noise is drawn in frame order (left before right), as a sequential
    render draws it."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    gt = r.gt[:n]
    world, cam = r.cam.world, r.cam
    if r.sensor == "stereo":
        def render(T):
            return world.render_stereo(T, r.cfg.baseline)
    else:
        render = world.render_with_depth
    with ThreadPoolExecutor(max_workers=min(workers, os.cpu_count() or 1)) as pool:
        queue = deque(pool.submit(render, T) for T in gt[:ahead])
        for i in range(len(gt)):
            if i + ahead < len(gt):
                queue.append(pool.submit(render, gt[i + ahead]))
            a, b, *_ = queue.popleft().result()
            if r.sensor == "stereo":
                yield r.sensor, cam.degrade(a, i), cam.degrade(b, i)
            else:
                yield r.sensor, cam.degrade(a, i), (b if r.sensor == "rgbd" else None)


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="reduced size for CPU smoke runs")
    ap.add_argument("--skip-survey", action="store_true")
    ap.add_argument("--skip-loop", action="store_true")
    ap.add_argument("--skip-mono", action="store_true")
    ap.add_argument("--long", action="store_true",
                    help="also run the 1000+-frame forward-motion loop drive")
    ap.add_argument("--torture", action="store_true",
                    help="long-drive torture photometrics row (exposure 0.25, speed 0.12)")
    ap.add_argument("--ab-loops", action="store_true",
                    help="re-run loop-closing rows with enable_loops=False for A/B deltas")
    ap.add_argument("--fig8", action="store_true",
                    help="full-resolution figure-eight (two real loop closures), rgbd + mono")
    ap.add_argument("--block", action="store_true",
                    help="forward-facing street-canyon circuit (KITTI regime), stereo + rgbd")
    ap.add_argument("--json", default=None, help="write results as JSON")
    ap.add_argument("--result-dir", default=None,
                    help="save TUM-format trajectory artifacts here")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    if args.cpu:
        device = "cpu"

    # place recognition at the reference's scale (src/System.cc:58-77): the
    # complete k=10/depth=6 (10^6-word) synthetic tree, as bench.py; the tiny
    # on-the-fly vocabulary aliases badly and spams Sim3 attempts
    voc = None
    if not args.small:
        from ..bow.vocabulary import synth_vocabulary
        voc = synth_vocabulary(k=10, depth=6, device=device)

    results = []

    def run_row(r):
        results.append(run_sequence(r.cfg, r.cam, r.gt, r.sensor, r.name,
                                    enable_loops=r.enable_loops, vocabulary=voc,
                                    result_dir=args.result_dir, device=device))
        if r.enable_loops and args.ab_loops:
            # open-loop A/B twin: same sequence, loop
            # closing disabled — EVAL.md reports the closure's ATE delta
            results.append(run_sequence(r.cfg, r.cam, r.gt, r.sensor, r.name + "-noloop",
                                        enable_loops=False, vocabulary=voc,
                                        result_dir=args.result_dir, device=device))

    names = [name for name, on in (
        ("survey-rgbd", not args.skip_survey), ("loop-rgbd", not args.skip_loop),
        ("loop-mono", not args.skip_mono), ("long-forward-rgbd", args.long),
        ("torture-forward-rgbd", args.torture), ("fig8-rgbd", args.fig8),
        ("fig8-mono", args.fig8)) if on]
    for name in names:
        run_row(row(name, args.small))
    if args.block:
        # one camera for both block rows, as the evaluation renders them
        stereo = row("block-stereo", args.small)
        run_row(stereo)
        run_row(row("block-rgbd", args.small, cam=stereo.cam))

    print("\n== summary ==")
    for r in results:
        print(f"{r['label']:18s} {r['status']:15s} ATE {r['ate_cm']:7.1f} cm  "
              f"path {r['path_m']:6.1f} m  tracked {100*r['tracked_frac']:5.1f}%  "
              f"kf {r['kf']:4d}  loops {r['loops']}  lost {r['lost']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json}")
    return results

if __name__ == "__main__":
    main()
