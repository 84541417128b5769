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

    from ..utils.config import SENSOR_MONOCULAR, SENSOR_RGBD, SENSOR_STEREO, SlamConfig
    from ..utils.synthetic import (ImperfectCamera, PlateWorld, forward_trajectory,
                                   loop_trajectory, survey_trajectory)

    if args.small:
        W, H, fx, nf = 320, 240, 260.0, 600
        n_survey, n_loop, n_long = 160, 110, 400
        kw = dict(max_keyframes=128, max_map_points=1 << 14)
    else:
        W, H, fx, nf = 640, 480, 517.3, 1000
        n_survey, n_loop, n_long = 500, 360, 1200
        # the capacities of bench.py's configuration
        kw = dict(max_keyframes=128, max_map_points=1 << 14)
    cx, cy = W / 2, H / 2
    baseline = 0.25
    cfg = SlamConfig(fx=fx, fy=fx, cx=cx, cy=cy, width=W, height=H,
                     bf=fx * baseline, sensor=SENSOR_RGBD, fps=30.0,
                     th_depth=40.0, n_features=nf, **kw)

    # place recognition at the reference's scale (src/System.cc:58-77): the
    # complete k=10/depth=6 (10^6-word) synthetic tree, as bench.py; the tiny
    # on-the-fly vocabulary aliases badly and spams Sim3 attempts
    voc = None
    if not args.small:
        from ..bow.vocabulary import synth_vocabulary
        voc = synth_vocabulary(k=10, depth=6, device=device)

    results = []

    def run_row(cfg_, cam_, gt_, sensor_, label_, enable_loops=True):
        results.append(run_sequence(cfg_, cam_, gt_, sensor_, label_,
                                    enable_loops=enable_loops, vocabulary=voc,
                                    result_dir=args.result_dir, device=device))
        if enable_loops and args.ab_loops:
            # open-loop A/B twin: same sequence, loop
            # closing disabled — EVAL.md reports the closure's ATE delta
            results.append(run_sequence(cfg_, cam_, gt_, sensor_,
                                        label_ + "-noloop",
                                        enable_loops=False, vocabulary=voc,
                                        result_dir=args.result_dir, device=device))

    if not args.skip_survey:
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0, extent=14.0,
                           n_plates=300)
        cam = ImperfectCamera(world)
        gt = survey_trajectory(n_survey, extent=9.0, rows=6)
        run_row(cfg, cam, gt, "rgbd", "survey-rgbd", enable_loops=False)
    if not args.skip_loop:
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0)
        cam = ImperfectCamera(world)
        gt = loop_trajectory(n_loop, radius=3.0)
        run_row(cfg, cam, gt, "rgbd", "loop-rgbd", enable_loops=True)
    if not args.skip_mono:
        import dataclasses
        cfg_m = dataclasses.replace(cfg, sensor=SENSOR_MONOCULAR, bf=0.0)
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0)
        cam = ImperfectCamera(world, noise_sigma=2.0)
        gt = loop_trajectory(n_loop, radius=3.0)
        run_row(cfg_m, cam, gt, "mono", "loop-mono", enable_loops=True)
    if args.long:
        # KITTI-00-scale drive: one big loop, hundreds of keyframes —
        # exercises DB erase, trajectory rehoming, covisibility and the
        # K-capacity guard; larger capacities so the
        # KF count can genuinely climb past 200 before culling bounds it
        import dataclasses as _dc
        cfg_l = cfg if args.small else _dc.replace(
            cfg, max_keyframes=256, max_map_points=1 << 15)
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0, extent=30.0,
                           n_plates=900, seed=11)
        # softer photometrics than the survey/loop runs: this sequence tests
        # CAPACITY at scale (hundreds of KFs, DB erase, rehoming), while the
        # exposure-torture coverage lives in the other three sequences — at
        # VGA the default amp=0.25 crest clips ~25% of texture pixels to
        # saturation (flat patches) and tracking dies at every crest.
        cam = ImperfectCamera(world, exposure_amp=0.15, noise_sigma=3.0)
        # speed 0.08 m/frame = 8.3 px/frame optical flow at VGA/517fx/z=5 —
        # inside the ~13 px/frame envelope the motion-model matcher tracks
        # through the ImperfectCamera's exposure troughs (0.12 = 12.4 px
        # measured marginal: inliers crash at the gain-0.75 trough and the
        # velocity model degrades past the search window). Radius 13.7 m
        # keeps the circle inside the plate field and below the texture
        # tile period (no perceptual self-aliasing).
        gt = forward_trajectory(n_long, speed=0.08, close_loop=True)
        run_row(cfg_l, cam, gt, "rgbd", "long-forward-rgbd", enable_loops=True)
    if args.torture:
        # Torture photometrics variant of the long drive:
        # exposure_amp 0.25 and 0.12 m/frame — the values the round-4
        # harness documented as fatal ("inliers crash at the gain-0.75
        # trough and the velocity model degrades past the search window").
        # Tracker-envelope work (wide-window retry + RGBD th=3 local search,
        # src/Tracking.cc:1804-1807) must carry it, not world softening.
        import dataclasses as _dc
        cfg_t = cfg if args.small else _dc.replace(
            cfg, max_keyframes=256, max_map_points=1 << 15)
        n_tort = 400 if args.small else 900
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0, extent=30.0,
                           n_plates=900, seed=11)
        cam = ImperfectCamera(world, exposure_amp=0.25, noise_sigma=3.0)
        gt = forward_trajectory(n_tort, speed=0.12, close_loop=True)
        run_row(cfg_t, cam, gt, "rgbd", "torture-forward-rgbd",
                enable_loops=True)
    if args.fig8:
        # figure-eight at full resolution: drift genuinely disconnects each
        # crossover revisit, so the complete detect -> Sim3 -> correct ->
        # essential graph -> (amortized) GBA chain must fire — twice — at
        # reference scale with the 10^6-word vocabulary.
        # RGBD and monocular (the 7-DoF correction path).
        from ..utils.synthetic import figure_eight_trajectory
        n8 = 220 if args.small else 560
        world = PlateWorld(fx, fx, cx, cy, W, H, z0=5.0, extent=14.0,
                           n_plates=400, seed=5)
        gt = figure_eight_trajectory(n8, radius=3.2)
        cam = ImperfectCamera(world, noise_sigma=3.0)
        run_row(cfg, cam, gt, "rgbd", "fig8-rgbd", enable_loops=True)
        import dataclasses as _dc
        cfg_m8 = _dc.replace(cfg, sensor=SENSOR_MONOCULAR, bf=0.0)
        cam = ImperfectCamera(world, noise_sigma=2.0)
        run_row(cfg_m8, cam, gt, "mono", "fig8-mono", enable_loops=True)
    if args.block:
        # forward-facing street-canyon circuit (the KITTI regime): optical
        # axis along motion, depth-stratified scene,
        # 90-degree turns, one big loop around the block. Stereo (the
        # reference's KITTI sensor — first at-scale evidence for the SAD
        # matcher) and RGBD.
        from ..utils.synthetic import (BlockWorld,
                                                   city_block_trajectory)
        import dataclasses as _dc
        n_blk = 300 if args.small else 780
        world = BlockWorld(fx, fx, cx, cy, W, H)
        gt = city_block_trajectory(n_blk, corner_radius=6.0, speed=0.15,
                                   overshoot=0.12)
        cam = ImperfectCamera(world, noise_sigma=3.0, exposure_amp=0.15)
        # KITTI-flavored stereo: baseline 0.5 m -> close threshold
        # th_depth * b = 20 m, like KITTI's 35 * 0.54
        cfg_st = _dc.replace(cfg, sensor=SENSOR_STEREO, bf=fx * 0.5)
        run_row(cfg_st, cam, gt, "stereo", "block-stereo", enable_loops=True)
        run_row(cfg, cam, gt, "rgbd", "block-rgbd", enable_loops=True)

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
