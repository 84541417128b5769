#!/usr/bin/env python3
"""How far float32 rounding moves an RGB-D evaluation row, in the port and
in the JAX reference (ROADMAP Queue 3, block-rgbd).

    env JAX_PLATFORMS=cpu python scripts/row_spread_report.py ROW \
        [--frames N] [--side-by-side N] [--full D ...]

`--frames N` (12 by default): the first N frames of the row
(`eval_synthetic_hard.row`) twice through each package on the CPU. The
reference's SlamSystem is handed the port's frames as they are and with
every keypoint coordinate moved by one float32 ulp; the port's runs at one
torch thread and at eight, which sum float32 reductions in other orders.
After every frame: how many points of both maps part by more than 1e-6 and
1e-5 m, the largest gap and the largest keyframe-pose gap, for each pair.

`--side-by-side N`: the port (this process's torch threads) and the
reference over the first N frames; at each of the first frames where the
state, a count or the local-map inlier set differs, each differing
keypoint's chi2 at each side's final pose (the port's from its pose
solve) against its threshold, and how far that point and the poses part.

`--full D ...`: the whole row through the reference (`chip_smoke_reference.
row_lap`) with every keypoint coordinate moved by D ulps (+1 toward +inf,
-1 toward -inf): the record REFERENCE_ROWS holds. A row is long on the CPU:
run it single-threaded in the background (README, chip_smoke_reference.py).
"""
import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import chip_smoke_reference as csr  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from orb_slam2_tpu.bow import vocabulary as jvoc  # noqa: E402
from orb_slam2_tpu.pipeline import system as jsystem  # noqa: E402
from orb_slam2_tpu.pipeline import tracking_step as jts  # noqa: E402
from orb_slam2_tpu.solvers import reproj as jreproj  # noqa: E402
from orb_slam2_tpu_torch.bow.vocabulary import synth_vocabulary  # noqa: E402
from orb_slam2_tpu_torch.examples import eval_synthetic_hard as ev  # noqa: E402
from orb_slam2_tpu_torch.pipeline import frame as tframe  # noqa: E402
from orb_slam2_tpu_torch.pipeline import tracking_step as tts  # noqa: E402
from orb_slam2_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from orb_slam2_tpu_torch.solvers import pose_opt as tpo  # noqa: E402

FIELDS = ("state", "inliers", "n_mm", "mm_inl", "ref_matches", "kf")
REPORTED = 3        # --side-by-side: differing frames printed in full


def moved(f, ulps):
    """The reference frame f with every keypoint coordinate moved by ulps."""
    xy = np.asarray(f.xy)
    for _ in range(abs(ulps)):
        xy = np.nextafter(xy, np.float32(np.inf if ulps > 0 else -np.inf))
    return f._replace(xy=jnp.asarray(xy, jnp.float32))


def _reference(r):
    jts.full_tracking_step_from_images = \
        lambda cfg, m, f, *rest: jts.full_tracking_step(cfg, m, f, *rest[:-1])
    return jsystem.SlamSystem(csr.jax_config(r.cfg), vocabulary=jvoc.synth_vocabulary(10, 6),
                              enable_loop_closing=r.enable_loops)


def _track_reference(s, f, i, fps):
    if s.state != jsystem.OK:
        s._flush_pipeline()
    s._track(f, i / fps)


def _gaps(a_pos, a_valid, b_pos, b_valid, a_kf, b_kf):
    both = a_valid & b_valid
    gap = np.abs(a_pos - b_pos).max(1) * both
    return (f"points > 1e-6 m: {(gap > 1e-6).sum()}, > 1e-5 m: {(gap > 1e-5).sum()} of "
            f"{both.sum()}, largest {gap.max():.3e} m; keyframe poses {np.abs(a_kf - b_kf).max():.3e}")


def spread(r, n):
    ra, rb = _reference(r), _reference(r)
    voc = synth_vocabulary(10, 6, device="cpu")
    pa, pb = (SlamSystem(r.cfg, vocabulary=voc, device="cpu",
                         enable_loop_closing=r.enable_loops) for _ in range(2))
    threads = torch.get_num_threads()
    for i, (_, gray, depth) in enumerate(ev.row_frames(r, n, workers=2)):
        f = csr.jax_frame(tframe.make_frame_rgbd(torch.from_numpy(gray),
                                                 torch.from_numpy(depth), r.cfg))
        _track_reference(ra, f, i, r.cfg.fps)
        _track_reference(rb, moved(f, 1), i, r.cfg.fps)
        for s, t in ((pa, 1), (pb, 8)):
            torch.set_num_threads(t)
            s.track_rgbd(gray, depth, i / r.cfg.fps)
        torch.set_num_threads(threads)
        kf = "keyframe" if ra.metrics and ra.metrics[-1].get("kf") else "        "
        print(f"frame {i:3d} {kf} reference, one ulp: "
              f"{_gaps(*(np.asarray(x) for x in (ra.m.pt_pos, ra.m.pt_valid, rb.m.pt_pos, rb.m.pt_valid, ra.m.kf_pose, rb.m.kf_pose)))}",  # noqa: E501
              flush=True)
        print(f"               port, 1 / 8 threads: "
              f"{_gaps(*(x.numpy() for x in (pa.m.pt_pos, pa.m.pt_valid, pb.m.pt_pos, pb.m.pt_valid, pa.m.kf_pose, pb.m.kf_pose)))}",  # noqa: E501
              flush=True)


def side_by_side(r, n):
    """The port and the reference on the same frames; each frame where they
    differ, and the chi2 of the keypoints whose local-map binding differs."""
    cap = {}
    solve, step, jstep = tpo.optimize_pose, tts.full_tracking_step_from_images, \
        jts.full_tracking_step

    def optimize_pose(*a, **kw):
        cap["solve"] = (a, solve(*a, **kw))
        return cap["solve"][1]

    def port_step(*a, **kw):
        out = step(*a, **kw)
        cap["port"] = dict(matched=out.matched_pt.numpy().copy(), Tcw=out.Tcw.double().numpy(),
                           pos=out.m.pt_pos.numpy().copy(), solve=cap["solve"])
        return out

    def reference_step(cfg, m, f, *rest):
        out = jstep(cfg, m, f, *rest)
        cap["ref"] = dict(matched=np.array(out.matched_pt), Tcw=np.array(out.Tcw),
                          pos=np.array(out.m.pt_pos))
        return out

    tpo.optimize_pose, tts.full_tracking_step_from_images = optimize_pose, port_step
    js = _reference(r)
    jts.full_tracking_step = reference_step
    ts = SlamSystem(r.cfg, vocabulary=synth_vocabulary(10, 6, device="cpu"), device="cpu",
                    enable_loop_closing=r.enable_loops)
    cam = csr.jax_config(r.cfg).camera()
    sigma2 = np.asarray(r.cfg.level_sigma2, np.float64)
    differing, t0 = [], time.perf_counter()
    try:
        for i, (_, gray, depth) in enumerate(ev.row_frames(r, n, workers=2)):
            cap.update(port=None, ref=None)
            ts.track_rgbd(gray, depth, i / r.cfg.fps)
            _track_reference(js, csr.jax_frame(tframe.make_frame_rgbd(
                torch.from_numpy(gray), torch.from_numpy(depth), r.cfg)), i, r.cfg.fps)
            a, b = ([s.metrics[-1].get(k) if s.metrics and s.metrics[-1]["frame"] == i
                     else None for k in FIELDS] for s in (ts, js))
            p, q = cap["port"], cap["ref"]
            keys = np.nonzero(p["matched"] != q["matched"])[0] if p and q else []
            if a == b and not len(keys):
                continue
            differing.append(i)
            if len(differing) > REPORTED:
                continue
            print(f"frame {i}: port {dict(zip(FIELDS, a))}\n  reference {dict(zip(FIELDS, b))}"
                  f" ({time.perf_counter() - t0:.0f} s)", flush=True)
            if not len(keys):
                continue
            (_, _, _, obs, level, valid), res = p["solve"][0][:6], p["solve"][1]
            print(f"  final poses part by {np.abs(p['Tcw'] - q['Tcw']).max():.3e}; "
                  f"{len(keys)} keypoints bound differently")
            for k in keys:
                pid = p["matched"][k] if p["matched"][k] >= 0 else q["matched"][k]
                stereo = bool(obs[k, 2] >= 0)
                chi2 = jreproj.edge_chi2(*jreproj.project_residual(
                    cam, jnp.asarray(q["Tcw"]), jnp.asarray(q["pos"][pid])[None],
                    jnp.asarray(obs[k].numpy())[None], jnp.asarray([stereo]))[::2],
                    jnp.asarray([1.0 / sigma2[int(level[k])]], jnp.float32))
                print(f"  keypoint {k} (level {int(level[k])}): point {p['matched'][k]} in the "
                      f"port, {q['matched'][k]} in the reference; in the port's pose solve: "
                      f"{bool(valid[k])}; chi2 port {float(res.chi2[k]):.6f}, reference "
                      f"{float(np.asarray(chi2).ravel()[0]):.6f}, threshold "
                      f"{jreproj.CHI2_STEREO if stereo else jreproj.CHI2_MONO}; the point's "
                      f"positions part by {np.abs(p['pos'][pid] - q['pos'][pid]).max():.3e} m",
                      flush=True)
    finally:
        tpo.optimize_pose, tts.full_tracking_step_from_images = solve, step
        jts.full_tracking_step = jstep
    kf = [sorted(e["frame"] for e in s.metrics if e.get("kf")) for s in (ts, js)]
    print(f"frames that differ: {len(differing)}, the first {differing[:10]}")
    print(f"keyframe frames: port {kf[0]}\n                 reference {kf[1]}")


def full(name, ulps):
    frame = csr.jax_frame
    csr.jax_frame = lambda f: moved(frame(f), ulps)
    try:
        rec = csr.row_lap(name)
    finally:
        csr.jax_frame = frame
    print(f"{name}, keypoints moved by {ulps} ulp: {rec}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("row", choices=[n for n in ev.ROWS if "mono" not in n and "stereo" not in n])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--side-by-side", type=int, default=0, metavar="N")
    ap.add_argument("--full", type=int, nargs="+", default=[], metavar="D")
    args = ap.parse_args()
    r = ev.row(args.row)
    if args.full:
        for d in args.full:
            full(args.row, d)
    elif args.side_by_side:
        side_by_side(r, args.side_by_side)
    else:
        spread(r, args.frames)


if __name__ == "__main__":
    main()
