#!/usr/bin/env python3
"""EVAL.md's rows through the PyTorch/CUDA port on one NVIDIA GPU, each held
to the JAX reference's SlamSystem on the same frames.

    python3 scripts/chip_eval_rows.py [--rows NAME ...] [--out PATH]

The rows (`orb_slam2_tpu_torch.examples.eval_synthetic_hard.row`) that
`chip_smoke.py` does not drive at full length: survey-rgbd (500 frames, loop
closing off), loop-rgbd (360), loop-mono (360), long-forward-rgbd (1200,
256 keyframes and 32,768 points), torture-forward-rgbd (900, the same
capacities, exposure amplitude 0.25 at 0.12 m a frame), block-rgbd (780)
and block-stereo (all 780 pairs). Each goes through the port's SlamSystem
on cuda:0 synchronously at full width (640x480, 1000 features,
`synth_vocabulary(10, 6)`), the frames rendered on threads ahead of the
tracker (`row_frames`, chip_smoke.RENDER_AHEAD), then flush().

Each row is held to REFERENCE_ROWS (`scripts/chip_smoke_reference.py
--rows-only`: the JAX SlamSystem on the CPU handed the port's CPU
extraction of the same renders) with chip_smoke's bands
(`chip_smoke.check_row`: the frames tracked, the keyframes inserted, the
closures, the ATE; loop-mono against the range of its three reference
runs, Sim3-aligned) and a finite map. At the first global BA of each row
that runs one, K9's assembly (at C = 256, E = 393,216 on the two forward rows, where
the global BA takes the PCG branch) is checked against its twin bit for
bit (`chip_smoke._lin_equal`, as the K9 GPU tests hold it) and timed
(`chip_smoke._queued_ms`) beside its bound.

Recorded per row: the checks' numbers beside the reference's, the median
ms of a frame without a keyframe and of one with a keyframe, each closure
frame's ms, each kernel's launches over the lap (counts set to 0 just
before it), the frames that took the wide-window retry, the fallback to
the reference keyframe and a relocalization, and the global BA's branch
(dense or PCG) at each call. Prints one {"rows": [...]} JSON line (and
writes it to --out). For a diagnosis, --twins NAME ... runs those kernels'
plain twins on the card instead (another float order). Exits non-zero when
any row fails a check, after all the rows selected ran. Needs CUDA.
Imports nothing of JAX.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orb_slam2_tpu_torch.bow.vocabulary import synth_vocabulary  # noqa: E402
from orb_slam2_tpu_torch.examples import eval_synthetic_hard as ev  # noqa: E402
from orb_slam2_tpu_torch.ops import cuda_ba as cb  # noqa: E402
from orb_slam2_tpu_torch.ops import launch  # noqa: E402
from orb_slam2_tpu_torch.pipeline import loop_closing, system  # noqa: E402
from orb_slam2_tpu_torch.solvers import pcg_ba, schur_ba  # noqa: E402
from orb_slam2_tpu_torch.utils import trajectory  # noqa: E402

# the rows the smoke does not drive at full length (its [loop] and [mono] run fig8)
ROWS = tuple(name for name in ev.ROWS if not name.startswith("fig8"))

# What the reference (orb_slam2_tpu, XLA path) gives on each row handed the
# port's CPU frames: `scripts/chip_smoke_reference.py --rows-only` (its
# SlamSystem with the row's config, loop closing as the row sets it,
# synth_vocabulary(10, 6); loop-mono three runs, RANSAC keys frame_id + k,
# k < 3): the loops and each closure's keyframe sequence number and frames,
# the frames tracked, the keyframes inserted and kept, the points, the
# keyframe frames, the states of the first 31 frames, the frames not tracked,
# the frames that fell back to the reference keyframe, the ATE (loop-mono:
# Sim3-aligned) and the CPU wall time.
REFERENCE_ROWS = {
    'survey-rgbd':
        {'loops': 0,
         'closures': [],
         'tracked': 500,
         'keyframes_inserted': 61,
         'keyframes': 61,
         'points': 5198,
         'kf_frames': [1, 2, 3, 5, 8, 14, 21, 32, 48, 63, 76, 106, 117, 126, 135, 142, 149, 157, 164,
                       171, 179, 188, 196, 203, 210, 217, 224, 231, 238, 246, 257, 270, 282, 292, 299,
                       306, 314, 321, 328, 335, 346, 353, 360, 367, 374, 381, 388, 395, 402, 410, 424,
                       434, 443, 450, 457, 464, 471, 478, 486, 493],
         'fallback_frames': [83, 84, 166, 167, 249, 250, 332, 333, 415, 416],
         'ate_m': 0.023517,
         'frames': 500,
         'states': [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                    1, 1, 1],
         'lost_frames': []},
    'loop-rgbd':
        {'loops': 0,
         'closures': [],
         'tracked': 360,
         'keyframes_inserted': 25,
         'keyframes': 25,
         'points': 1847,
         'kf_frames': [14, 15, 19, 24, 29, 37, 51, 79, 101, 126, 165, 194, 248, 284, 291, 298, 305,
                       312, 319, 326, 333, 340, 347, 354],
         'fallback_frames': [],
         'ate_m': 0.012257,
         'frames': 360,
         'states': [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                    1, 1, 1],
         'lost_frames': []},
    'loop-mono':
        [{'loops': 0,
          'closures': [],
          'tracked': 360,
          'keyframes_inserted': 65,
          'keyframes': 56,
          'points': 2177,
          'kf_frames': [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 22, 29, 36, 43, 50, 57, 64, 71,
                        78, 85, 92, 99, 106, 113, 120, 127, 134, 141, 148, 155, 162, 169, 176, 183,
                        190, 197, 204, 211, 218, 225, 232, 239, 246, 253, 260, 267, 274, 281, 288, 295,
                        302, 309, 316, 323, 330, 337, 344, 351, 358],
          'fallback_frames': [],
          'ate_m': 0.012828,
          'frames': 360,
          'states': [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                     1, 1, 1, 1],
          'lost_frames': [0]},
         {'loops': 0,
          'closures': [],
          'tracked': 360,
          'keyframes_inserted': 65,
          'keyframes': 57,
          'points': 2163,
          'kf_frames': [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 23, 30, 37, 44, 51, 58, 65,
                        72, 79, 86, 93, 100, 107, 114, 121, 128, 135, 142, 149, 156, 163, 170, 177,
                        184, 191, 198, 205, 213, 220, 227, 234, 241, 248, 255, 262, 269, 276, 283, 290,
                        297, 304, 311, 318, 325, 332, 339, 346, 353],
          'fallback_frames': [],
          'ate_m': 0.01459,
          'frames': 360,
          'states': [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                     1, 1, 1, 1],
          'lost_frames': [0]},
         {'loops': 0,
          'closures': [],
          'tracked': 360,
          'keyframes_inserted': 66,
          'keyframes': 57,
          'points': 2125,
          'kf_frames': [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 23, 30, 37, 44, 51, 58, 65,
                        72, 79, 86, 93, 100, 107, 114, 121, 128, 135, 142, 149, 156, 163, 170, 177,
                        184, 191, 198, 205, 212, 219, 226, 233, 240, 247, 254, 261, 268, 275, 282, 289,
                        296, 303, 310, 317, 324, 331, 338, 345, 352, 359],
          'fallback_frames': [],
          'ate_m': 0.012598,
          'frames': 360,
          'states': [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                     1, 1, 1, 1],
          'lost_frames': [0]}],
    'long-forward-rgbd':
        {'loops': 1,
         'closures': [{'kf_seq': 29,
                       'kf_frame': 1062,
                       'cand_frame': 0,
                       'cand_neighbour_frames': [14, 15, 20, 27, 36, 49, 72]}],
         'tracked': 1200,
         'keyframes_inserted': 46,
         'keyframes': 46,
         'points': 3494,
         'kf_frames': [14, 15, 20, 27, 36, 49, 72, 112, 147, 176, 225, 273, 325, 380, 417, 473, 524,
                       578, 630, 668, 714, 756, 807, 850, 903, 957, 1009, 1062, 1083, 1090, 1097, 1104,
                       1111, 1118, 1125, 1132, 1139, 1146, 1153, 1160, 1167, 1174, 1181, 1188, 1195],
         'fallback_frames': [],
         'ate_m': 0.174399,
         'frames': 1200,
         'states': [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                    1, 1, 1],
         'lost_frames': []},
    'torture-forward-rgbd':
        {'loops': 1,
         'closures': [{'kf_seq': 31,
                       'kf_frame': 803,
                       'cand_frame': 0,
                       'cand_neighbour_frames': [10, 11, 15, 20, 26, 38]}],
         'tracked': 900,
         'keyframes_inserted': 42,
         'keyframes': 42,
         'points': 3743,
         'kf_frames': [10, 11, 15, 20, 26, 38, 60, 85, 108, 134, 164, 200, 229, 263, 297, 325, 365,
                       403, 441, 475, 509, 542, 578, 613, 637, 675, 712, 739, 769, 803, 823, 830, 837,
                       844, 851, 858, 865, 872, 879, 886, 893],
         'fallback_frames': [],
         'ate_m': 0.111153,
         'frames': 900,
         'states': [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                    1, 1, 1],
         'lost_frames': []},
    'block-rgbd':
        {'loops': 1,
         'closures': [{'kf_seq': 104,
                       'kf_frame': 687,
                       'cand_frame': 5,
                       'cand_neighbour_frames': [0, 6, 10, 14, 18, 23, 28, 33, 37, 43, 49, 56, 63, 69,
                                                 73, 76, 80, 83, 85, 86, 87, 88, 90, 92, 95, 97, 99,
                                                 101, 108, 117, 126, 133, 140, 147, 154, 161]}],
         'tracked': 780,
         'keyframes_inserted': 119,
         'keyframes': 119,
         'points': 8230,
         'kf_frames': [5, 6, 10, 14, 18, 23, 28, 33, 37, 43, 49, 56, 63, 69, 73, 76, 80, 83, 85, 86,
                       87, 88, 90, 92, 95, 97, 99, 101, 108, 117, 126, 133, 140, 147, 154, 161, 168,
                       180, 191, 203, 213, 222, 230, 237, 244, 251, 257, 261, 266, 270, 277, 291, 302,
                       309, 316, 323, 330, 337, 347, 357, 367, 376, 383, 390, 397, 404, 411, 418, 425,
                       432, 439, 446, 453, 464, 476, 486, 493, 500, 507, 515, 522, 531, 542, 552, 559,
                       567, 574, 581, 587, 593, 599, 605, 611, 618, 626, 634, 642, 649, 656, 663, 670,
                       677, 687, 694, 701, 708, 715, 722, 729, 736, 743, 750, 757, 764, 771, 774, 776,
                       779],
         'fallback_frames': [],
         'ate_m': 0.039454,
         'frames': 780,
         'states': [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                    1, 1, 1],
         'lost_frames': []},
    'block-stereo':
        {'loops': 1,
         'closures': [{'kf_seq': 50,
                       'kf_frame': 675,
                       'cand_frame': 0,
                       'cand_neighbour_frames': [8, 9, 16, 22, 31, 42, 60, 89, 119, 136, 150, 160,
                                                 167]}],
         'tracked': 780,
         'keyframes_inserted': 62,
         'keyframes': 62,
         'points': 3820,
         'kf_frames': [8, 9, 16, 22, 31, 42, 60, 89, 119, 136, 150, 160, 167, 178, 185, 196, 206, 216,
                       233, 256, 288, 305, 318, 330, 337, 346, 354, 364, 374, 385, 402, 423, 453, 471,
                       490, 499, 506, 515, 526, 538, 550, 563, 585, 609, 630, 646, 659, 668, 675, 695,
                       705, 712, 719, 726, 733, 740, 747, 754, 761, 768, 775],
         'fallback_frames': [],
         'ate_m': 0.168828,
         'frames': 780,
         'states': [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                    1, 1, 1],
         'lost_frames': []},
}


def _frames(r):
    """Row r's frames as `chip_smoke._track_frame` takes them."""
    for sensor, a, b in ev.row_frames(r, ahead=cs.RENDER_AHEAD):
        yield a if sensor == "mono" else (a, b)


class _GlobalBA:
    """Record the global BA's branch at each call (`run_global_ba`: "pcg"
    where it called `pcg_ba.solve_ba_pcg`, else "dense"), K9's launches
    inside it and the first inputs it hands K9."""

    def __init__(self):
        self.branches, self.k9, self._inside, self._pcg = [], None, False, False
        self.k9_launches = 0

    def __enter__(self):
        self.saved = (loop_closing.run_global_ba, pcg_ba.solve_ba_pcg, cb.ba_assemble)
        run, pcg, k9 = self.saved

        def run_global_ba(*args, **kw):
            self._inside, self._pcg = True, False
            before = launch.LAUNCHES["ba_edge"]
            try:
                return run(*args, **kw)
            finally:
                self._inside = False
                self.branches.append("pcg" if self._pcg else "dense")
                self.k9_launches += launch.LAUNCHES["ba_edge"] - before

        def solve_ba_pcg(*args, **kw):
            self._pcg = True
            return pcg(*args, **kw)

        def ba_assemble(*args):
            if self._inside and self.k9 is None:
                self.k9 = args
            return k9(*args)
        loop_closing.run_global_ba, pcg_ba.solve_ba_pcg, cb.ba_assemble = \
            run_global_ba, solve_ba_pcg, ba_assemble
        return self

    def __exit__(self, *exc):
        loop_closing.run_global_ba, pcg_ba.solve_ba_pcg, cb.ba_assemble = self.saved


def _k9_at_gba(name, k9, card):
    """K9 at the row's first global BA against its twin, bit for bit, and
    its device time beside its bound."""
    errs = {"ba_edge": 0.0}
    a9 = cs._named(cb.ba_assemble, k9)
    C9, E9 = a9["poses"].shape[0], a9["edge_mask"].numel()
    cs._lin_equal(f"[{name}] K9 at C={C9}, E={E9}", schur_ba.Lin(*cb.ba_assemble(*k9)),
                  schur_ba.Lin(*cb.ba_assemble_plain(*k9)), errs)
    bound, by = cs._bound(cs._ba_assemble_bytes(k9), 600 * E9)
    res = {"C": C9, "E": E9, "points": a9["points"].shape[0], "max_abs_err": errs["ba_edge"],
           "device_ms": cs._queued_ms(lambda: cb.ba_assemble(*k9)),
           "ms": cs._event_ms(lambda: cb.ba_assemble(*k9), 20),
           "plain_ms": cs._event_ms(lambda: cb.ba_assemble_plain(*k9), 5),
           "bound_ms": bound, "bound_by": by, "library_ms": None}
    cs.log(f"[{name}] {card}: K9 at the first global BA (C={C9}, E={E9}) equals its twin bit "
           f"for bit; device {res['device_ms'] * 1e3:.1f} us queued, {res['ms']:.3f} ms a call, "
           f"twin {res['plain_ms']:.3f} ms, bound {bound * 1e3:.2f} us ({by})")
    return res


def run_row(name, voc, dev, card, twin=()):
    """Row `name` through the port's SlamSystem on the card; returns its
    record with the checks' misses under "misses". The kernels named in
    `twin` run their plain twins on the card (`chip_smoke.twins`): another
    float order than the kernel path's."""
    r = ev.row(name)
    mono = r.sensor == "mono"
    times, states, closure_nb = [], [], []
    torch.cuda.synchronize()
    launch.reset_launches()
    t0 = time.perf_counter()
    keep = tuple(k for k in cs.WRAPPERS if k not in twin)
    with cs.twins(keep), _GlobalBA() as gba:
        s = cs._loop_lap(r.cfg, voc, _frames(r), dev, times, closure_nb=closure_nb,
                         states=states, enable_loops=r.enable_loops)
    lap_s = time.perf_counter() - t0
    launches = dict(launch.LAUNCHES)
    gt = [(i / r.cfg.fps, T) for i, T in enumerate(r.gt)]
    traj = s.get_trajectory()
    closures = [dict(kf_seq=c["kf_seq"], kf_frame=c["kf_frame"], cand_frame=c["cand_frame"],
                     cand_neighbour_frames=nb) for c, nb in zip(s.loop_closures, closure_nb)]
    plain_ms, kf_ms, closure_ms = cs._split_kf(times, s.metrics,
                                               [c["kf_frame"] for c in closures])
    lost = [i for i, st in enumerate(states) if st != system.OK]
    rec = {"name": name, "twins": list(twin), "frames": len(r.gt),
           "tracked": len(traj),
           "loops": s.n_loops_closed,
           "closures": closures, "keyframes_inserted": s._kf_seq_host,
           "keyframes": int(s.m.n_keyframes), "points": int(s.m.n_points),
           "ate_m": trajectory.ate_rmse(traj, gt, with_scale=mono), "lap_s": lap_s,
           "track_ms_median": plain_ms, "keyframe_track_ms_median": kf_ms,
           "closure_track_ms": closure_ms,
           "kf_frames": sorted(e["frame"] for e in s.metrics if e.get("kf")),
           "states": [int(st) for st in states[:cs.SEQ_FRAMES_CHECKED]], "lost_frames": lost,
           "retry_frames": [e["frame"] for e in s.metrics if e.get("retry")],
           "fallback_frames": [e["frame"] for e in s.metrics if e.get("fallback")],
           "relocalizations": sum(1 for a, b in zip(states, states[1:])
                                  if a == system.LOST and b == system.OK),
           "gba_branches": gba.branches, "launches": launches}
    ref = REFERENCE_ROWS.get(name)
    runs = [] if ref is None else ref if isinstance(ref, list) else [ref]
    rec["misses"] = ["no reference record"] if ref is None else cs.check_row(rec, ref, r.gt)
    bad = cs._map_finite(s.m)
    if bad:
        rec["misses"].append(f"non-finite {bad} in the map")
    if gba.k9 is not None:
        rec["k9_gba"] = dict(_k9_at_gba(name, gba.k9, card), launches=gba.k9_launches)
    cs.log(f"[{name}] {card}: {rec['tracked']} of {rec['frames']} frames tracked (reference "
           f"{[x['tracked'] for x in runs]}) in {lap_s:.1f} s; {rec['keyframes_inserted']} "
           f"keyframes inserted (reference {[x['keyframes_inserted'] for x in runs]}), "
           f"{rec['keyframes']} kept, {rec['points']} points; {rec['loops']} loops at "
           f"{[(c['kf_seq'], c['kf_frame'], c['cand_frame']) for c in closures]} (reference "
           f"{[[(c['kf_seq'], c['kf_frame'], c['cand_frame']) for c in x['closures']] for x in runs]}"
           f"); ATE {rec['ate_m'] * 100:.3f} cm (reference "
           f"{[round(x['ate_m'] * 100, 3) for x in runs]} cm); track median "
           f"{cs._fmt(plain_ms)} ms without a keyframe, {cs._fmt(kf_ms)} ms with one, closure "
           f"frames {[round(t, 1) for t in closure_ms]} ms; retry on "
           f"{len(rec['retry_frames'])} frames (first {rec['retry_frames'][:5]}), fallback on "
           f"{len(rec['fallback_frames'])} (first {rec['fallback_frames'][:5]}), "
           f"{rec['relocalizations']} relocalizations; global BA {gba.branches}; launches "
           f"{launches}; misses {rec['misses']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", nargs="+", default=list(ROWS), choices=ROWS)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "eval_rows.json"))
    ap.add_argument("--twins", nargs="+", default=[], choices=list(cs.WRAPPERS),
                    help="kernels whose plain twins run on the card instead")
    args = ap.parse_args(argv)
    card = cs.device_phase()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.build_phase()
    voc = synth_vocabulary(10, 6, device=dev)
    rows = [run_row(name, voc, dev, card, tuple(args.twins)) for name in args.rows]
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    line = json.dumps({"card": card, "rows": rows}, default=float)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    failed = {f"{r['name']} (twins {r['twins']})": r["misses"]
              for r in rows if r["misses"]}
    if failed:
        raise SystemExit(f"chip_eval_rows: rows outside their bands: {failed}")


if __name__ == "__main__":
    main()
