#!/usr/bin/env python3
"""Kernels of two checkouts of the port, timed on one card in one call.

    python3 scripts/kernel_ab.py OTHER_CHECKOUT [--out chiprun_out/kernel_ab.json]

(the recorded inputs and each run's outputs go to the git-ignored
`_scratch/kernel_ab/`)

Records, with this checkout's `chip_smoke.py`, the 31 frames of its
sequence, what the extractor hands K3 on frame 0 (each level's blurred
image, keypoints and angles) and the arguments the main path hands K5
(frame 1's local-map search, fusion's union at the second keyframe event),
K6 (frame 1's first pose solve), local BA (the keyframe event of frame 6),
`matching.search_by_projection_frame` (frame 1's motion-model search) and
`mapping_ops._epi_match_batch` (the last keyframe event's epipolar search),
and a synthetic `matching.search_by_node` set (2048 x 2048, every node 0 as
on the tracking fallback), then times them in OTHER_CHECKOUT, this
checkout, this checkout and OTHER_CHECKOUT again, each in a process of its
own that imports the package, and builds the kernels, of the checkout under
test. Device time is `chip_smoke._queued_ms` of that checkout (20 calls
queued behind a sleeping kernel, timed by CUDA events); "per call" is
`chip_smoke._event_ms` (CUDA events around back-to-back calls, the host's
issue included). Timed:
- the search units K4 and K8 serve, whatever kernels and torch glue each
  checkout runs for them, with the profiler's device activities per call:
  `search_by_projection_frame` and `search_by_node` (K4 and its gate) and
  `_epi_match_batch` (K8, its gate and its per-feature glue);
- K1 per call on frame 0 (one launch, or a launch per level in a checkout
  without `pack_pyramid_taps`), device time and per call;
- K3 per frame over frame 0's 8 levels: one `brief_levels` launch from the
  angles' cosine and sine (and with `angle_cos_sin` before it), or, in a
  checkout without it, `rotated_offsets` and a `brief` launch per level;
- K2 per frame over frame 0's 8 pyramid levels, as the checkout's extractor
  runs it (one launch, or a launch per level in a checkout without
  `dense_stage_levels`);
- `schur_ba._assemble` as a whole at the event's E = 4096 x 12 edges and
  C = 64 cameras, with the profiler's device activities per call (a fresh
  process records every one);
- K6 at the schedules (rounds x iterations) 1x0, 2x0, 1x10 and 4x10: the
  slope from 1x0 to 1x10 is one LM iteration (a sweep with its reduction,
  then the 6x6 solve, the retract and the accept test), 2x0 - 1x0 one sweep
  (and a reclassification), and their difference the solve; K7; K5.
Each run also saves its outputs: K1's levels, K3's words and K5's results on
the recorded inputs, the three search units' results, and each frame's Tcw and the final map of the 31-frame
sequence (`chip_smoke.run_sequence` on the kernel path); the summary says
whether the two checkouts' outputs are equal bit for bit.
Prints one JSON line per run and a summary; needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ((1, 0), (2, 0), (1, 10), (4, 10))


def _portable(x):
    """Tensors to the CPU and named tuples (Camera, BAProblem) to dicts, for
    torch.save."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if hasattr(x, "_asdict"):
        return {"__tuple__": type(x).__name__,
                "fields": {k: _portable(v) for k, v in x._asdict().items()}}
    if isinstance(x, (tuple, list)):
        return tuple(_portable(v) for v in x)
    if isinstance(x, dict):
        return {k: _portable(v) for k, v in x.items()}
    return x


def _on_card(x, dev):
    import torch
    from orb_slam2_tpu_torch.geometry.camera import Camera
    from orb_slam2_tpu_torch.mapstate.map import MapState
    from orb_slam2_tpu_torch.solvers.schur_ba import BAProblem
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict) and "__tuple__" in x:
        kind = {"Camera": Camera, "BAProblem": BAProblem, "MapState": MapState}[x["__tuple__"]]
        return kind(**{k: _on_card(v, dev) for k, v in x["fields"].items()})
    if isinstance(x, tuple):
        return tuple(_on_card(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _on_card(v, dev) for k, v in x.items()}
    return x


def record(path):
    import numpy as np
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    cfg = cs.bench_config()
    _, frames = cs.render_frames()
    uploads = [(torch.from_numpy(g).to(dev), torch.from_numpy(d).to(dev))
               for g, d in frames[:cs.N_RECORD]]
    recorded = {}
    from orb_slam2_tpu_torch.ops import matching
    from orb_slam2_tpu_torch.pipeline import mapping_ops
    from orb_slam2_tpu_torch.solvers import schur_ba
    solve_ba, ba = schur_ba.solve_ba, []
    search, searches = matching.search_by_projection_frame, []
    epi, epis = mapping_ops._epi_match_batch, []

    def record_ba(cam, prob, level_sigma2, *args, **kw):
        ba.append((cam, prob, tuple(level_sigma2)))
        return solve_ba(cam, prob, level_sigma2, *args, **kw)

    def record_search(*args, **kw):
        searches.append((args, kw))
        return search(*args, **kw)

    def record_epi(cfg, m, kf1, neighbor_ids):
        epis.append((m, kf1, neighbor_ids))
        return epi(cfg, m, kf1, neighbor_ids)

    schur_ba.solve_ba, matching.search_by_projection_frame = record_ba, record_search
    mapping_ops._epi_match_batch = record_epi
    try:
        with cs.twins(), cs.recording(recorded):
            cs.run_sequence(cfg, uploads)
    finally:
        schur_ba.solve_ba, matching.search_by_projection_frame = solve_ba, search
        mapping_ops._epi_match_batch = epi
    torch.cuda.synchronize()
    node = cs._synthetic_node(np.random.default_rng(3), 2048, 2048, 1, dev)
    angles = torch.from_numpy(np.random.default_rng(4).uniform(0, 360, (2, 2048))
                              .astype(np.float32)).to(dev)
    from orb_slam2_tpu_torch.ops import orient_brief
    img = torch.from_numpy(frames[0][0]).to(dev).to(torch.float32)
    levels = cs.kernel_inputs(cfg, img, dev)[2]
    torch.save(_portable({"k5": recorded["proj_match"][0], "k6": recorded["pose_lm"][0][:7],
                          "fusion": recorded["proj_match@event"][-1], "ba": ba[-1],
                          "frames": [(torch.from_numpy(g), torch.from_numpy(d)) for g, d in frames],
                          "brief": [lv[1:] for lv in levels],
                          "points": torch.as_tensor(orient_brief.brief_points()),
                          "motion_search": searches[0], "epi": epis[-1],
                          "node_search": node[:3] + (angles[0],) + node[3:] + (angles[1],)}),
               path)


def time_kernels(path, label, out_path):
    import torch
    import chip_smoke as cs
    from orb_slam2_tpu_torch.ops import _build
    from orb_slam2_tpu_torch.ops import cuda_match as cm
    from orb_slam2_tpu_torch.ops import cuda_pose as cp
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()
    rec = _on_card(torch.load(path), dev)
    k5, k6, fusion = rec["k5"], rec["k6"], rec["fusion"]
    k7 = k6[:6] + (k6[6].to(torch.float32), True)
    res = {"label": label, "package": os.path.dirname(cs.cp.__file__),
           "card": torch.cuda.get_device_name(0)}
    for r, i in SCHEDULES:
        res[f"pose_lm_{r}x{i}_ms"] = cs._queued_ms(lambda r=r, i=i: cp.pose_lm(*k6, r, i))
    res["pose_normal_eqs_ms"] = cs._queued_ms(lambda: cp.pose_normal_eqs(*k7))
    res["proj_match_frame1_ms"] = cs._queued_ms(lambda: cm.projection_best_two(*k5))
    res["proj_match_fusion_union_ms"] = cs._queued_ms(lambda: cm.projection_best_two(*fusion))
    outputs = {"k5": cm.projection_best_two(*k5)}
    frame0 = rec["frames"][0][0].to(torch.float32)
    res.update(_pyramid_call(frame0, cs, dev, outputs))
    res.update(_brief_frame(rec["brief"], rec["points"], cs, outputs))
    res.update(_dense_frame(frame0, cs, dev))
    res.update(_assemble(*rec["ba"], cs))
    res.update(_search_units(rec, cs, outputs))
    results, _, _, _, events = cs.run_sequence(cs.bench_config(), rec["frames"])
    outputs["sequence_tcw"] = torch.stack([r.Tcw for r in results])
    outputs["sequence_map"] = events[-1]["m"]._asdict()
    torch.save(_portable(outputs), out_path)
    res["shapes"] = {"pose_lm_edges": k6[2].shape[0], "proj_match_frame1": [
        k5[0].shape[0], k5[6].shape[0]], "proj_match_fusion_union": [fusion[0].shape[0],
                                                                     fusion[6].shape[0]]}
    print(json.dumps(res), flush=True)


def _pyramid_call(img, cs, dev, outputs):
    """K1 on frame 0 as the checkout's extractor hands it its taps: device
    time and per call, and launches per call."""
    from orb_slam2_tpu_torch.ops import cuda_extract as ce
    from orb_slam2_tpu_torch.ops import extractor as ex
    from orb_slam2_tpu_torch.ops import launch
    taps = ex.extractor_for(cs.bench_config(), cs.H, cs.W, dev).pyramid_taps()
    fn = lambda: ce.pyramid(img, taps)
    launch.reset_launches()
    outputs["pyramid"] = fn()[1:]
    return {"pyramid_launches_per_call": launch.LAUNCHES["pyramid"],
            "pyramid_ms": cs._queued_ms(fn), "pyramid_call_ms": cs._event_ms(fn)}


def _brief_frame(levels, points, cs, outputs):
    """K3 over frame 0's levels as the checkout runs it: one `brief_levels`
    launch from the cosine and sine (and with `angle_cos_sin` before it),
    or `rotated_offsets` and a `brief` launch per level; device time and
    per call."""
    import torch
    from orb_slam2_tpu_torch.ops import cuda_extract as ce
    from orb_slam2_tpu_torch.ops import orient_brief as ob
    points = points.to(levels[0][0].device)
    if hasattr(ce, "brief_levels"):
        blurs = [lv[0] for lv in levels]
        ys, xs, ang = (torch.cat([lv[k] for lv in levels]) for k in (1, 2, 3))
        counts = [lv[1].shape[0] for lv in levels]
        ca, sa = ob.angle_cos_sin(ang)
        fn = lambda: ce.brief_levels(blurs, ys, xs, ca, sa, points, counts)
        with_cs = lambda: ce.brief_levels(blurs, ys, xs, *ob.angle_cos_sin(ang), points, counts)
    else:
        fn = lambda: torch.cat([ce.brief(blur, ys, xs, *ob.rotated_offsets(ang, points))
                                for blur, ys, xs, ang in levels])
        with_cs = fn
    outputs["brief"] = fn()
    # 4 calls queued: the per-level form issues ~110 kernels a call, and the
    # device's launch queue must not fill behind the sleeping kernel
    return {"brief_frame_ms": cs._queued_ms(fn, 4), "brief_frame_call_ms": cs._event_ms(fn),
            "brief_frame_with_cos_sin_ms": cs._queued_ms(with_cs, 4),
            "brief_frame_profiler": cs._device_ms(fn, 10)}


def _dense_frame(gray, cs, dev):
    """K2 per frame on frame 0's pyramid, as the extractor of the checkout
    runs it."""
    import torch
    from orb_slam2_tpu_torch.ops import cuda_extract as ce
    from orb_slam2_tpu_torch.ops import extractor as ex
    cfg = cs.bench_config()
    ext = ex.extractor_for(cfg, cs.H, cs.W, dev)
    pyr = ce.pyramid(gray.to(torch.float32), ext.pyramid_taps())
    regions = [cs._region(*lv.shape) for lv in pyr]
    th = (cfg.ini_th_fast, cfg.min_th_fast)
    if hasattr(ce, "dense_stage_levels"):
        fn = lambda: ce.dense_stage_levels(pyr, *th, regions, ext.gauss)
    else:
        fn = lambda: [ce.dense_stage(lv, *th, *r, taps=ext.gauss) for lv, r in zip(pyr, regions)]
    return {"dense_stage_frame_ms": cs._queued_ms(fn)}


def _assemble(cam, prob, level_sigma2, cs):
    """`schur_ba._assemble` at the recorded event's first linearization, as
    `solve_ba` sets it up: queued device time and the profiler's device
    time and activities per call."""
    import torch
    from orb_slam2_tpu_torch.solvers import schur_ba
    from orb_slam2_tpu_torch.utils.config import device_table
    C = prob.poses.shape[0]
    sigma2 = device_table(tuple(level_sigma2), prob.points.device)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(prob.obs_level, 0, sigma2.shape[0] - 1).long()]
    mask = ((prob.obs_cam >= 0) & prob.pt_valid[:, None]
            & prob.cam_valid[torch.clamp(prob.obs_cam, 0, C - 1).long()]).to(torch.float32)
    edges = schur_ba._edges(prob, inv_sigma2)
    fn = lambda: schur_ba._assemble(cam, prob, edges, prob.poses, prob.points, mask, True)
    prof_ms, n_act = cs._device_ms(fn, 10)
    return {"assemble_ms": cs._queued_ms(fn), "assemble_profiler_ms": prof_ms,
            "assemble_device_activities": n_act,
            "assemble_shape": [*prob.obs_cam.shape, C]}


def _search_units(rec, cs, outputs):
    """The units K4 and K8 serve, as the checkout runs them: frame 1's
    motion-model search, the synthetic BoW-node search and the last event's
    epipolar search; queued device time, per call, and the profiler's device
    time and activities per call (this process is fresh)."""
    from orb_slam2_tpu_torch.ops import matching
    from orb_slam2_tpu_torch.pipeline import mapping_ops
    (args, kw), (m, kf1, nb), node = rec["motion_search"], rec["epi"], rec["node_search"]
    cfg = cs.bench_config()
    units = {"motion_search": lambda: matching.search_by_projection_frame(*args, **kw),
             "node_search": lambda: matching.search_by_node(*node, nn_ratio=0.7),
             "epi_match_batch": lambda: mapping_ops._epi_match_batch(cfg, m, kf1, nb)}
    res = {}
    for name, fn in units.items():
        outputs[name] = fn()
        syncs, issue_ms, top = _host_side(fn)
        # 4 calls queued: a unit issues up to ~80 kernels a call, and the
        # device's launch queue must not fill behind the sleeping kernel
        queued = None if syncs else cs._queued_ms(fn, 4)
        prof_ms, n_act = cs._device_ms(fn, 10)
        res.update({f"{name}_ms": queued, f"{name}_call_ms": cs._event_ms(fn),
                    f"{name}_profiler_ms": prof_ms, f"{name}_device_activities": n_act,
                    f"{name}_host_syncs": syncs, f"{name}_issue_ms": issue_ms,
                    f"{name}_host_top": top})
    return res


def _host_side(fn):
    """What one call of fn costs the host: the source lines at which it waits
    for the card (torch's sync debug mode), the host time to issue it
    (mean of 5 calls, no wait), and the 5 functions of the longest own time
    in one call (cProfile)."""
    import cProfile
    import pstats
    import time
    import warnings
    import torch
    for _ in range(2):                     # the second call: the first may set up torch.cuda
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    syncs = sorted({f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    issue_ms = (time.perf_counter() - t0) * 200
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.runcall(fn)
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).sort_stats("tottime")
    top = [f"{os.path.basename(f)}:{ln} {fn_name} {st[2] * 1e3:.2f} ms"
           for (f, ln, fn_name), st in list(stats.stats.items())]
    top = sorted(top, key=lambda t: -float(t.split()[-2]))[:5]
    return syncs, issue_ms, top


def _same_outputs(a, b):
    """Per output, whether two runs' saved outputs are equal bit for bit."""
    import torch

    def equal(x, y):
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and torch.equal(x, y)
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(equal(x[k], y[k]) for k in x)
        if isinstance(x, (tuple, list)):
            return len(x) == len(y) and all(equal(u, v) for u, v in zip(x, y))
        return x == y
    return {k: equal(a[k], b[k]) for k in a}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="another checkout of the repo (e.g. the parent commit)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "kernel_ab.json"))
    ap.add_argument("--mode", choices=("run", "record", "time"), default="run")
    ap.add_argument("--inputs", default=os.path.join(ROOT, "_scratch", "kernel_ab", "inputs.pt"))
    ap.add_argument("--label", default="")
    ap.add_argument("--outputs", default="")
    a = ap.parse_args()
    if a.mode == "record":
        return record(a.inputs)
    if a.mode == "time":
        return time_kernels(a.inputs, a.label, a.outputs)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    os.makedirs(os.path.dirname(a.inputs), exist_ok=True)
    other = os.path.abspath(a.other)
    if not os.path.exists(os.path.join(other, "orb_slam2_tpu_torch", "csrc")):
        raise SystemExit(f"kernel_ab: no checkout of the port at {other}")

    def child(mode, tree, label="", outputs=""):
        env = dict(os.environ, PYTHONPATH=tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), other, "--mode", mode,
                              "--inputs", a.inputs, "--label", label, "--outputs", outputs],
                             env=env, cwd=tree, capture_output=True, text=True, check=False,
                             timeout=900)
        if out.returncode:
            raise SystemExit(f"kernel_ab {mode} in {tree} failed:\n{out.stdout}\n{out.stderr}")
        return out.stdout

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[kernel_ab] {card}", flush=True)
    child("record", ROOT)
    runs, saved = [], []
    for i, (label, tree) in enumerate((("other", other), ("this", ROOT), ("this", ROOT),
                                       ("other", other))):
        saved.append(os.path.join(os.path.dirname(a.inputs), f"outputs_{i}.pt"))
        line = child("time", tree, label, saved[-1]).strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    # each kernel's lesser time of its two runs per checkout
    summary = {"card": card, "runs": runs, "best_of_two": {
        lab: {k: min(r[k] for r in runs if r["label"] == lab)
              for k, v in next(r for r in runs if r["label"] == lab).items()
              if k.endswith("_ms") and v is not None}
        for lab in ("other", "this")}}
    for lab, t in summary["best_of_two"].items():
        it = (t["pose_lm_1x10_ms"] - t["pose_lm_1x0_ms"]) / 10
        t["pose_lm_per_iteration_ms"] = it
        t["pose_lm_per_sweep_ms"] = t["pose_lm_2x0_ms"] - t["pose_lm_1x0_ms"]
        t["pose_lm_solve_ms"] = it - t["pose_lm_per_sweep_ms"]
    summary["same_outputs"] = _same_outputs(*(torch.load(p) for p in saved[:2]))
    print(f"[kernel_ab] outputs of the two checkouts equal bit for bit: "
          f"{summary['same_outputs']}", flush=True)
    with open(a.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary["best_of_two"]), flush=True)


if __name__ == "__main__":
    main()
