#!/usr/bin/env python3
"""What a map the port itself builds hands its first global BA: the
numbers the global-BA traffic (`slambench/traffic/global-ba.json`) is
taken from.

    python3 slambench/tools/mapstats.py [--rows block-stereo ...] \\
        [--out chiprun_out/mapstats.json]
    python3 slambench/tools/mapstats.py --from chiprun_out/mapstats.json:block-stereo \\
        --traffic slambench/traffic/global-ba.json

Each row (the port's evaluation rows,
`orb_slam2_tpu_torch.examples.eval_synthetic_hard`) runs through the port's
`SlamSystem` on the card until its first loop closure hands the map to
`loop_closing.run_global_ba`. There the row stops, and `map_stats` reads
that map as the global BA's problem (`global_ba_problem`) sees it, and the
map that the configuration's whole global BA (`gba_async_chunks` chained
calls, run here on the same map) returns; where that global BA takes the
dense branch, also the same with the PCG branch (`pcg`); and the map that
the plain reference's global BA (`harness/reference.py`, float64, the
dense solve) returns from the same problem run to convergence (one chunk
of CONVERGE_ITERS LM iterations, `reference`), with the total chi2 before
and after each, and the LM steps the reference keeps on the
configuration's own schedule (`schedule_kept`). Prints one JSON
line a row and writes them all to --out. Needs CUDA; imports nothing of
JAX. With --from, writes the traffic's measured groups from a row of such
a file instead (`traffic_groups`), keeping the traffic's other keys.
"""
import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

GROSS_SIGMAS = 5.0        # an edge is a gross outlier beyond this many sigmas
MIN_BIN_EDGES = 100       # the stereo table pools depth bins to this many edges
CONVERGE_ITERS = 50       # LM iterations of the reference's converged global BA
# depth bins of the stereo share, in units of th_depth x baseline
DEPTH_BINS = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 5.0, math.inf)
QUANTILES = tuple(i / 10 for i in range(11))
MEDIAN_CHI2 = {2: 1.3862944, 3: 2.3659739}   # median of chi2 with 2 and 3 degrees of freedom


class _Done(Exception):
    pass


def _rotvec(R):
    """(n,3,3) rotation -> (n,3) axis-angle, float64."""
    s = torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], -1) / 2.0
    c = (R.diagonal(dim1=1, dim2=2).sum(-1) - 1.0) / 2.0
    sn = s.norm(dim=-1, keepdim=True)
    th = torch.atan2(sn[:, 0], c)[:, None]
    return torch.where(sn > 1e-15, s / sn.clamp(min=1e-300) * th, s)


def _smooth_and_jitter(d):
    """A drift (n,3) along the keyframes in frame order, split as mapgen draws
    it: a bump A sin(pi s) along one direction plus a jitter of std j on each
    axis. j from the second differences (var 6 j^2 an axis; the bump's are
    negligible), A from what is left: mean |d|^2 = A^2 / 2 + 3 j^2."""
    d2 = d[2:] - 2 * d[1:-1] + d[:-2]
    j = math.sqrt(float((d2 * d2).sum(-1).mean()) / 18.0)
    rest = float((d * d).sum(-1).mean()) - 3 * j * j
    return math.sqrt(2.0 * max(rest, 0.0)), j


def _quantiles(x):
    if x.numel() == 0:
        return []
    return [float(v) for v in torch.quantile(x.double(), torch.tensor(QUANTILES,
                                                                      dtype=torch.float64,
                                                                      device=x.device))]


def map_stats(cfg, m, m1):
    """The statistics of map `m` as the global BA's problem sees it, and of
    `m1`, what the global BA made of it (both `MapState`s, the same slots)."""
    from orb_slam2_tpu_torch.pipeline import loop_closing
    prob = loop_closing.global_ba_problem(cfg, m)
    K, O = m.capacity_kf, prob.obs_cam.shape[1]
    oc = prob.obs_cam.long()
    on = (oc >= 0) & prob.pt_valid[:, None] & prob.cam_valid[oc.clamp(0, K - 1)]
    n = on.sum(1)
    hist = torch.bincount(n[prob.pt_valid], minlength=O + 1)
    q, o = on.nonzero(as_tuple=True)
    c = oc[q, o]
    obs = prob.obs_uvr[q, o].double()
    lev = prob.obs_level[q, o].long()
    stereo = obs[:, 2] >= 0
    f64 = torch.float64

    def project(poses, X):
        R, t = poses[c, :3, :3].to(f64), poses[c, :3, 3].to(f64)
        pc = (R @ X[q].to(f64)[..., None])[..., 0] + t
        z = pc[:, 2]
        u = cfg.fx * pc[:, 0] / z + cfg.cx
        return z, torch.stack([u, cfg.fy * pc[:, 1] / z + cfg.cy, u - cfg.bf / z], 1)

    z1, p1 = project(m1.kf_pose, m1.pt_pos)
    sig2 = torch.tensor(cfg.level_sigma2, dtype=f64, device=obs.device)[lev]
    r = obs - p1
    r[:, 2] = torch.where(stereo, r[:, 2], torch.zeros_like(r[:, 2]))
    chi2 = (r * r).sum(1) / sig2
    e_uv = torch.sqrt((r[:, :2] ** 2).sum(1) / sig2)          # in sigmas
    gross = chi2 > GROSS_SIGMAS ** 2
    thr = torch.where(stereo, 7.815, 5.991)

    D = cfg.th_depth * cfg.baseline
    single = n[q] == 1
    bins, lo = [], 0.0
    for hi in DEPTH_BINS:
        sel = (z1 >= lo * D) & (z1 < hi * D)
        bins.append({"depth_in_th_depth": [lo, hi], "edges": int(sel.sum()),
                     "stereo_share": float(stereo[sel].double().mean()) if sel.any() else None})
        lo = hi

    # the drift the global BA removes: keyframes in frame order
    kv = (m.kf_valid & m1.kf_valid).nonzero()[:, 0]
    kv = kv[torch.argsort(m.kf_frame_id[kv])]
    T0, T1 = m.kf_pose[kv].to(f64), m1.kf_pose[kv].to(f64)
    R0w, R1w = T0[:, :3, :3].transpose(1, 2), T1[:, :3, :3].transpose(1, 2)
    c0 = -(R0w @ T0[:, :3, 3, None])[..., 0]
    c1 = -(R1w @ T1[:, :3, 3, None])[..., 0]
    length = float((c1[1:] - c1[:-1]).norm(dim=1).sum())
    dc = c1 - c0
    dw = _rotvec(R1w @ R0w.transpose(1, 2))
    a_t, j_t = _smooth_and_jitter(dc)
    a_r, j_r = _smooth_and_jitter(dw)
    # the points in their reference keyframes
    pv = (m.pt_valid & (m.pt_ref_kf >= 0)).nonzero()[:, 0]
    ref = m.pt_ref_kf[pv].long()
    Ta, Tb = m.kf_pose[ref].to(f64), m1.kf_pose[ref].to(f64)
    pa = (Ta[:, :3, :3] @ m.pt_pos[pv].to(f64)[..., None])[..., 0] + Ta[:, :3, 3]
    pb = (Tb[:, :3, :3] @ m1.pt_pos[pv].to(f64)[..., None])[..., 0] + Tb[:, :3, 3]
    front = pa[:, 2] > 1e-3
    rel = ((pb - pa) / pa[:, 2:3])[front]
    point_frac = float(1.4826 * rel.abs().median())

    def med_sigma(sel, dof):
        return math.sqrt(float(chi2[sel].median()) / MEDIAN_CHI2[dof]) if sel.any() else None

    return {
        "keyframes": int(m.kf_valid.sum()), "points": int(m.pt_valid.sum()),
        "capacity": [K, int(m.pt_valid.shape[0])], "edges": int(q.numel()),
        "observers_per_point": {str(k): int(v) for k, v in enumerate(hist.tolist()) if v},
        "mean_observers": float(n[prob.pt_valid].double().mean()),
        "stereo_share": float(stereo.double().mean()), "stereo_by_depth": bins,
        "single_observer_stereo_share": float(stereo[single].double().mean())
        if single.any() else None,
        "single_observer_depth_quantiles_in_th_depth": _quantiles(z1[single] / D),
        "levels": torch.bincount(lev, minlength=cfg.n_levels).tolist(),
        "pixel_sigma_mono": med_sigma(~stereo, 2), "pixel_sigma_stereo": med_sigma(stereo, 3),
        "over_chi2_95_share": float((chi2 > thr).double().mean()),
        "gross_share": float(gross.double().mean()),
        "gross_sigmas_quantiles": _quantiles(e_uv[gross]),
        "drift": {"trajectory_m": length, "translation_frac": a_t / max(length, 1e-12),
                  "jitter_m": j_t, "rotation_rad": a_r, "jitter_rad": j_r,
                  "point_frac": point_frac,
                  "max_centre_move_m": float(dc.norm(dim=1).max()),
                  "max_rotation_rad": float(dw.norm(dim=1).max())},
    }


def reference_gba(cfg, m, chunks=None, iters=None):
    """The plain reference's global BA (float64, the dense solve; the
    configuration's schedule, or `chunks` of `iters` LM iterations) of the
    problem `global_ba_problem` builds from map m: (the map with its
    answer, {total chi2 before, after, LM steps kept of those tried})."""
    import dataclasses
    import types

    from orb_slam2_tpu_torch.pipeline import loop_closing
    from slambench.harness import reference
    prob = loop_closing.global_ba_problem(cfg, m)
    arr = types.SimpleNamespace(
        kf_valid=prob.cam_valid, frame_id=m.kf_frame_id, pt_valid=prob.pt_valid,
        obs_kf=prob.obs_cam.long(), obs_uv=prob.obs_uvr[..., :2], obs_ur=prob.obs_uvr[..., 2],
        obs_level=prob.obs_level.long(), Tcw=prob.poses, points=prob.points)
    data = {"slam": {"fx": cfg.fx, "fy": cfg.fy, "cx": cfg.cx, "cy": cfg.cy, "bf": cfg.bf,
                     "scale_factor": cfg.scale_factor, "gba_async_chunks": cfg.gba_async_chunks,
                     "gba_total_iters": cfg.gba_total_iters},
            "global_ba": {"solver": "dense"}}
    ar = reference.Arith("float64")
    pb = reference.problem(arr, data, ar)
    if chunks:
        pb = dataclasses.replace(pb, chunks=chunks, iters=iters)
    log = []
    R, t, X = reference.global_ba(pb, ar, log)
    pose = m.kf_pose.clone()
    free = pb.cam_free
    pose[free, :3, :3] = R[free].to(pose.dtype)
    pose[free, :3, 3] = t[free].to(pose.dtype)
    pts = torch.where(prob.pt_valid[:, None], X.to(m.pt_pos.dtype), m.pt_pos)
    before = reference.evaluate(pb, pb.R, pb.t, pb.X)["total"]
    return m._replace(kf_pose=pose, pt_pos=pts), {
        "chi2_before": before, "chi2_after": reference.evaluate(pb, R, t, X)["total"],
        "kept": [sum(1 for e in log if e[2]), len(log)], "problem": pb}


def chi2_of(pb, m):
    """The total chi2 of map m's keyframes and points on problem pb."""
    from slambench.harness import reference
    return reference.evaluate(pb, m.kf_pose[:, :3, :3], m.kf_pose[:, :3, 3], m.pt_pos)["total"]


def moved(rec: dict) -> dict:
    """A row's statistics after the first global BA that moved its map:
    the reference's, the PCG branch's, the configuration's own; the own
    where none did."""
    for st in (rec.get("reference"), rec.get("pcg"), rec):
        if st is not None and st["drift"]["max_centre_move_m"] > 0:
            return st
    return rec


def traffic_groups(rec: dict) -> dict:
    """The traffic's measured groups from one row's statistics (`main`'s
    record): the map's own, and the residuals and drift of a global BA that
    moved it (`moved`)."""
    st = moved(rec)
    hist = {k: v for k, v in rec["observers_per_point"].items() if k != "0"}
    # stereo: depth bins pooled until each holds MIN_BIN_EDGES edges; what
    # is left past the last full pool is the open bin, at its own share
    table, pool = [], [0, 0.0]
    for b in rec["stereo_by_depth"]:
        n = b["edges"]
        pool = [pool[0] + n, pool[1] + (n * b["stereo_share"] if n else 0.0)]
        if pool[0] >= MIN_BIN_EDGES:
            table.append([b["depth_in_th_depth"][1], pool[1] / pool[0]])
            pool = [0, 0.0]
    table.append([None, pool[1] / pool[0] if pool[0] else 0.0])
    if len(table) > 1 and table[-2][0] == math.inf:
        table = table[:-1]
        table[-1][0] = None
    # noise: the medians of the residuals after the global BA, on all the
    # degrees of freedom left once the points and free keyframes are fitted
    n_s = round(st["edges"] * st["stereo_share"])
    n_m = st["edges"] - n_s
    n_res = 2 * n_m + 3 * n_s
    fitted = 3 * (st["points"] - rec["observers_per_point"].get("0", 0)) \
        + 6 * (st["keyframes"] - 1)
    sig2 = ((st["pixel_sigma_mono"] or 0) ** 2 * 2 * n_m
            + (st["pixel_sigma_stereo"] or 0) ** 2 * 3 * n_s) / max(n_res - fitted, 1)
    dr = st["drift"]
    spacing = dr["trajectory_m"] / max(st["keyframes"] - 1, 1)
    return {
        "observers_per_point": hist,
        "stereo_by_depth": table,
        "pixel_sigma": math.sqrt(sig2),
        "outlier_share": st["gross_share"],
        "outlier_sigmas": st["gross_sigmas_quantiles"],
        "drift": {"translation_frac": dr["translation_frac"],
                  "jitter_frac": dr["jitter_m"] / spacing,
                  "rotation_rad": dr["rotation_rad"], "jitter_rad": dr["jitter_rad"],
                  "point_frac": dr["point_frac"]},
    }


def first_gba(r, voc, dev):
    """Row r through the port's SlamSystem until its first global BA call:
    (the map handed to it, the configuration's whole global BA of that map,
    the same by the PCG branch where the configuration's is dense (else
    None), the frame it came at)."""
    from orb_slam2_tpu_torch.examples import eval_synthetic_hard as ev
    from orb_slam2_tpu_torch.pipeline import loop_closing, system
    cfg = r.cfg
    real = loop_closing.run_global_ba
    got = {}

    def whole(cfg_, m):
        for _ in range(cfg_.gba_async_chunks):
            m = real(cfg_, m, n_iters=max(1, -(-cfg_.gba_total_iters // cfg_.gba_async_chunks)))
        return m

    def hook(cfg_, m, mesh=None, n_iters=10):
        got.update(m=m, m1=whole(cfg_, m), pcg=None)
        if m.pt_pos.shape[0] * m.capacity_kf * 18 * 4 <= loop_closing.DENSE_GBA_BYTES:
            saved = loop_closing.DENSE_GBA_BYTES
            loop_closing.DENSE_GBA_BYTES = 0
            try:
                got["pcg"] = whole(cfg_, m)
            finally:
                loop_closing.DENSE_GBA_BYTES = saved
        raise _Done
    s = system.SlamSystem(cfg, vocabulary=voc, device=dev, enable_loop_closing=True)
    loop_closing.run_global_ba = hook
    frame = -1
    try:
        for i, (sensor, a, b) in enumerate(ev.row_frames(r)):
            frame = i
            if sensor == "stereo":
                s.track_stereo(a, b, i / cfg.fps)
            elif sensor == "mono":
                s.track_monocular(a, i / cfg.fps)
            else:
                s.track_rgbd(a, b, i / cfg.fps)
        s.flush()
    except _Done:
        pass
    finally:
        loop_closing.run_global_ba = real
    return got.get("m"), got.get("m1"), got.get("pcg"), frame


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", nargs="+", default=["block-stereo"])
    ap.add_argument("--out", default="")
    ap.add_argument("--from", dest="src", default="",
                    help="FILE:ROW, a file this tool wrote and a row of it: write its groups to "
                         "--traffic")
    ap.add_argument("--traffic", default="")
    args = ap.parse_args(argv)
    if args.src:
        def row(spec):
            path, name = spec.rsplit(":", 1)
            with open(path) as f:
                src = json.load(f)
            rec = next(r for r in src["rows"] if r["row"] == name)
            return rec, dict({k: rec[k] for k in ("row", "frame", "keyframes", "points",
                                                   "edges")}, device=src["device"],
                             file=os.path.basename(path))
        rec, where = row(args.src)
        with open(args.traffic) as f:
            traffic = json.load(f)
        traffic.update(traffic_groups(rec))
        traffic["measured_on"] = where
        with open(args.traffic, "w") as f:
            json.dump(traffic, f, indent=1)
            f.write("\n")
        return 0
    from orb_slam2_tpu_torch.bow.vocabulary import synth_vocabulary
    from orb_slam2_tpu_torch.examples import eval_synthetic_hard as ev
    dev = torch.device("cuda", 0)
    voc = synth_vocabulary(10, 6, device=dev)
    rows = []
    for name in args.rows:
        t0 = time.perf_counter()
        r = ev.row(name)
        m, m1, pcg, frame = first_gba(r, voc, dev)
        rec = {"row": name, "frame": frame, "seconds": None}
        if m is None:
            rec["error"] = "no global BA in the row"
        else:
            rec.update(map_stats(r.cfg, m, m1))
            if pcg is not None:
                rec["pcg"] = map_stats(r.cfg, m, pcg)
            _, sched = reference_gba(r.cfg, m)
            m_ref, chi2 = reference_gba(r.cfg, m, 1, CONVERGE_ITERS)
            rec["reference"] = map_stats(r.cfg, m, m_ref)
            pb = chi2.pop("problem")
            chi2["schedule_kept"] = sched["kept"]
            chi2["chi2_after_schedule"] = sched["chi2_after"]
            chi2["chi2_after_port"] = chi2_of(pb, m1)
            if pcg is not None:
                chi2["chi2_after_port_pcg"] = chi2_of(pb, pcg)
            rec["chi2"] = chi2
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    bad = sorted({k.split(".")[0] for k in sys.modules} & {"jax", "jaxlib", "orb_slam2_tpu"})
    if bad:
        raise SystemExit(f"mapstats: loaded {bad}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(dev), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
