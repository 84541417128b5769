#!/usr/bin/env python3
"""The global BA's linear step on the fig8-rgbd map, dense Schur against
PCG, with the point-block pivot floor (`solvers/schur_ba.PIVOT_FLOOR`) on
and off.

    python3 scripts/gba_step_report.py                 # on the card: the lap, then the report
    python3 scripts/gba_step_report.py --save P.pt     # ... and keep the problem
    python3 scripts/gba_step_report.py --problem P.pt  # a kept problem, on the CPU

The lap is `chip_smoke.py`'s [loop] lap (SlamSystem over the 560 frames
of the figure eight, then flush()); the problem is `run_global_ba`'s on
the final map. Printed:
- the point blocks: points in the problem, those seen once without depth
  (rank-2 blocks), the largest condition number;
- for each damping lambda of LM's range: the least and largest eigenvalue
  of the reduced camera system as the float32 solvers form it (their
  factor's Hpp^-1, assembled in float64) and as exact 3x3 inverses give
  it, and each solver's camera step against the exact one (relative);
- run_global_ba's 10 LM iterations with either solver: each step's
  lambda, error and acceptance, and the poses' largest difference.
Imports nothing of JAX."""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as cs
from orb_slam2_tpu_torch.geometry import se3
from orb_slam2_tpu_torch.pipeline import loop_closing
from orb_slam2_tpu_torch.solvers import pcg_ba, schur_ba

LAMBDAS = (1e-4, 1e-7, 1e-9)
LM_ITERS = 10


def _setup(cfg, prob):
    C = prob.poses.shape[0]
    sigma2 = torch.tensor(cfg.level_sigma2, dtype=torch.float32, device=prob.points.device)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(prob.obs_level, 0, len(cfg.level_sigma2) - 1).long()]
    mask = (prob.obs_cam >= 0) & prob.pt_valid[:, None] & \
        prob.cam_valid[torch.clamp(prob.obs_cam, 0, C - 1).long()]
    return schur_ba._edges(prob, inv_sigma2), mask.to(torch.float32)


def point_blocks(cfg, cam, prob):
    """The point blocks at the problem's state."""
    edges, mask = _setup(cfg, prob)
    lin = schur_ba._assemble(cam, prob, edges, prob.poses, prob.points, mask, False)
    on = lin.pt_on
    ev = torch.linalg.eigvalsh(lin.Hpp[on].double())
    n_obs = (mask > 0)[on].sum(1)
    n_depth = ((prob.obs_uvr[..., 2] >= 0) & (mask > 0))[on].sum(1)
    return {"points": int(on.sum()), "edges": int(mask.sum()),
            "seen_once_without_depth": int(((n_obs == 1) & (n_depth == 0)).sum()),
            "max_condition": float((ev[:, -1] / ev[:, 0].abs().clamp(min=1e-300)).max())}


def solver_system_eig(cfg, cam, prob, lam):
    """The extreme eigenvalues of the reduced camera system the float32
    solvers see: S = Hcc_d - W (L L^T) W^T with L their factor of each
    damped point block, assembled in float64."""
    C = prob.poses.shape[0]
    edges, mask = _setup(cfg, prob)
    lin = schur_ba._assemble(cam, prob, edges, prob.poses, prob.points, mask, False)
    lam32 = torch.full((), lam, dtype=torch.float32, device=prob.points.device)
    Hinv = pcg_ba._precompute(lin, lam32)["Hpp_inv"].double()
    Q, O = lin.chi2.shape
    W = torch.einsum("qoc,qoij->ciqj", edges.onehot.double().reshape(Q, O, C), lin.We.double())
    WH = torch.einsum("ciqj,qjk->ciqk", W, Hinv).reshape(C * 6, Q * 3)
    S = torch.block_diag(*schur_ba._damped(lin.Hcc.double(), lam32.double())) - \
        WH @ W.reshape(C * 6, Q * 3).T
    f6 = (prob.cam_valid & ~prob.cam_fixed).repeat_interleave(6)
    eig = torch.linalg.eigvalsh(S[f6][:, f6])
    return float(eig[0]), float(eig[-1])


def lm_trace(cfg, cam, prob, solver):
    """run_global_ba's LM loop, step by step: (lambda, error, accepted)
    each, and the final poses."""
    edges, mask = _setup(cfg, prob)
    free = prob.cam_valid & ~prob.cam_fixed
    poses, points = prob.poses, prob.points
    lin = schur_ba._assemble(cam, prob, edges, poses, points, mask, False)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=poses.device)
    trace = []
    for _ in range(LM_ITERS):
        if solver == "dense":
            dc, dp = schur_ba._solve_step(prob, edges, lin, lam)
        else:
            dc, dp = pcg_ba._step(pcg_ba._precompute(lin, lam), edges, free, 50)
        pn, qn = se3.retract(poses, dc), points + dp
        ln = schur_ba._assemble(cam, prob, edges, pn, qn, mask, False)
        ok = bool(ln.err < lin.err)
        trace.append((float(lam), float(ln.err), ok))
        if ok:
            poses, points, lin = pn, qn, ln
            lam = torch.clamp(lam * 0.3, min=1e-9)
        else:
            lam = torch.clamp(lam * 5.0, max=1e4)
    return trace, poses


def report(cfg, cam, prob):
    out = {"blocks": point_blocks(cfg, cam, prob)}
    print(f"point blocks: {out['blocks']}", flush=True)
    free = prob.cam_valid & ~prob.cam_fixed
    floor = schur_ba.PIVOT_FLOOR
    for pivot_floor in (0.0, floor):
        schur_ba.PIVOT_FLOOR = pivot_floor
        try:
            tag = f"pivot floor {pivot_floor:g}"
            for lam in LAMBDAS:
                rel, steps, eig = cs._gba_step(cfg, cam, prob, lam)
                seen = solver_system_eig(cfg, cam, prob, lam)
                out[f"{tag}, lambda {lam:g}"] = {"exact_eig": eig, "solver_eig": seen, **rel}
                print(f"{tag}, lambda {lam:g}: eigenvalues exact {eig[0]:.4g} .. {eig[1]:.4g}, "
                      f"as the solvers form it {seen[0]:.4g} .. {seen[1]:.4g}; each step's "
                      f"distance from the exact one: " +
                      ", ".join(f"{k} {v:.3e}" for k, v in rel.items()), flush=True)
            poses = {}
            for solver in ("dense", "pcg"):
                trace, poses[solver] = lm_trace(cfg, cam, prob, solver)
                out[f"{tag}, {solver} LM"] = trace
                print(f"{tag}, {solver}, {LM_ITERS} LM iterations (lambda, error, accepted): " +
                      ", ".join(f"({lam:.2g}, {err:.3f}, {int(ok)})" for lam, err, ok in trace),
                      flush=True)
            diff = float((poses["pcg"] - poses["dense"])[free].abs().max())
            out[f"{tag}, pose diff"] = diff
            print(f"{tag}: PCG's poses against the dense solve's after {LM_ITERS} LM "
                  f"iterations, max |diff| {diff:.3e}", flush=True)
        finally:
            schur_ba.PIVOT_FLOOR = floor
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problem", help="a problem kept by --save (runs on its device, the CPU)")
    ap.add_argument("--save", help="keep the lap's global BA problem in this file")
    args = ap.parse_args()
    cfg = cs.bench_config()
    if args.problem:
        prob = schur_ba.BAProblem(**torch.load(args.problem))
        dev = prob.points.device
    else:
        cs.device_phase()
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        cs.build_phase()
        voc = cs.synth_vocabulary(10, 6, device=dev)
        _, frames = cs.render_loop_frames()
        s = cs._loop_lap(cfg, voc, frames, dev)
        print(f"the lap: {s.n_loops_closed} loops closed", flush=True)
        prob = loop_closing.global_ba_problem(cfg, s.m)
        if args.save:
            torch.save({k: v.cpu() for k, v in prob._asdict().items()}, args.save)
    print(json.dumps(report(cfg, cfg.camera(dev), prob)), flush=True)


if __name__ == "__main__":
    main()
