#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card at
the cell's own size, in one process:

    python3 slambench/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--lm-seeds 1] [--kernels] \\
        [--out chiprun_out/readings.json]

For each seed: the map, one global BA of the program (the window's own
call), and its numbers against the float64 reference (`answer`). For each
control seed also the control's numbers (the reference in TF32 put in the
program's place, `control`) and the reference in plain float32 beside it
(`float32`). For each fault seed, the faults a run could show, planted in
the program (`faults.FAULTS`: the state returned unchanged, half the points
left out of the problem, one keyframe's answer altered where it is
produced) and the shortcuts a change made for speed could take
(`faults.SHORTCUTS`: one LM iteration fewer a chunk, half the CG
iterations). For each LM seed, each LM step of the reference in float64
and in float32: the error before and after, and whether the step was kept
(`lm`). With --kernels, the device kernels of one global BA of the first
seed's map, as configured and with torch's TF32 allowed, and those of them
that the entry's precision check (`LOW_PRECISION`) names. Prints one JSON
line a seed and writes them all to --out.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def control_gaps(entry, st, mode: str = "tf32") -> dict:
    """The control's numbers: the reference in `mode` put in the program's
    place, judged as the program's answer is."""
    from slambench.harness import reference
    pb64, ref = entry.solved_reference(st)
    ar = reference.Arith(mode)
    got = reference.evaluate(pb64, *reference.global_ba(reference.problem(st.arr, st.data, ar),
                                                        ar))
    return reference.nan_to_inf(reference.gaps(pb64, got, ref))


def lm_steps(st) -> dict:
    """Each LM step of the reference in float64 and in float32: (error
    before, error after, kept)."""
    from slambench.harness import reference
    out = {}
    for mode in ("float64", "float32"):
        log = []
        ar = reference.Arith(mode)
        reference.global_ba(reference.problem(st.arr, st.data, ar), ar, log)
        out[mode] = log
    return out


def kernels(entry, st) -> dict:
    """The device kernels of one global BA as configured and with torch's
    TF32 allowed (the port pins it off at import), each with those the
    precision check names."""
    import torch
    out = {}
    for mode in ("configured", "tf32_allowed"):
        saved = torch.get_float32_matmul_precision()
        if mode == "tf32_allowed":
            torch.set_float32_matmul_precision("high")
        try:
            names = sorted(entry.device_kernels(st))
        finally:
            torch.set_float32_matmul_precision(saved)
        out[mode] = {"kernels": names,
                     "named_low": [n for n in names if entry.LOW_PRECISION.search(n)]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--lm-seeds", type=_ints, default=[],
                    help="seeds whose reference LM steps are logged in float64 and float32")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from slambench.harness import faults, spec
    bench = spec.Bench(ROOT)
    cell = bench.cell(args.workload)
    data = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    entry = bench.entry(traffic["entry"])
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    rows = []
    planted = dict(faults.FAULTS, **faults.SHORTCUTS)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        st = entry.setup(data, traffic, seed, dev, 1.0)
        row = {"seed": seed, "setup_s": time.perf_counter() - t0}
        row["answer"] = entry.answer_gaps(st, entry.run_once(st))
        if args.kernels and i == 0:
            row["kernels"] = kernels(entry, st)
        if seed in args.control_seeds:
            row["control"] = control_gaps(entry, st, "tf32")
            row["float32"] = control_gaps(entry, st, "float32")
        if seed in args.lm_seeds:
            row["lm"] = lm_steps(st)
        if seed in args.fault_seeds:
            for name, fault in planted.items():
                with fault(st):
                    row[name] = entry.answer_gaps(st, entry.run_once(st))
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": str(dev), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
