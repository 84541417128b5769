#!/usr/bin/env python3
"""A cell's global BA span by span: the program's own spans and counters
(`orb_slam2_tpu_torch/utils/spans.py`) read from the profiler's trace,
beside the kinds of window the benchmark's `--trace 1` run traces, in one
process on the card:

    python3 slambench/tools/gba_spans.py --workload kitti-stereo.global-ba --seed <n> \\
        [--gbas 2] [--rounds 2] [--host-reps 10] [--out chiprun_out/gba_spans.json]

After the cell's own set-up (`entries/global_ba.setup`: the map, two warm
global BAs), in this order:

1. `host`: --host-reps global BAs from m0, each `run_global_ba` call timed
   on the host's clock to its return (no synchronisation), each global BA
   to its synchronisation: the program's host cost, spans off.
2. `cuda`: --gbas global BAs under the profiler with the CUDA activity
   only, spans off: the kind of window `device.busy_per_gba`,
   `solver.ops_per_gba` and `kernels.k9_roofline` read.
3. --rounds times, `host_off` then `host_on`: --gbas global BAs under the
   profiler with the CPU activity too, each in a span "gba" and each chunk
   in "gba.chunk" as the benchmark's host-profiled window has them; spans
   off, then inside `spans.recording()`. The last `host_on` window gives
   the per-span table (on stderr), the longest idle gaps and the per-layer
   metrics that read the program's spans and counters (`solver.cg_ms`,
   `gba.host_syncs`, `solver.lm_kept`; their counters summed over every
   `host_on` window).

Each profiled window's K9 activities in the trace are set against the
change of `LAUNCHES["ba_edge"]` across it: a shortfall is activities the
profiler dropped, and that window's sums are lower bounds. Prints one JSON
line on stdout (and writes it to --out). With a program that has no
`utils/spans.py`, the `host_on` windows record no span and their metrics
are null.
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

METRICS = ("solver.cg_ms", "gba.host_syncs", "solver.lm_kept")


def _program_spans():
    """The program's span module, or None for a program without one."""
    try:
        from orb_slam2_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def host_costs(entry, st, reps: int) -> dict:
    """Host ms of each `run_global_ba` call (to its return) and seconds of
    each global BA (to its synchronisation), spans off."""
    from orb_slam2_tpu_torch.pipeline import loop_closing
    calls, gbas = [], []
    entry.sync(st.device)
    for _ in range(reps):
        t0 = time.perf_counter()
        m = st.m0
        for _ in range(st.chunks):
            t1 = time.perf_counter()
            m = loop_closing.run_global_ba(st.scfg, m, n_iters=st.iters)
            calls.append(1e3 * (time.perf_counter() - t1))
        entry.sync(st.device)
        gbas.append(time.perf_counter() - t0)
    return {"call_ms": calls, "gba_s": gbas, "call_ms_median": statistics.median(calls),
            "gba_s_median": statistics.median(gbas)}


def window(entry, st, gbas: int, host: bool, record: bool):
    """`gbas` global BAs from m0 under the profiler (the CPU activity too
    with `host`), inside `spans.recording()` with `record`: (the program
    trace, the harness's trace with gaps named by the innermost span of
    either kind, seconds per global BA, K9 launches counted across it)."""
    import contextlib
    import torch
    from orb_slam2_tpu_torch.ops import launch
    from orb_slam2_tpu_torch.pipeline import loop_closing
    from slambench.harness import program_trace, trace
    spans = _program_spans()
    acts = [torch.profiler.ProfilerActivity.CUDA] if st.device.type == "cuda" else []
    if host or not acts:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    mark = torch.profiler.record_function if host else (lambda name: contextlib.nullcontext())
    rec = spans.recording() if record and spans else contextlib.nullcontext()
    entry.sync(st.device)
    k9_before = launch.LAUNCHES["ba_edge"]
    with rec, torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(gbas):
            with mark("gba"):
                m = st.m0
                for _ in range(st.chunks):
                    with mark("gba.chunk"):
                        m = loop_closing.run_global_ba(st.scfg, m, n_iters=st.iters)
                entry.sync(st.device)
        window_s = time.perf_counter() - t0
    k9 = launch.LAUNCHES["ba_edge"] - k9_before
    events = program_trace.chrome_events(prof)
    pt = program_trace.read(events, entry.SPANS)
    tr = trace.read(program_trace.Exported(events), entry.SPANS + pt.span_names(), window_s)
    return pt, tr, window_s / gbas, k9


def _summary(entry, pt, tr, per_gba: float, k9: int, gbas: int) -> dict:
    from slambench.harness import trace
    traced = trace.kernel_time(tr, entry.K9_NAME)[1]
    return {"gba_s": per_gba, "busy_s_per_gba": tr.busy_s / gbas,
            "activities_per_gba": tr.n_activities / gbas,
            "k9_traced": traced, "k9_launched": k9, "k9_dropped": k9 - traced,
            "spanned_share": pt.spanned_share(), "spans_recorded": pt.recorded()}


def measure(bench, entry, st, gbas: int, rounds: int, host_reps: int, log=sys.stderr) -> dict:
    """The steps of the module's docstring on a set-up cell (`st`)."""
    from slambench.harness import program_trace
    spans = _program_spans()
    out = {"host": host_costs(entry, st, host_reps)}
    pt, tr, per, k9 = window(entry, st, gbas, host=False, record=False)
    out["cuda"] = _summary(entry, pt, tr, per, k9, gbas)
    out["host_off"], out["host_on"] = [], []
    if spans:
        spans.counts()
    for _ in range(rounds):
        for name, record in (("host_off", False), ("host_on", True)):
            pt, tr, per, k9 = window(entry, st, gbas, host=True, record=record)
            out[name].append(_summary(entry, pt, tr, per, k9, gbas))
    counts = spans.counts() if spans else {}
    ctx = {"program": pt, "n_program": gbas, "counts": counts}
    out["metrics"] = {m: bench.reader(m).read(ctx) for m in METRICS}
    out["counts"] = counts
    out["gaps"] = tr.gaps
    out["rows"] = {name: {k: v / gbas for k, v in vars(r).items()} for name, r in pt.rows.items()}
    for name, w in [("cuda", out["cuda"])] + [(k, w) for k in ("host_off", "host_on")
                                              for w in out[k]]:
        print(f"gba_spans: {name}: {w['gba_s']:.4f} s a global BA, K9 {w['k9_traced']} traced "
              f"of {w['k9_launched']} launched"
              + (f" ({w['k9_dropped']} dropped: the window's sums are lower bounds)"
                 if w["k9_dropped"] else ""), file=log)
    print(program_trace.table(pt, gbas), file=log)
    print(f"gba_spans: device time launched inside a program span "
          f"{100 * pt.spanned_share():.2f} %; " + ", ".join(
              f"{m} {v!r}" for m, v in out["metrics"].items()), file=log)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--gbas", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--host-reps", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from slambench.harness import spec
    bench = spec.Bench(ROOT)
    cell = bench.cell(args.workload)
    traffic = bench.traffic(cell["traffic"])
    entry = bench.entry(traffic["entry"])
    if not torch.cuda.is_available():
        print("gba_spans: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    st = entry.setup(bench.config(cell["config"]), traffic, args.seed, dev, 1.0)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev)}
    out.update(measure(bench, entry, st, args.gbas, args.rounds, args.host_reps))
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
