#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell (`BENCHMARK.json`'s `workloads`) names a configuration and a
traffic mix; the traffic names the entry (`slambench/entries/<entry>.py`)
that sets up its inputs from the seed, runs one unit of work, and judges
the answers against the plain reference.

A run: set-up (counted in `setup_s`, from the start of this script to the
first timed unit: imports, the inputs, the program's state, the kernels
built or loaded, warm units), then units back to back until `--seconds`
have passed, each ended by a device synchronisation; the window ends with
the first unit completed after that. With `--trace 1`, a short window
under the profiler follows and the per-layer metrics are read from it
(`slambench/metrics/<name>.py`). Then the peak device memory is read, the
program's state freed, and the answers judged. The last line on standard
output is one JSON object: correct, attempted, failed, metrics, device,
(breakdown,) checks. Each compared number is printed beside its limit as
the last lines on standard error too.

Exits 2 without a result where the cell's cards are missing, and 3 where
JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TRACE_SECONDS = 1.0      # the traced window's least length


def _environment():
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc build goes to `orb_slam2_tpu_torch/_build/` by itself), and
    the CUDA libraries held to float32 arithmetic (no TF32), as the
    configuration states, whatever a program sets in torch."""
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    cache = os.path.join(ROOT, ".slambench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")


class _GcClock:
    """Counts the garbage collector's passes by generation, and their
    seconds, while it is entered."""

    def __init__(self):
        self.passes, self.seconds, self._t = [0, 0, 0], 0.0, None

    def _hook(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.passes[info["generation"]] += 1
            self.seconds += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        import gc
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._hook)

    def summary(self) -> str:
        return (f"{self.passes[0]} / {self.passes[1]} / {self.passes[2]} passes by generation, "
                f"{self.seconds:.4f} s")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from slambench.harness import spec
    bench = spec.Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"slambench: imports {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    if n < chips:
        print(f"slambench: {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    return run(args, bench, torch.device("cuda", 0))


def run(args, bench, dev) -> int:
    """One run of a cell on `dev` (the tests drive it on the CPU at small
    sizes): set-up, the window, the trace, the judgement, the result."""
    import torch
    from slambench.harness import guard, trace as tracing
    cell = bench.cell(args.workload)
    data = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(cell["name"])["limits"]
    entry = bench.entry(traffic["entry"])
    on_card = dev.type == "cuda"
    torch.set_num_threads(1)

    t_entry = time.perf_counter() - T_START
    st = entry.setup(data, traffic, args.seed, dev, args.seconds)
    setup_s = time.perf_counter() - T_START
    print(f"slambench: set-up {setup_s:.3f} s: to the entry {t_entry:.3f}, "
          + ", ".join(f"{k} {v:.3f}" for k, v in st.phases.items()), file=sys.stderr)

    n = 0
    ends = []
    gcs = _GcClock()
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    with gcs:
        while True:
            entry.keep(st, n, entry.run_once(st))
            entry.sync(dev)
            n += 1
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= args.seconds:
                break
    window_s = ends[-1] - t0
    cpu_s = time.process_time() - cpu0
    units = sorted(b - a for a, b in zip([t0] + ends, ends))
    quart = [units[round(q * (len(units) - 1))] for q in (0, 0.25, 0.5, 0.75, 1)]
    print(f"slambench: units {' / '.join(f'{u:.4f}' for u in quart)} s (least, quartiles, "
          f"most); the garbage collector in the window: {gcs.summary()}", file=sys.stderr)

    values = dict(entry.end_to_end(window_s, n), setup_s=setup_s)
    result_metrics = {}
    breakdown = None
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": cell["chips"]}
    if args.trace:
        ctx = entry.trace_context(st, values, TRACE_SECONDS)
        for m in bench.metrics("per_layer", cell["name"]):
            v = bench.reader(m["name"]).read(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = ctx["trace"].busy_s
        device["window_s"] = ctx["trace"].window_s
        breakdown = tracing.breakdown(ctx["trace"], ctx["gaps"])
    else:
        for m in bench.metrics("end_to_end", cell["name"]):
            result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0

    checks, failed, distinct, ref_s = entry.judge(st, n, limits)
    found = guard.forbidden_modules()
    if found:
        print(f"slambench: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    print(f"slambench: {cell['name']} seed {args.seed}: {n} units in {window_s:.3f} s "
          f"(the process's host CPU {cpu_s:.3f} s), set-up {setup_s:.3f} s, {distinct} "
          f"distinct answer(s), reference {ref_s:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} <= {c['limit']!r}", file=sys.stderr)
    out = {"correct": correct, "attempted": n, "failed": failed, "metrics": result_metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
