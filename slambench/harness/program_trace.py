"""Reading the program's own spans (`orb_slam2_tpu_torch/utils/spans.py`)
from a `torch.profiler` Chrome trace with the CPU and CUDA activities: for
each program span, its host time, its host time inside CUDA calls, and the
device time, device activities and synchronising calls it issued.

A program span is any "user_annotation" event that is not one of the
harness's own spans (the names it is given), so a span the program adds or
renames is read with no edit here. Attribution, as the trace ties them: a
host-side CUDA call ("cuda_runtime" or "cuda_driver") belongs to the
innermost program span whose interval holds its start; a device activity
("kernel", "gpu_memcpy", "gpu_memset") to the span of the call with its
correlation id; a call or activity that no program span holds, or whose
launch is not in the trace, to OUTSIDE. A sync the harness's spans hold
outside every program span (the end of a global BA) stays in OUTSIDE. The
idle gaps are `trace.read`'s, given the program's span names beside the
harness's (`span_names`) and the same events (`Exported`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

from slambench.harness.trace import DEVICE_CATS, _innermost

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
HOST_CUDA_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(outside)"


@dataclasses.dataclass
class Row:
    """One program span's sums over a window (OUTSIDE: what none holds)."""
    calls: int = 0
    host_s: float = 0.0      # the span's intervals, nested spans included
    self_s: float = 0.0      # the same, less the program spans nested in it
    cuda_call_s: float = 0.0  # host time in CUDA runtime and driver calls
    device_s: float = 0.0    # device activities launched here
    launches: int = 0        # those activities
    syncs: int = 0           # synchronising CUDA calls (SYNC_CALLS)


@dataclasses.dataclass
class ProgramTrace:
    rows: dict               # span name -> Row, by first appearance; OUTSIDE first

    @property
    def device_s(self) -> float:
        """Every device activity's time."""
        return sum(r.device_s for r in self.rows.values())

    def span_names(self) -> tuple:
        """The program spans traced, by first appearance."""
        return tuple(name for name, r in self.rows.items() if name != OUTSIDE and r.calls)

    def spanned_share(self) -> float:
        """The share of the device time launched inside some program span."""
        total = self.device_s
        return 1.0 - self.rows[OUTSIDE].device_s / total if total > 0 else 0.0

    def recorded(self) -> bool:
        """Whether any program span is in the trace (a program without
        spans, or a window not recording, leaves none)."""
        return bool(self.span_names())


def chrome_events(prof) -> list:
    """The events of a finished `torch.profiler.profile`, by its Chrome
    trace (written to the temporary directory and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


class Exported:
    """A profile's exported events, handed again to a reader that exports
    the profile itself (`trace.read`): a profile exports only once."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _intervals(xs, keep):
    """(start, end, name) of the events that `keep` accepts, by start, an
    outer interval before an inner one of the same start."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs if keep(e)]
    out.sort(key=lambda i: (i[0], -i[1]))
    return out


def read(events, harness_spans=()) -> ProgramTrace:
    """Sum the trace's `events` (`chrome_events`) by program span: every
    "user_annotation" not named in `harness_spans`."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    prog = _intervals(xs, lambda e: e.get("cat") == "user_annotation"
                      and e["name"] not in harness_spans)
    prog_s = [p[0] for p in prog]
    rows = {OUTSIDE: Row()}

    def row_at(ts):
        name = _innermost(prog, prog_s, ts)
        return rows[OUTSIDE] if name == "none" else rows[name]

    open_ = []               # the spans holding the current one, innermost last
    for s, e, name in prog:
        while open_ and open_[-1][1] < s:
            open_.pop()
        r = rows.setdefault(name, Row())
        r.calls += 1
        r.host_s += (e - s) * 1e-6
        r.self_s += (e - s) * 1e-6
        if open_:
            rows[open_[-1][2]].self_s -= (e - s) * 1e-6
        open_.append((s, e, name))

    reach = None
    for s, e, name in _intervals(xs, lambda e: e.get("cat") in HOST_CUDA_CATS):
        # runtime and driver calls may nest: each host microsecond once
        if reach is None or e > reach:
            row_at(s).cuda_call_s += (e - (s if reach is None else max(s, reach))) * 1e-6
            reach = e
        if name in SYNC_CALLS:
            row_at(s).syncs += 1
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                 if e.get("cat") in HOST_CUDA_CATS and "correlation" in e.get("args", {})}
    for ev in xs:
        if ev.get("cat") in DEVICE_CATS:
            ts = launch_ts.get(ev.get("args", {}).get("correlation"))
            r = rows[OUTSIDE] if ts is None else row_at(ts)
            r.device_s += float(ev["dur"]) * 1e-6
            r.launches += 1
    return ProgramTrace(rows=rows)


def table(pt: ProgramTrace, n: int) -> str:
    """The rows per global BA (n of them in the window): the program
    spans traced, by first appearance, then OUTSIDE."""
    head = (f"{'span (per global BA)':<24} {'calls':>7} {'host ms':>10} {'self ms':>10} "
            f"{'in CUDA ms':>10} {'device ms':>10} {'launches':>9} {'syncs':>6}")
    lines = [head]
    for s in pt.span_names() + (OUTSIDE,):
        r = pt.rows[s]
        lines.append(f"{s:<24} {r.calls / n:>7.2f} {1e3 * r.host_s / n:>10.3f} "
                     f"{1e3 * r.self_s / n:>10.3f} {1e3 * r.cuda_call_s / n:>10.3f} "
                     f"{1e3 * r.device_s / n:>10.3f} {r.launches / n:>9.1f} {r.syncs / n:>6.2f}")
    return "\n".join(lines)
