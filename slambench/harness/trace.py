"""Reading a `torch.profiler` trace of a short window: the device's busy
time, its activities by name, and the idle gaps named by what the host was
issuing when each ended.

The profiler's Chrome trace is written to a file in the temporary
directory, read and removed. Device activities are the kernels, copies and
fills ("kernel", "gpu_memcpy", "gpu_memset"); the window is the host's
clock from a device synchronisation before the traced work to one after
it, so every activity in the trace falls inside it. Where the trace holds
host events (a profile with the CPU activity), a gap ends with an activity
whose launch (the runtime call of the same correlation id) sat inside the
harness's innermost span and an innermost host operator: the gap is named
"span/operator"; without them, "unnamed".
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    n_activities: int
    by_name: dict            # name -> (seconds, count)
    gaps: list               # [(name, seconds)], longest first


def _innermost(intervals, starts, ts):
    """The name of the innermost interval (start, end, name) holding ts:
    nested intervals on one thread, sorted by start, so the latest start
    that still holds ts."""
    for j in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
        if intervals[j][1] >= ts:
            return intervals[j][2]
    return "none"


def read(prof, spans: tuple, window_s: float) -> Trace:
    """Summarise `prof` (a finished `torch.profiler.profile` of a window
    of `window_s` seconds); `spans` are the harness's span names."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                  for e in xs if e.get("cat") in DEVICE_CATS), key=lambda x: x[0])
    by_name = {}
    for s, e, ev in dev:
        t, n = by_name.get(ev["name"], (0.0, 0))
        by_name[ev["name"]] = (t + (e - s) * 1e-6, n + 1)

    launches = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
    ann = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                 if e.get("cat") == "user_annotation" and e["name"] in spans)
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                 if e.get("cat") == "cpu_op")
    ann_s, ops_s = [a[0] for a in ann], [o[0] for o in ops]

    busy, found, end = 0.0, [], None
    for s, e, ev in dev:
        if end is not None and s > end:
            found.append(((s - end) * 1e-6, ev))
        if end is None or e > end:
            busy += e - (s if end is None else max(s, end))
            end = e
    found.sort(key=lambda g: -g[0])
    gaps = []
    for length, ev in found[:TOP]:
        ts = launches.get(ev.get("args", {}).get("correlation"))
        name = "unnamed" if ts is None else \
            f"{_innermost(ann, ann_s, ts)}/{_innermost(ops, ops_s, ts)}"
        gaps.append((name, length))
    return Trace(window_s=window_s, busy_s=busy * 1e-6, n_activities=len(dev),
                 by_name=by_name, gaps=gaps)


def breakdown(tr: Trace, gaps: list) -> dict:
    """The `breakdown` of a result line: the device operations of `tr` that
    took most time and the longest idle `gaps`, at most TOP each."""
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"device_ops": [[name[:120], t] for name, (t, _) in ops],
            "idle_gaps": [[name[:120], t] for name, t in gaps[:TOP]]}


def kernel_time(tr: Trace, needle: str):
    """(seconds, launches) of the device activities whose name holds needle."""
    t = n = 0
    for name, (s, c) in tr.by_name.items():
        if needle in name:
            t, n = t + s, n + c
    return t, n
