"""Spans and counters inside the port, on the profiler's own clock.

A span is a `torch.profiler.record_function` range and a counter a sum the
program adds to; both are off unless a caller turns them on with
`recording()`, which holds for the code inside it and in that thread only,
and then they cost a Python call each and nothing on the device. There is no second store
of times and no second clock: under a `torch.profiler.profile` with the CPU
activity, each span lands in the same Chrome trace as the device's
activities (CUPTI), and each launch inside a span is tied to the activity
it started by its correlation id.

Recording a global BA's spans and counters around any call into the port::

    import torch
    from orb_slam2_tpu_torch.pipeline import loop_closing
    from orb_slam2_tpu_torch.utils import spans

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with spans.recording(), torch.profiler.profile(activities=acts) as prof:
        m = loop_closing.run_global_ba(cfg, m, n_iters=3)
        torch.cuda.synchronize()
    kept = spans.counts()               # {"solvers.pcg.lm_kept": 2, ...}
    prof.export_chrome_trace("gba.json")

In the Chrome trace (`chrome://tracing` or Perfetto) a span is an event of
category "user_annotation" named as below. A host-side CUDA call ("cuda_runtime"
or "cuda_driver") belongs to the innermost span whose interval holds it,
and a device activity ("kernel", "gpu_memcpy", "gpu_memset") to the span of
the runtime call that has its `args.correlation`; a synchronising call
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`, `cudaEventSynchronize`)
is the host waiting for the card. `slambench/harness/program_trace.py`
reads a trace so, span by span.

The spans of a global BA (`loop_closing.run_global_ba`), each chunk:
`loop_closing.global_ba` (the whole call) holding `loop_closing.ba_problem`
and the solver's; PCG's `solvers.pcg` (the LM loop) holds
`solvers.pcg.edges` (the edge layout, once a solve), `solvers.assemble`
(K9, once an edge pass: 1 + n_iters), and for each LM step
`solvers.pcg.precompute` and `solvers.pcg.step`, which holds
`solvers.pcg.cg` (the CG loop). The counters: `solvers.pcg.lm_tried` (LM
steps) and `solvers.pcg.lm_kept` (those whose error fell: the device's
accept flags, kept unread until `counts()`).

Kernel launches are counted apart, always, by `ops/launch.LAUNCHES`.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_OFF = contextlib.nullcontext()
# on inside recording(), in that context only: a thread started inside
# it, or any other thread, starts off
_on = contextvars.ContextVar("orb_slam2_tpu_torch_spans", default=False)
_added = {}        # counter name -> the values added since the last counts()


def span(name: str):
    """A context manager: `torch.profiler.record_function(name)` while
    recording, else a shared no-op."""
    if not _on.get():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def recording():
    """Spans and counters on for the code inside, and off again after."""
    token = _on.set(True)
    try:
        yield
    finally:
        _on.reset(token)


def count(name: str, value=1):
    """Add `value` (a whole number, or a 0-d integer or bool tensor on any
    device, which is kept and not read) to the counter `name`, while
    recording."""
    if _on.get():
        _added.setdefault(name, []).append(value)


def counts() -> dict:
    """Each counter's sum since the last call, {name: int}, and the
    counters reset: one host read a device for all the tensors added."""
    global _added
    added, _added = _added, {}
    out = {name: 0 for name in added}
    on_device = {}       # device -> [(name, value)]
    for name, values in added.items():
        for v in values:
            if isinstance(v, torch.Tensor):
                on_device.setdefault(v.device, []).append((name, v.reshape(()).to(torch.int64)))
            else:
                out[name] += int(v)
    for pairs in on_device.values():
        for (name, _), v in zip(pairs, torch.stack([v for _, v in pairs]).tolist()):
            out[name] += v
    return out
