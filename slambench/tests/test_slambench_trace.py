"""The trace reader on a small Chrome trace written by hand."""
import json

import pytest

from slambench.harness import trace


class FakeProfile:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    X("user_annotation", "gba", 1, 98),
    X("user_annotation", "solver.solve", 40, 50),
    X("cpu_op", "aten::mm", 44, 2),
    X("cpu_op", "aten::add", 46.5, 1.5),
    X("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
    X("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=2),
    X("cuda_runtime", "cudaLaunchKernel", 47, 1, correlation=3),
    X("kernel", "k_a", 10, 20, correlation=1),
    X("kernel", "k_b", 50, 10, correlation=2),
    X("gpu_memcpy", "Memcpy DtoD", 55, 15, correlation=3),
    X("kernel", "k_c", 100, 10),                       # launch not in the trace
]


def test_busy_gaps_and_names():
    tr = trace.read(FakeProfile(EVENTS), ("gba", "solver.solve"), 120e-6)
    assert tr.window_s == pytest.approx(120e-6)
    assert tr.busy_s == pytest.approx(50e-6)          # [10,30], [50,70], [100,110]
    assert tr.n_activities == 4
    assert tr.by_name["k_a"] == (pytest.approx(20e-6), 1)
    assert [g[0] for g in tr.gaps] == ["unnamed", "solver.solve/aten::mm"]
    assert [g[1] for g in tr.gaps] == pytest.approx([30e-6, 20e-6])
    b = trace.breakdown(tr, tr.gaps)
    assert b["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    assert len(b["idle_gaps"]) == 2
    assert trace.kernel_time(tr, "k_") == (pytest.approx(40e-6), 3)


def test_the_launch_names_the_gap():
    ev = [X("user_annotation", "gba", 0, 100), X("cuda_runtime", "cudaLaunchKernel", 5, 1,
                                                  correlation=1),
          X("kernel", "k", 1, 2), X("kernel", "k", 20, 2, correlation=1)]
    tr = trace.read(FakeProfile(ev), ("gba",), 1e-4)
    assert tr.gaps == [("gba/none", pytest.approx(17e-6))]
