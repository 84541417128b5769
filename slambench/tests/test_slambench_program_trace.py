"""The program-span reader (`harness/program_trace.py`) on a Chrome trace
written by hand, the per-layer metrics that read it, and the tool that
traces a cell span by span (`tools/gba_spans.py`) at a small size on the
CPU."""
import io

import pytest
import torch

from slambench.harness import program_trace as pt_mod
from slambench.harness import trace
from slambench.harness.spec import Bench
from slambench.tests.small import SmallBench
from slambench.tests.test_slambench_trace import X, FakeProfile
from slambench.tools import gba_spans

BENCH = Bench()
HARNESS = ("gba", "gba.chunk", "loop_closing.problem", "solver.solve")

# one global BA: the harness's spans hold the program's; a CUDA call's
# correlation ties it to its device activity
EVENTS = [
    X("user_annotation", "gba", 0, 200),
    X("user_annotation", "gba.chunk", 1, 150),
    X("user_annotation", "loop_closing.global_ba", 2, 140),
    X("user_annotation", "loop_closing.problem", 3, 49),       # the harness's patch
    X("user_annotation", "loop_closing.ba_problem", 4, 47),
    X("cpu_op", "aten::arange", 5, 4),
    X("cuda_runtime", "cudaLaunchKernel", 6, 2, correlation=1),
    X("cpu_op", "aten::copy_", 41, 8),
    X("cuda_runtime", "cudaMemcpyAsync", 42, 1, correlation=2),
    X("cuda_runtime", "cudaStreamSynchronize", 44, 5),
    X("user_annotation", "solver.solve", 60, 80),               # the harness's patch
    X("user_annotation", "solvers.pcg", 61, 78),
    X("user_annotation", "solvers.pcg.step", 70, 60),
    X("user_annotation", "solvers.pcg.cg", 72, 50),
    X("cpu_op", "aten::bmm", 80, 10),
    X("cuda_runtime", "cudaLaunchKernel", 82, 3, correlation=3),
    X("cuda_driver", "cuLaunchKernel", 83, 1, correlation=4),   # nested in the runtime call
    X("cuda_runtime", "cudaLaunchKernel", 100, 2, correlation=5),
    X("cuda_runtime", "cudaStreamSynchronize", 180, 10),       # the harness's closing sync
    X("kernel", "k_problem", 10, 20, correlation=1),
    X("gpu_memcpy", "Memcpy HtoD", 45, 1, correlation=2),
    X("kernel", "gemm", 90, 30, correlation=3),
    X("kernel", "gemv", 121, 9, correlation=4),
    X("kernel", "ba_assemble_kernel", 140, 5, correlation=5),
    X("kernel", "k_lost", 150, 5),                             # its launch not in the trace
]


@pytest.fixture
def pt():
    return pt_mod.read(EVENTS, HARNESS)


def test_device_time_and_syncs_go_to_the_innermost_program_span(pt):
    rows = pt.rows
    assert rows["loop_closing.ba_problem"].device_s == pytest.approx(21e-6)
    assert rows["loop_closing.ba_problem"].launches == 2
    assert rows["loop_closing.ba_problem"].syncs == 1
    cg = rows["solvers.pcg.cg"]
    assert (cg.device_s, cg.launches, cg.syncs) == (pytest.approx(44e-6), 3, 0)
    assert cg.cuda_call_s == pytest.approx(5e-6)    # 82-85 and 100-102, the driver call once
    assert "loop_closing.problem" not in rows and "solver.solve" not in rows
    assert rows["solvers.pcg"].calls == 1 and rows["solvers.pcg"].host_s == pytest.approx(78e-6)
    assert rows["solvers.pcg"].self_s == pytest.approx(18e-6)
    assert rows["loop_closing.global_ba"].self_s == pytest.approx((140 - 47 - 78) * 1e-6)
    assert pt.device_s == pytest.approx(70e-6)
    assert pt.spanned_share() == pytest.approx(65 / 70) and pt.recorded()


def test_every_annotation_but_the_harnesss_is_a_program_span():
    """A span the program adds is read with no list of names: its own row,
    its parent's self time less its interval."""
    ev = EVENTS + [X("user_annotation", "tracking.new_stage", 99, 4)]
    pt = pt_mod.read(ev, HARNESS)
    assert pt.span_names() == ("loop_closing.global_ba", "loop_closing.ba_problem",
                               "solvers.pcg", "solvers.pcg.step", "solvers.pcg.cg",
                               "tracking.new_stage")
    assert pt.rows["tracking.new_stage"].launches == 1 and pt.rows["solvers.pcg.cg"].launches == 2
    assert pt.rows["solvers.pcg.cg"].self_s == pytest.approx(46e-6)
    assert pt_mod.read(EVENTS, ()).span_names()[:2] == ("gba", "gba.chunk")


def test_a_sync_outside_every_program_span_is_not_counted(pt):
    assert pt.rows[pt_mod.OUTSIDE].syncs == 1
    assert pt.rows[pt_mod.OUTSIDE].device_s == pytest.approx(5e-6)   # the lost launch
    assert BENCH.reader("gba.host_syncs").read({"program": pt, "n_program": 1}) == 1
    assert BENCH.reader("gba.host_syncs").read({"program": pt, "n_program": 2}) == 0.5


def test_gaps_take_the_programs_innermost_span(pt):
    """The benchmark's own gap reader, given the program's span names
    beside the harness's, names each gap by the innermost of either kind."""
    gaps = trace.read(FakeProfile(EVENTS), HARNESS + pt.span_names(), 200e-6).gaps
    names = dict((round(t * 1e6), n) for n, t in gaps)
    assert names[15] == "loop_closing.ba_problem/aten::copy_"  # 30 -> 45
    assert names[44] == "solvers.pcg.cg/aten::bmm"            # 46 -> 90
    assert names[10] == "solvers.pcg.cg/none"                 # 130 -> 140
    assert names[5] == "unnamed"                              # 145 -> 150
    assert [round(t * 1e6) for _, t in gaps] == [44, 15, 10, 5, 1]
    alone = trace.read(FakeProfile(EVENTS), HARNESS, 200e-6).gaps
    assert dict((round(t * 1e6), n) for n, t in alone)[44] == "solver.solve/aten::bmm"


def test_the_readers(pt):
    ctx = {"program": pt, "n_program": 2,
           "counts": {"solvers.pcg.lm_tried": 12, "solvers.pcg.lm_kept": 3}}
    assert BENCH.reader("solver.cg_ms").read(ctx) == pytest.approx(0.022)
    assert BENCH.reader("solver.lm_kept").read(ctx) == pytest.approx(25.0)
    table = pt_mod.table(pt, 2)
    assert table.splitlines()[1].split()[0] == "loop_closing.global_ba"
    assert table.splitlines()[-1].split()[0] == pt_mod.OUTSIDE


@pytest.mark.parametrize("metric", gba_spans.METRICS)
@pytest.mark.parametrize("ctx", [{}, {"n_program": 1, "counts": {}},
                                 {"program": pt_mod.read([], HARNESS), "n_program": 1,
                                  "counts": {"solvers.pcg.lm_tried": 0}}],
                         ids=["empty", "no_trace", "nothing_recorded"])
def test_the_readers_read_nothing_without_their_inputs(metric, ctx):
    assert BENCH.reader(metric).read(ctx) is None


def test_the_tool_at_a_small_size(monkeypatch):
    """The steps of `gba_spans.measure` on the CPU, PCG forced: every span
    of a global BA of 4 chunks (3 LM steps each) traced in the window
    that records, none in the one that does not."""
    from orb_slam2_tpu_torch.pipeline import loop_closing
    monkeypatch.setattr(loop_closing, "DENSE_GBA_BYTES", 0)
    bench = SmallBench()
    cell = bench.cell("kitti-stereo.global-ba")
    traffic = bench.traffic(cell["traffic"])
    entry = bench.entry(traffic["entry"])
    st = entry.setup(bench.config(cell["config"]), traffic, 3, torch.device("cpu"), 0.1)
    out = gba_spans.measure(bench, entry, st, gbas=1, rounds=1, host_reps=1, log=io.StringIO())
    per = {name: r["calls"] for name, r in out["rows"].items()}
    chunks, iters = st.chunks, st.iters
    assert per["loop_closing.global_ba"] == chunks and per["solvers.pcg.cg"] == chunks * iters
    assert per["solvers.assemble"] == chunks * (1 + iters)
    assert sum(per.values()) == chunks * (5 + 4 * iters)
    assert [w["spans_recorded"] for w in out["host_off"] + out["host_on"]] == [False, True]
    assert out["counts"]["solvers.pcg.lm_tried"] == chunks * iters
    assert out["metrics"]["solver.lm_kept"] is not None
    assert out["metrics"]["solver.cg_ms"] is None and out["metrics"]["gba.host_syncs"] is None
    assert len(out["host"]["call_ms"]) == chunks
