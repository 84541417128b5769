"""Finding cells, configurations, traffic, limits and metrics by name, and
BENCHMARK.json against the benchmark's contract."""
import json
import os
import re
import shutil

import pytest

from slambench.harness import spec

BENCH = spec.Bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH.data["workloads"]]


def test_lookup_by_name():
    cell = BENCH.cell("kitti-stereo.global-ba")
    assert cell["config"] == "kitti-stereo" and cell["traffic"] == "global-ba"
    assert BENCH.config("kitti-stereo")["slam"]["max_keyframes"] == 512
    assert BENCH.traffic("global-ba")["entry"] == "global_ba"
    assert set(BENCH.limits("kitti-stereo.global-ba")["limits"]) >= {"chi2_gap"}
    for missing in (lambda: BENCH.cell("nope"), lambda: BENCH.config("nope")):
        with pytest.raises(KeyError):
            missing()
    with pytest.raises(FileNotFoundError):
        BENCH.traffic("nope")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_its_metrics(cell):
    e2e = [m["name"] for m in BENCH.metrics("end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = BENCH.metrics("per_layer", cell)
    assert BENCH.metrics("per_layer", "another.cell") == []
    assert {m["name"] for m in per} == {"gba.problem_ms", "solver.roofline",
                                        "solver.ops_per_gba", "kernels.k9_roofline",
                                        "device.idle_share", "device.busy_per_gba"}
    for m in per:
        assert m["moves"] in e2e
        assert BENCH.reader(m["name"]).read({}) is None     # nothing to read: nothing


def test_contract():
    d = BENCH.data
    raw = open(os.path.join(spec.ROOT, "BENCHMARK.json"), "rb").read()
    assert len(raw) <= 64 * 1024
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["paths"] == ["slambench"] and d["command"][1].startswith("slambench/")
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    names = [c["name"] for c in d["configs"]]
    used = {w["config"] for w in d["workloads"]}
    assert len(set(names)) == len(names) and used == set(names)
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("slambench/") and os.path.isfile(
            os.path.join(spec.ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["reduced"] == []
    pairs = set()
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "limits", w["name"] + ".json"))
    metric_names = []
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        metric_names.append(m["name"])
    assert "setup_s" in metric_names
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["moves"] in metric_names and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
        metric_names.append(m["name"])
    assert all(NAME.match(n) for n in metric_names) and len(set(metric_names)) == len(
        metric_names)


def test_a_new_metric_is_found_by_its_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads(open(os.path.join(spec.ROOT, "BENCHMARK.json")).read())
    data["per_layer"].append({"name": "solver.cg_iters", "unit": "n", "better": "lower",
                              "source": "program_counter", "layer": "solvers",
                              "moves": "gba_s", "workloads": [CELLS[0]]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    (root / "slambench" / "metrics" / "solver.cg_iters.py").write_text(
        "def read(ctx):\n    return ctx.get('cg_iters')\n")
    b = spec.Bench(str(root))
    assert "solver.cg_iters" in [m["name"] for m in b.metrics("per_layer", CELLS[0])]
    assert b.metrics("per_layer", "another.cell") == []
    assert b.reader("solver.cg_iters").read({"cg_iters": 50}) == 50
