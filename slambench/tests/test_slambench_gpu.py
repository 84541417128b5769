"""Each cell at its own size on the card, through the kernels, traced, with
a short window: the run comes out correct and every per-layer metric that
BENCHMARK.json gives the cell reads within its range. Skips without a CUDA device (`gpu`
marker); on the card: `python -m pytest slambench/tests -m gpu`."""
import json

import pytest

from slambench import run as bench_run
from slambench.tests.small import SmallBench, load_config

pytestmark = pytest.mark.gpu
FULL = {name: (d["slam"]["max_keyframes"], d["slam"]["max_map_points"], d["map"]["keyframes"],
               d["map"]["points"])
        for name, d in ((n, load_config(n)) for n in ("kitti-stereo",))}


@pytest.mark.parametrize("cell", ["kitti-stereo.global-ba"])
def test_cell_on_the_card(cuda, capsys, cell):
    args = bench_run.parse(["--workload", cell, "--seed", "7", "--seconds", "2", "--trace", "1"])
    assert bench_run.run(args, SmallBench(FULL), cuda) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 < m["kernels.k9_roofline"] <= 105 and 0 < m["solver.roofline"] <= 105
    assert 0 <= m["device.idle_share"] < 100 and m["solver.ops_per_gba"] > 0
    assert m["gba.problem_ms"] > 0
    assert 0 < m["device.busy_per_gba"] <= out["device"]["busy_s"]
