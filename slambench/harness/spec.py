"""Finding a cell's parts by name: `BENCHMARK.json` at the root of the
checkout names each cell's configuration and traffic; each lives in a file
of its own under `slambench/`, found by that name:

- a configuration: the `file` its entry in `BENCHMARK.json` names;
- a traffic mix: `slambench/traffic/<traffic>.json`, whose "entry" names
  the code that drives it, `slambench/entries/<entry>.py`;
- a per-layer metric: `slambench/metrics/<metric name>.py`, a `read(ctx)`
  that returns the number or None;
- a cell's correctness limits: `slambench/limits/<cell>.json`.

A new cell, configuration, traffic mix or metric adds files and entries and
edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """`BENCHMARK.json` and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = _load_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "slambench")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return _load_json(os.path.join(self.dir, "limits", f"{cell}.json"))

    def entry(self, name: str):
        return _load_module(os.path.join(self.dir, "entries", f"{name}.py"),
                            f"slambench_entry_{name.replace('-', '_')}")

    def metrics(self, kind: str, cell: str) -> list:
        """The `end_to_end` or `per_layer` metrics that cell reports: those
        whose `workloads` list it, or that have no `workloads` and move (or,
        end to end, are) a metric the cell reports."""
        ms = self.data[kind]
        if kind == "end_to_end":
            return [m for m in ms if "workloads" not in m or cell in m["workloads"]]
        e2e = {m["name"] for m in self.metrics("end_to_end", cell)}
        return [m for m in ms
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str):
        return _load_module(os.path.join(self.dir, "metrics", f"{metric}.py"),
                            "slambench_metric_" + metric.replace(".", "_").replace("-", "_"))
