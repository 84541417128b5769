"""Small versions of the benchmark's configurations for the CPU tests:
capacities and fill cut, the trajectory's frames cut with them so the
keyframes keep their spacing. Everything else (camera, scene, drift,
traffic) is the configuration's own."""
from __future__ import annotations

import copy
import json
import os

from slambench.harness import spec

# (keyframe slots, point slots, keyframes filled, points filled)
SIZES = {"kitti-stereo": (24, 1536, 24, 1536)}


def load_config(name: str) -> dict:
    """A configuration file by its name (`slambench/configs/<name>.json`)."""
    with open(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


def small_config(data: dict, sizes=None) -> dict:
    K, P, n_kf, n_pt = sizes or SIZES[data["name"]]
    d = copy.deepcopy(data)
    full_kf = d["map"]["keyframes"]
    d["slam"]["max_keyframes"], d["slam"]["max_map_points"] = K, P
    d["map"]["keyframes"], d["map"]["points"] = n_kf, n_pt
    tr = d["map"]["trajectory"]
    tr["n_frames"] = int(tr["n_frames"] * n_kf / full_kf) + 2
    return d


class SmallBench(spec.Bench):
    """The repository's BENCHMARK.json, every configuration small."""

    def __init__(self, sizes=None):
        super().__init__()
        self.sizes = sizes or {}

    def config(self, name: str) -> dict:
        return small_config(load_config(name), self.sizes.get(name))
