"""The traffic's measured groups: the committed traffic is what
`tools/mapstats.py` makes of the committed measurement, and the statistics
read back what the map generator was given."""
import json
import os

import pytest
import torch

from slambench.harness import spec
from slambench.tests.small import SmallBench
from slambench.tools import mapstats

BENCH = spec.Bench()
TRAFFIC = BENCH.traffic("global-ba")


def _row(where):
    with open(os.path.join(spec.ROOT, where["file"])) as f:
        return next(r for r in json.load(f)["rows"] if r["row"] == where["row"])


def test_traffic_is_the_measurement():
    got = mapstats.traffic_groups(_row(TRAFFIC["measured_on"]))
    # the gross outliers are measured and left out (the traffic's "assumed")
    assert TRAFFIC["outlier_share"] == 0
    assert TRAFFIC["measured_outlier_share"] == got.pop("outlier_share")
    for k, v in got.items():
        assert TRAFFIC[k] == json.loads(json.dumps(v)), k


def test_stats_read_back_the_generated_map():
    from orb_slam2_tpu_torch.pipeline import loop_closing
    b = SmallBench()
    c = b.cell("kitti-stereo.global-ba")
    entry = b.entry("global_ba")
    st = entry.setup(b.config(c["config"]), b.traffic(c["traffic"]), 3, torch.device("cpu"),
                     0.01)
    m1 = st.m0
    for _ in range(st.chunks):
        m1 = loop_closing.run_global_ba(st.scfg, m1, n_iters=st.iters)
    s = mapstats.map_stats(st.scfg, st.m0, m1)
    n = st.arr.n_obs[st.arr.pt_valid]
    want = {str(k): int(v) for k, v in enumerate(torch.bincount(n).tolist()) if v}
    assert s["observers_per_point"] == want
    assert s["edges"] == int(n.sum())
    assert s["stereo_share"] == pytest.approx(float((st.arr.obs_ur[st.arr.obs_kf >= 0] >= 0)
                                                     .double().mean()))
    # the global BA moved the drifted map back: its corrections are of the
    # drift's size
    assert 0 < s["drift"]["max_centre_move_m"] < 10
    assert 0.5 * TRAFFIC["pixel_sigma"] < s["pixel_sigma_mono"] < 1.5 * TRAFFIC["pixel_sigma"]
