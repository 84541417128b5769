"""The synthetic map at a small capacity: shapes, observers, the image,
what the seed changes and what it does not."""
import numpy as np
import pytest
import torch

from slambench.harness import mapgen, spec
from slambench.tests.small import load_config, small_config

BENCH = spec.Bench()
TRAFFIC = BENCH.traffic("global-ba")
COUNTS = sorted(int(k) for k in TRAFFIC["observers_per_point"])


def _arrays(name, seed):
    return mapgen.synthesize(small_config(load_config(name)), TRAFFIC, seed, "cpu")


@pytest.mark.parametrize("name", ["kitti-stereo"])
def test_shapes_and_observers(name):
    d = small_config(load_config(name))
    a = _arrays(name, 2147483653)
    K, P, O = d["slam"]["max_keyframes"], d["slam"]["max_map_points"], d["slam"]["ba_max_obs"]
    assert a.Tcw.shape == (K, 4, 4) and a.points.shape == (P, 3) and a.obs_kf.shape == (P, O)
    assert int(a.kf_valid.sum()) == d["map"]["keyframes"]
    assert int(a.pt_valid.sum()) == d["map"]["points"]
    n = a.n_obs[a.pt_valid]
    assert int(n.min()) >= COUNTS[0] and int(n.max()) <= COUNTS[-1] <= 12
    assert int(a.n_obs[~a.pt_valid].sum()) == 0
    # observers are distinct valid keyframes, in keyframe order, left-packed
    on = a.obs_kf >= 0
    assert bool(a.kf_valid[a.obs_kf[on]].all())
    s = torch.where(on, a.obs_kf, torch.full_like(a.obs_kf, 1 << 30))
    assert bool(((s[:, 1:] > s[:, :-1]) | ~on[:, 1:]).all())
    # observations inside the image, levels of the pyramid
    uv = a.obs_uv[on]
    assert float(uv[:, 0].min()) >= 0 and float(uv[:, 0].max()) <= d["slam"]["width"] - 1
    assert float(uv[:, 1].min()) >= 0 and float(uv[:, 1].max()) <= d["slam"]["height"] - 1
    lv = a.obs_level[on]
    assert int(lv.min()) >= 0 and int(lv.max()) < d["slam"]["n_levels"]
    # a stereo observation carries its depth, a monocular one none; a point
    # of one observer is a close stereo point; every point in front of its
    # observers
    stereo = a.obs_ur[on] >= 0
    depth = a.obs_depth[on]
    assert bool((depth[stereo] > 0).all()) and bool((depth[~stereo] == -1).all())
    single = (a.n_obs == 1)[:, None].expand_as(on)[on]
    close = d["slam"]["th_depth"] * d["slam"]["bf"] / d["slam"]["fx"]
    assert int(single.sum()) > 0 and float(stereo[single].double().mean()) > 0.95
    assert bool((depth[single & stereo] < close).all())
    kc = a.obs_kf.clamp(min=0)
    Twc = a.Twc_true[kc]
    pc = (Twc[..., :3, :3].transpose(-1, -2) @ (a.points_true[:, None, :] - Twc[..., :3, 3])[
        ..., None])[..., 0]
    assert bool((pc[..., 2][on] > mapgen.Z_MIN).all())


@pytest.mark.parametrize("name", ["kitti-stereo"])
def test_seed_changes_content_not_shapes(name):
    a, b, c = _arrays(name, 5), _arrays(name, 6), _arrays(name, 5)
    for f in ("Tcw", "points", "obs_kf", "obs_uv", "obs_ur", "obs_level"):
        x, y, z = getattr(a, f), getattr(b, f), getattr(c, f)
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, z), f            # the same seed, the same inputs
    assert not torch.equal(a.points, b.points)
    assert not torch.equal(a.obs_uv, b.obs_uv)
    # the count table is the traffic's, whatever the seed
    wanted = np.sort(mapgen.count_table(TRAFFIC, int(a.pt_valid.sum())))
    for x in (a, b):
        got = np.sort(x.n_obs[x.pt_valid].numpy())
        assert np.array_equal(got, wanted)


def test_drift_leaves_the_fixed_keyframe_and_moves_the_rest():
    a = _arrays("kitti-stereo", 11)
    Tcw_true = torch.linalg.inv(a.Twc_true)
    k = int(a.kf_valid.sum())
    gap = (a.Tcw[:k].double() - Tcw_true[:k]).abs().flatten(1).max(dim=1).values
    assert float(gap[0]) < 1e-5
    assert float(gap[1:].min()) > 1e-4


def test_count_table_is_exact():
    t = mapgen.count_table(TRAFFIC, 1000)
    assert len(t) == 1000 and t.min() == COUNTS[0] and t.max() == COUNTS[-1]
    hist = TRAFFIC["observers_per_point"]
    total = sum(hist.values())
    for k, w in hist.items():
        assert abs((t == int(k)).sum() - w / total * 1000) <= len(hist)


def test_keyframe_major_round_trip():
    a = _arrays("kitti-stereo", 3)
    N = 2048
    feat_point, xy, ur, depth, level = mapgen.keyframe_major(a, N)
    on = feat_point >= 0
    assert int(on.sum()) == int((a.obs_kf >= 0).sum())
    # each keyframe's bindings are its observations
    for k in range(int(a.kf_valid.sum())):
        pts = set(feat_point[k][on[k]].tolist())
        want = set(torch.nonzero((a.obs_kf == k).any(dim=1))[:, 0].tolist())
        assert pts == want
    k, f = torch.nonzero(on)[7].tolist()
    p = int(feat_point[k, f])
    o = int(torch.nonzero(a.obs_kf[p] == k)[0, 0])
    assert torch.equal(xy[k, f], a.obs_uv[p, o]) and float(ur[k, f]) == float(a.obs_ur[p, o])
    assert int(level[k, f]) == int(a.obs_level[p, o])
    with pytest.raises(RuntimeError):
        mapgen.keyframe_major(a, 4)
