"""The port's `ar.py` and `viewer.py` against the JAX reference's on the
CPU. `ar` is host NumPy in both packages: every output equal exactly.
The viewer draws with matplotlib (Agg): plot_map, draw_frame,
SlamSystem.draw_current_frame and LiveViewer write their PNGs, and the map
view scatters as many points and keyframes as the reference's plot_map on
the same map (the port's, converted).
"""
import os
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu import ar as jar
from orb_slam2_tpu import viewer as jviewer
from orb_slam2_tpu.mapstate import map as jmap

from orb_slam2_tpu_torch import ar as tar
from orb_slam2_tpu_torch import viewer as tviewer
from orb_slam2_tpu_torch.utils import convert

from test_ar import make_plane_points
from test_torch_checkpoint import small_run

torch.set_num_threads(2)


@pytest.mark.parametrize("normal, Tc", [((0.0, 0.0, 1.0), (0.0, 0.0, 0.0)),
                                        ((0.3, -1.0, 0.2), (0.5, -0.2, 1.0))])
def test_ar_matches_reference(rng, normal, Tc):
    pts, _ = make_plane_points(rng, normal=normal)
    Tcw = np.eye(4)
    Tcw[:3, 3] = Tc
    mask = rng.random(len(pts)) < 0.8
    for kw in (dict(iterations=80, seed=1), dict(min_obs_mask=mask, iterations=30, seed=3)):
        a, b = tar.detect_plane(pts, Tcw, **kw), jar.detect_plane(pts, Tcw, **kw)
        for f in jar.Plane._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert tar.detect_plane(pts[:10], Tcw) is None and jar.detect_plane(pts[:10], Tcw) is None
    np.testing.assert_array_equal(tar.cube_corners(0.4), jar.cube_corners(0.4))
    plane = jar.detect_plane(pts, Tcw, iterations=80, seed=1)
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    for args in ((img, plane, Tcw, 0.4, 300.0, 300.0, 160.0, 120.0),
                 (np.stack([img] * 3, -1), plane, Tcw, 1.5, 300.0, 310.0, 150.0, 110.0, 7.0)):
        np.testing.assert_array_equal(tar.draw_cube(*args), jar.draw_cube(*args))
    X = rng.uniform(-2, 2, (50, 3)) + [0, 0, 5]
    for a, b in zip(tar.project_points(X, Tcw, 300, 300, 160, 120),
                    jar.project_points(X, Tcw, 300, 300, 160, 120)):
        np.testing.assert_array_equal(a, b)
    seg = [np.zeros((30, 40)), (-5.0, 3.0), (45.0, 20.5)]
    np.testing.assert_array_equal(tar.draw_segment(seg[0].copy(), *seg[1:]),
                                  jar.draw_segment(seg[0].copy(), *seg[1:]))


@pytest.fixture(scope="module")
def run():
    return small_run()


def _scatter_counts(monkeypatch, fn, *args, **kw):
    """The number of points of each scatter call while fn draws."""
    from mpl_toolkits.mplot3d import Axes3D
    counts, scatter = [], Axes3D.scatter

    def record(self, xs, *a, **k):
        counts.append(len(xs))
        return scatter(self, xs, *a, **k)
    monkeypatch.setattr(Axes3D, "scatter", record)
    fn(*args, **kw)
    monkeypatch.setattr(Axes3D, "scatter", scatter)
    return counts


def test_plot_map_and_draw_frame(run, tmp_path, monkeypatch):
    s, _, images = run
    jm = jmap.MapState(**{k: jnp.asarray(v) for k, v in convert.mapstate_to_numpy(s.m).items()})
    traj = s.get_trajectory()
    got = _scatter_counts(monkeypatch, tviewer.plot_map, s.m, traj, path=str(tmp_path / "t.png"),
                          title="port")
    want = _scatter_counts(monkeypatch, jviewer.plot_map, jm, traj, path=str(tmp_path / "j.png"))
    assert got == want == [int(s.m.n_points), int(s.m.n_keyframes)]
    assert os.path.getsize(tmp_path / "t.png") > 1000
    f = s.last_frame
    for matched in (None, s.last_matched_pt >= 0):
        p = tviewer.draw_frame(images[0][0], f, matched_mask=matched,
                               path=str(tmp_path / "f.png"), status=s.get_map_stats())
        assert os.path.getsize(p) > 1000
    assert s.draw_current_frame(images[0][0], path=str(tmp_path / "cur.png")) == \
        str(tmp_path / "cur.png")
    assert os.path.getsize(tmp_path / "cur.png") > 1000


def test_live_viewer(run, tmp_path):
    s, _, images = run
    live = tviewer.LiveViewer(s, out_dir=str(tmp_path), fps=20.0, interactive=False)
    live.update(images[1][0])
    deadline = time.time() + 60
    while live.n_renders < 1 and time.time() < deadline:
        time.sleep(0.05)
    live.join()
    assert live.n_renders >= 1
    for name in ("frame_live.png", "map_live.png"):
        assert os.path.getsize(tmp_path / name) > 1000


def test_ar_demo(tmp_path):
    """The AR example on its synthetic plane: a plane found once tracking is
    stable (frame 5 on), the cube drawn on every frame after."""
    from orb_slam2_tpu_torch.examples import ar_demo
    plane, written = ar_demo.main(["--frames", "9", "--out", str(tmp_path), "--cpu"])
    assert plane is not None and abs(abs(plane.normal[2]) - 1.0) < 0.05
    assert len(written) >= 3 and all(os.path.getsize(p) > 1000 for p in written)
