"""The plain reference on small problems whose answers are known: noise-free
observations bring the drifted map back to the truth; the Jacobians are the
residuals' derivatives; the two solvers agree; TF32 rounding is exact."""
import dataclasses
import math

import pytest
import torch

from slambench.harness import mapgen, reference as ref, spec
from slambench.tests.small import load_config, small_config

BENCH = spec.Bench()


def _clean(name, seed, solver=None):
    """A small map with no pixel noise and no outliers, its problem in
    float64."""
    d = small_config(load_config(name))
    if solver:
        d["global_ba"] = {"solver": solver, "cg_iters": 400}
    tr = dict(BENCH.traffic("global-ba"), pixel_sigma=0.0, outlier_share=0.0)
    a = mapgen.synthesize(d, tr, seed, "cpu")
    return d, a, ref.problem(a, d, ref.Arith("float64"))


@pytest.mark.parametrize("solver", ["pcg", "dense"])
def test_noise_free_map_returns_to_truth(solver):
    d, a, pb = _clean("kitti-stereo", 21, solver)
    pb = dataclasses.replace(pb, chunks=3, iters=10)
    R, t, X = ref.global_ba(pb, ref.Arith("float64"))
    ev = ref.evaluate(pb, R, t, X)
    ev0 = ref.evaluate(pb, pb.R, pb.t, pb.X)
    assert ev0["total"] > 1e3
    assert ev["total"] < 1e-6 * ev0["total"]
    assert bool(ev["inlier"].all())
    # the gauge is the fixed keyframe's: the map comes back to the true one,
    # within what float32 inputs (the map's) leave: 1e-5 of the distance
    # driven
    Twc = a.Twc_true[pb.cam_free]
    c = a.Twc_true[a.kf_valid][:, :3, 3]
    tol = 1e-5 * float((c[1:] - c[:-1]).norm(dim=1).sum())
    centres = ev["centres"][pb.cam_free]
    assert float((centres - Twc[:, :3, 3]).norm(dim=1).max()) < tol
    err = (X[a.pt_valid] - a.points_true[a.pt_valid]).norm(dim=1)
    assert float(err.median()) < tol


def test_jacobians_are_the_residuals_derivatives():
    _, _, pb = _clean("kitti-stereo", 4)
    ar = ref.Arith("float64")
    pb = dataclasses.replace(pb, pt_valid=pb.pt_valid.clone())
    lin = ref.linearize(pb, ar, pb.R, pb.t, pb.X)
    _, r0, _, _ = ref.residuals(pb, ar, pb.R, pb.t, pb.X)
    # g = J^T W r summed over a camera's edges; check H and b by central
    # differences of the weighted error along a camera's tangent direction
    c = int(torch.nonzero(pb.cam_free)[3, 0])
    xi = torch.zeros((pb.R.shape[0], 6), dtype=torch.float64)
    h = 1e-6

    def err(s):
        xi[c] = s
        R2, t2 = ref.retract(ar, pb.R, pb.t, xi)
        _, r, chi2, _ = ref.residuals(pb, ar, R2, t2, pb.X)
        return 0.5 * float(chi2.sum())

    for k in range(6):
        e = torch.zeros(6, dtype=torch.float64)
        e[k] = h
        grad = (err(e) - err(-e)) / (2 * h)
        # b = -J^T W r = -gradient of half the weighted error
        assert grad == pytest.approx(-float(lin.bc[c, k]), rel=1e-4, abs=1e-6)


def test_dense_and_pcg_agree_when_cg_converges():
    d, a, pb = _clean("kitti-stereo", 8, "dense")
    ar = ref.Arith("float64")
    lin = ref.linearize(pb, ar, pb.R, pb.t, pb.X)
    dense = ref.solve_dense(pb, ar, lin, 1e-4)
    pcg = ref.solve_pcg(dataclasses.replace(pb, cg_iters=400), ar, lin, 1e-4)
    scale = float(dense[0].abs().max())
    assert float((dense[0] - pcg[0]).abs().max()) < 1e-6 * scale
    assert float((dense[1] - pcg[1]).abs().max()) < 1e-6 * float(dense[1].abs().max())


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, -(1.0 + 3 * 2 ** -11), 3.0e-3], dtype=torch.float32)
    got = ref.round_tf32(x)
    want = [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0, -(1.0 + 2 ** -9)]
    assert got[:6].tolist() == want                   # ties to even, both signs
    m, e = math.frexp(float(got[6]))
    assert abs(float(got[6]) - 3.0e-3) <= 2 ** (e - 12) and (m * 2 ** 11) % 1 == 0


def test_gaps_of_a_state_with_itself_are_zero_and_of_a_moved_one_are_not():
    _, _, pb = _clean("kitti-stereo", 5)
    a = ref.evaluate(pb, pb.R, pb.t, pb.X)
    g = ref.gaps(pb, a, a)
    assert all(v == 0 for v in g.values())
    t2 = pb.t.clone()
    c = int(torch.nonzero(pb.cam_free)[0, 0])
    t2[c, 0] += 0.01
    g = ref.gaps(pb, ref.evaluate(pb, pb.R, t2, pb.X), a)
    assert g["pose_gap_m"] == pytest.approx(0.01, rel=1e-6)
    assert g["reproj_gap_px"] > 0 and g["rot_gap_rad"] == 0
