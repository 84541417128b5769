"""The port's Schur-complement BA (`orb_slam2_tpu_torch/solvers/schur_ba.py`)
and the twin of its edge kernel K9 (`ops/cuda_ba.ba_edge_terms_plain`)
against the JAX reference on the CPU, on the reference's own BA scenes
(`tests/test_schur_ba.make_ba_scene`: 6 cameras, 120 points, C=8, Q=160,
O=8).

Tolerances, and why:
- K9's twin against the reference kernel `ba_edge_terms_pallas` (interpret
  mode) on the same (12,E) inputs: each block of rows (Hcc, W, Hpp, bc,
  bp) within 1e-4 of the block's largest magnitude (both are float32
  per-edge arithmetic, which XLA may contract into FMAs; entries reach 1e8,
  and an entry that is zero edge by edge, such as Hcc[2][5] with fx = fy,
  holds only rounding noise, so a fixed or per-row tolerance is
  meaningless there); chi2 within rtol 1e-4 (it reaches 1e25 behind a
  camera) and depth_ok exact, both on real edges only (a padded edge sees
  camera 0's pose here and a zero pose there);
- the assembly (Hcc, bc, Hpp, bp, We, err) against both reference
  assemblies, XLA and Pallas: rtol 3e-4, atol 2e-2, the reference's own
  tolerance between its two paths (`tests/test_pallas_kernels.py:206-210`);
  pt_on equal; depth_ok equal and chi2 within rtol 1e-3, atol 1e-2 on real
  edges in front of the camera;
- `solve_ba`: poses within 5e-4 and points (6-14 m away) within 5e-3 m of
  the reference's, the inlier classification equal: 15 LM iterations of
  float32 solves in another summation order, on a scene with 0.5 px noise
  that the reference's short schedule leaves semi-converged (measured:
  1.8e-4 and 1.2e-3 on the stereo scene, 8e-6 and 3.5e-4 on the mono one);
- a NaN-poisoned point: err is NaN from the first pass, so both packages
  reject every step and return the input poses and points bit for bit.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import pallas_kernels as pk
from orb_slam2_tpu.solvers import reproj as jreproj
from orb_slam2_tpu.solvers import schur_ba as jba

from orb_slam2_tpu_torch.geometry import camera as tcamera
from orb_slam2_tpu_torch.ops import cuda_ba
from orb_slam2_tpu_torch.solvers import schur_ba as tba
from orb_slam2_tpu_torch.utils import convert

sys.path.insert(0, os.path.dirname(__file__))
from test_schur_ba import LEVEL_SIGMA2, make_ba_scene  # noqa: E402

torch.set_num_threads(1)
# the (64,E) rows by block: Hcc, W, Hpp, bc, bp
BLOCKS = ((cuda_ba.BA_ROW_HCC, cuda_ba.BA_ROW_W), (cuda_ba.BA_ROW_W, cuda_ba.BA_ROW_HPP),
          (cuda_ba.BA_ROW_HPP, cuda_ba.BA_ROW_BC), (cuda_ba.BA_ROW_BC, cuda_ba.BA_ROW_BP),
          (cuda_ba.BA_ROW_BP, cuda_ba.BA_ROW_ERR))


def _scenes(behind: bool, stereo: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    cam, prob, *_ = make_ba_scene(rng, noise=0.5, perturb=0.05, stereo=stereo)
    if behind:          # points behind cameras exercise the invz guard
        pts = np.asarray(prob.points).copy()
        pts[:4, 2] = -2.0
        prob = prob._replace(points=jnp.asarray(pts))
    tcam = tcamera.Camera.make(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                               bf=float(cam.bf), device="cpu")
    return cam, prob, tcam, convert.ba_problem_from_numpy(prob, device="cpu")


def _inputs(prob, tprob):
    sigma2 = jnp.asarray(LEVEL_SIGMA2, jnp.float32)
    inv_s2 = 1.0 / sigma2[jnp.clip(prob.obs_level, 0, 7)]
    base = (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    edges = tba._edges(tprob, torch.from_numpy(np.array(inv_s2)))
    return inv_s2, base, edges


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("stereo", [False, True])
def test_edge_rows_match_reference_kernel(robust, stereo):
    cam, prob, tcam, tprob = _scenes(True, stereo)
    inv_s2, base, edges = _inputs(prob, tprob)
    maskf = base.astype(jnp.float32)
    C = prob.poses.shape[0]
    Q, O = prob.obs_cam.shape
    E = Q * O
    ci = np.clip(np.asarray(prob.obs_cam), 0, C - 1).reshape(-1)
    poses = np.asarray(prob.poses)
    rows = np.concatenate([poses[:, :3, :3].reshape(C, 9), poses[:, :3, 3]], 1)[ci].T
    Xw = np.broadcast_to(np.asarray(prob.points)[:, None], (Q, O, 3)).reshape(E, 3).T
    obs = np.asarray(prob.obs_uvr).reshape(E, 3).T
    st = (np.asarray(prob.obs_uvr)[..., 2] >= 0).reshape(E).astype(np.float32)
    args = [np.array(a, np.float32) for a in
            (rows, Xw, obs, np.asarray(inv_s2).reshape(E), st, np.asarray(maskf).reshape(E))]
    got = cuda_ba.ba_edge_terms_plain(tcam, *[torch.from_numpy(a) for a in args], robust)
    want = np.asarray(pk.ba_edge_terms_pallas(
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, args[0], args[1], args[2], args[3][None],
        args[4][None], args[5][None], jnp.float32(jreproj.CHI2_MONO),
        jnp.float32(jreproj.CHI2_STEREO), robust=robust, interpret=True))
    got = got.numpy()
    real = np.asarray(base).reshape(E)
    assert real.sum() > 400 and (want[cuda_ba.BA_ROW_DEPTH][real] == 0).sum() > 0
    for lo, hi in BLOCKS:
        scale = max(float(np.abs(want[lo:hi]).max()), 1e-30)
        np.testing.assert_allclose(got[lo:hi], want[lo:hi], rtol=0, atol=1e-4 * scale,
                                   err_msg=f"rows {lo}-{hi - 1}")
    for r in (cuda_ba.BA_ROW_CHI2, cuda_ba.BA_ROW_DEPTH):
        np.testing.assert_allclose(got[r][real], want[r][real], rtol=1e-4, atol=0,
                                   err_msg=f"row {r}")
    np.testing.assert_allclose(got[cuda_ba.BA_ROW_ERR], want[cuda_ba.BA_ROW_ERR], rtol=1e-4)
    assert not got[57:].any()


@pytest.mark.parametrize("robust", [True, False])
def test_assembly_matches_both_reference_paths(robust, monkeypatch):
    orig = pk.ba_edge_terms_pallas
    monkeypatch.setattr(pk, "ba_edge_terms_pallas", lambda *a, **k: orig(*a, interpret=True, **k))
    cam, prob, tcam, tprob = _scenes(True, False)
    inv_s2, base, edges = _inputs(prob, tprob)
    maskf = base.astype(jnp.float32)
    C = prob.poses.shape[0]
    onehot = jba._onehot_cam(prob, C)
    refs = (jba._assemble(cam, prob, prob.poses, prob.points, inv_s2, maskf, robust, False,
                          onehot),
            jba._assemble_pallas(cam, prob, prob.poses, prob.points, inv_s2, maskf, robust,
                                 onehot))
    got = tba._assemble(tcam, tprob, edges, tprob.poses, tprob.points,
                        torch.from_numpy(np.array(maskf)), robust)
    b = np.asarray(base)
    for want in refs:
        for name in ("Hcc", "bc", "Hpp", "bp", "We", "err"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                       rtol=3e-4, atol=2e-2, err_msg=name)
        np.testing.assert_array_equal(got.pt_on.numpy(), np.asarray(want.pt_on))
        np.testing.assert_array_equal(got.depth_ok.numpy()[b], np.asarray(want.depth_ok)[b])
        ok = np.asarray(want.depth_ok) & b
        np.testing.assert_allclose(got.chi2.numpy()[ok], np.asarray(want.chi2)[ok], rtol=1e-3,
                                   atol=1e-2)


@pytest.mark.parametrize("stereo", [False, True])
def test_solve_ba_matches(stereo):
    rng = np.random.default_rng(3)
    cam, prob, poses_true, X_true, nc, npts = make_ba_scene(rng, noise=0.5, perturb=0.03,
                                                            stereo=stereo)
    uvr = np.asarray(prob.obs_uvr).copy()     # a few gross outliers to classify out
    uvr[5:8, 0, :2] += 60.0
    prob = prob._replace(obs_uvr=jnp.asarray(uvr))
    tcam = tcamera.Camera.make(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                               bf=float(cam.bf), device="cpu")
    want = jba.solve_ba(cam, prob, LEVEL_SIGMA2)
    got = tba.solve_ba(tcam, convert.ba_problem_from_numpy(prob, device="cpu"), LEVEL_SIGMA2)
    back = convert.ba_result_to_numpy(got)
    np.testing.assert_allclose(back["poses"], np.asarray(want.poses), rtol=0, atol=5e-4)
    np.testing.assert_allclose(back["points"], np.asarray(want.points), rtol=0, atol=5e-3)
    np.testing.assert_array_equal(back["edge_inlier"], np.asarray(want.edge_inlier))
    assert not back["edge_inlier"][5:8, 0].any()
    np.testing.assert_array_equal(back["poses"][:2], np.asarray(prob.poses)[:2])   # fixed
    # the conversion round trip
    for name, a in convert.ba_problem_to_numpy(
            convert.ba_problem_from_numpy(prob, device="cpu")).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(prob, name)), err_msg=name)


def test_nan_point_rejects_every_step():
    cam, prob, tcam, _ = _scenes(False, False, seed=1)
    pts = np.asarray(prob.points).copy()
    pts[7] = np.nan
    prob = prob._replace(points=jnp.asarray(pts))
    tprob = convert.ba_problem_from_numpy(prob, device="cpu")
    want = jba.solve_ba(cam, prob, LEVEL_SIGMA2)
    got = tba.solve_ba(tcam, tprob, LEVEL_SIGMA2)
    for res in (want, got):
        np.testing.assert_array_equal(np.asarray(res.poses), np.asarray(prob.poses))
        np.testing.assert_array_equal(np.asarray(res.points), pts)
    inv_s2, base, edges = _inputs(prob, tprob)
    lin = tba._assemble(tcam, tprob, edges, tprob.poses, tprob.points,
                        torch.from_numpy(np.array(base, np.float32)), True)
    assert torch.isnan(lin.err)
