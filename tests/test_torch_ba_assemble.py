"""The twin of the fused local-BA assembly K9 (`ops/cuda_ba.ba_assemble_plain`)
on the CPU: against the JAX reference's two assemblies, on the cases its
fixed-order sums must keep (padded edges, empty cameras), and against a
numpy model of the kernel's summation order (`csrc/ba_edge.cu`).

Tolerances, and why:
- against the reference's `_assemble` (XLA) and `_assemble_pallas`
  (interpret mode): rtol 3e-4, atol 2e-2 on Hcc, bc, Hpp, bp, We and err,
  the reference's own tolerance between its two paths
  (`tests/test_pallas_kernels.py:206-210`); pt_on equal; depth_ok equal
  and chi2 within rtol 1e-3, atol 1e-2 on real edges in front of the
  camera (the same bounds as `tests/test_torch_schur_ba.py`);
- a camera with no edge: Hcc and bc exactly zero; a padded edge (camera -1,
  here with mask 1 so that its terms are not zero): no camera's sums
  change, held against float64 sums of the real edges' per-edge rows at
  rtol 1e-5 of each block's magnitude (float32 sums of a few hundred terms);
- the numpy model repeats the kernel's order (points' O edges in order,
  each camera's chunks of BA_CHUNK edges as BA_THREADS strided threads and a
  halving tree, chunks in order, err likewise) in float32: equal bit for
  bit;
- `solve_ba` with three empty camera slots and padded edges: the
  tolerances of `tests/test_torch_schur_ba.py::test_solve_ba_matches`.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import pallas_kernels as pk
from orb_slam2_tpu.solvers import schur_ba as jba

from orb_slam2_tpu_torch.geometry import camera as tcamera
from orb_slam2_tpu_torch.geometry import se3
from orb_slam2_tpu_torch.ops import cuda_ba, launch
from orb_slam2_tpu_torch.solvers import schur_ba as tba
from orb_slam2_tpu_torch.utils import convert

sys.path.insert(0, os.path.dirname(__file__))
from test_schur_ba import LEVEL_SIGMA2, make_ba_scene  # noqa: E402

torch.set_num_threads(1)


def _scene(stereo: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    cam, prob, *_ = make_ba_scene(rng, noise=0.5, perturb=0.05, stereo=stereo)
    pts = np.asarray(prob.points).copy()
    pts[:4, 2] = -2.0                  # behind the cameras: the invz guard
    prob = prob._replace(points=jnp.asarray(pts))
    tcam = tcamera.Camera.make(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                               bf=float(cam.bf), device="cpu")
    return cam, prob, tcam, convert.ba_problem_from_numpy(prob, device="cpu")


def _inv_sigma2(obs_level):
    s2 = np.asarray(LEVEL_SIGMA2, np.float32)
    return torch.from_numpy((np.float32(1.0) / s2[np.clip(np.asarray(obs_level), 0, 7)])
                            .astype(np.float32))


def _lin(tcam, tprob, mask, robust):
    edges = tba._edges(tprob, _inv_sigma2(tprob.obs_level))
    out = cuda_ba.ba_assemble_plain(tcam, tprob.poses, tprob.points, tprob.pt_valid, edges,
                                    mask, robust)
    return tba.Lin(*out), edges


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("stereo", [False, True])
def test_twin_matches_both_reference_assemblies(robust, stereo, monkeypatch):
    orig = pk.ba_edge_terms_pallas
    monkeypatch.setattr(pk, "ba_edge_terms_pallas", lambda *a, **k: orig(*a, interpret=True, **k))
    cam, prob, tcam, tprob = _scene(stereo)
    inv_s2 = 1.0 / jnp.asarray(LEVEL_SIGMA2, jnp.float32)[jnp.clip(prob.obs_level, 0, 7)]
    base = (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    maskf = base.astype(jnp.float32)
    onehot = jba._onehot_cam(prob, prob.poses.shape[0])
    refs = (jba._assemble(cam, prob, prob.poses, prob.points, inv_s2, maskf, robust, False,
                          onehot),
            jba._assemble_pallas(cam, prob, prob.poses, prob.points, inv_s2, maskf, robust,
                                 onehot))
    got, _ = _lin(tcam, tprob, torch.from_numpy(np.array(maskf)), robust)
    b = np.asarray(base)
    assert b.sum() > 400
    for want in refs:
        for name in ("Hcc", "bc", "Hpp", "bp", "We", "err"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                       rtol=3e-4, atol=2e-2, err_msg=name)
        np.testing.assert_array_equal(got.pt_on.numpy(), np.asarray(want.pt_on))
        np.testing.assert_array_equal(got.depth_ok.numpy()[b], np.asarray(want.depth_ok)[b])
        ok = np.asarray(want.depth_ok) & b
        np.testing.assert_allclose(got.chi2.numpy()[ok], np.asarray(want.chi2)[ok], rtol=1e-3,
                                   atol=1e-2)


def test_padded_edges_join_no_camera_and_empty_cameras_are_zero():
    _, prob, tcam, tprob = _scene(False)
    oc = np.asarray(prob.obs_cam)
    C = np.asarray(prob.poses).shape[0]
    empty = [c for c in range(C) if not (oc == c).any()]
    assert empty and (oc < 0).sum() > 100           # slots 6, 7 and padded edges
    mask = torch.ones(oc.shape, dtype=torch.float32)     # padded edges weighted too
    launch.reset_launches()
    got, edges = _lin(tcam, tprob, mask, True)
    assert not any(launch.LAUNCHES.values())
    for c in empty:
        assert not got.Hcc[c].any() and not got.bc[c].any()
    # the padded edges' own terms are not zero (camera 0's pose, mask 1) ...
    rows = cuda_ba.ba_edge_terms_plain(
        tcam, torch.cat([tprob.poses[:, :3, :3].reshape(C, 9), tprob.poses[:, :3, 3]],
                        1).index_select(0, edges.cam.long()).T,
        tprob.points.repeat_interleave(oc.shape[1], 0).T, edges.obs, edges.inv_sigma2,
        edges.stereo, mask.reshape(-1), True).double().numpy()
    pad = oc.reshape(-1) < 0
    assert np.abs(rows[cuda_ba.BA_ROW_HCC, pad]).max() > 0
    # ... but each camera's sums hold its real edges only
    for c in range(C):
        on = oc.reshape(-1) == c
        hcc = rows[cuda_ba.BA_ROW_HCC:cuda_ba.BA_ROW_W, on].sum(1)
        bc = rows[cuda_ba.BA_ROW_BC:cuda_ba.BA_ROW_BP, on].sum(1)
        full = hcc[cuda_ba.symmetric_index(6, "cpu").reshape(-1).numpy()].reshape(6, 6)
        scale = max(np.abs(full).max(), 1e-30)
        np.testing.assert_allclose(got.Hcc[c].numpy(), full, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(got.bc[c].numpy(), bc, rtol=0,
                                   atol=1e-5 * max(np.abs(bc).max(), 1e-30))


def _synthetic(seed, q, o, n_cams, C, robust):
    """A problem with several chunks per camera: q points each seen by o
    random slots of n_cams cameras (10 % padded), camera slots n_cams.. C-1
    empty, 5 % of the edges masked, a third stereo."""
    rng = np.random.default_rng(seed)
    T = se3.exp(torch.from_numpy(rng.normal(0, 0.05, (C, 6)).astype(np.float32)))
    X = np.stack([rng.uniform(-3, 3, q), rng.uniform(-2, 2, q), rng.uniform(4, 15, q)],
                 -1).astype(np.float32)
    X[:5, 2] = -1.0
    obs_cam = rng.integers(0, n_cams, (q, o)).astype(np.int32)
    obs_cam[rng.random((q, o)) < 0.1] = -1
    uvr = np.stack([rng.uniform(0, 640, (q, o)), rng.uniform(0, 480, (q, o)),
                    np.where(rng.random((q, o)) < 0.33, rng.uniform(0, 640, (q, o)), -1.0)],
                   -1).astype(np.float32)
    prob = tba.BAProblem(poses=T, cam_valid=torch.ones(C, dtype=torch.bool),
                         cam_fixed=torch.zeros(C, dtype=torch.bool),
                         points=torch.from_numpy(X), pt_valid=torch.ones(q, dtype=torch.bool),
                         obs_cam=torch.from_numpy(obs_cam), obs_uvr=torch.from_numpy(uvr),
                         obs_level=torch.from_numpy(rng.integers(0, 8, (q, o)).astype(np.int32)))
    mask = torch.from_numpy((rng.random((q, o)) > 0.05).astype(np.float32))
    cam = tcamera.Camera.make(517.3, 517.3, 320.0, 240.0, bf=129.3, device="cpu")
    return cam, prob, mask


def _kernel_order_model(rows, edges, Q, O, C):
    """numpy float32 model of `csrc/ba_edge.cu`'s sums from the per-edge rows
    (64, E). Returns Hcc (C,21), bc (C,6), Hpp (Q,6), bp (Q,3), err."""
    nt, k = cuda_ba.BA_THREADS, cuda_ba.BA_CHUNK
    rows = rows.astype(np.float32)
    pt = np.concatenate([rows[cuda_ba.BA_ROW_HPP:cuda_ba.BA_ROW_BC],
                         rows[cuda_ba.BA_ROW_BP:cuda_ba.BA_ROW_ERR + 1]]).reshape(10, Q, O)
    acc = np.zeros((10, Q), np.float32)
    for o in range(O):                               # a point's edges in order
        acc = acc + pt[:, :, o]
    cam_rows = np.concatenate([rows[cuda_ba.BA_ROW_HCC:cuda_ba.BA_ROW_W],
                               rows[cuda_ba.BA_ROW_BC:cuda_ba.BA_ROW_BP]])
    order, start = edges.order.numpy(), edges.cam_start.numpy()

    def tree(x):                                     # (V, nt) -> (V,)
        n = nt
        while n > 1:
            n //= 2
            x = x[:, :n] + x[:, n:2 * n]
        return x[:, 0]

    tot = np.zeros((C, 27), np.float32)
    n_multi = 0
    for c in range(C):
        chunks = range(start[c], start[c + 1], k)
        n_multi += len(chunks) > 1
        for pos0 in chunks:                          # the camera's chunks in order
            pos1 = min(pos0 + k, start[c + 1])
            x = np.zeros((27, nt), np.float32)
            for t in range(nt):                      # thread t: t, t + nt, ...
                for pos in range(pos0 + t, pos1, nt):
                    x[:, t] = x[:, t] + cam_rows[:, order[pos]]
            tot[c] = tot[c] + tree(x)
    assert n_multi > 0, "no camera spans two chunks"
    x = np.zeros((1, nt), np.float32)
    for t in range(nt):
        for q in range(t, Q, nt):
            x[0, t] = x[0, t] + acc[9, q]
    return tot[:, :21], tot[:, 21:], acc[:6].T, acc[6:9].T, tree(x)[0]


@pytest.mark.parametrize("seed,q,o,C,robust", [(0, 700, 3, 5, True), (1, 1100, 2, 5, False),
                                               (2, 700, 3, 512, True)])
def test_numpy_model_of_kernel_order_equals_twin(seed, q, o, C, robust):
    """5 camera slots, and 512 (global BA's C at the default `max_keyframes`:
    the kernel takes any C)."""
    cam, prob, mask = _synthetic(seed, q, o, 3, C, robust)
    got, edges = _lin(cam, prob, mask, robust)
    rows = cuda_ba.ba_edge_terms_plain(
        cam, torch.cat([prob.poses[:, :3, :3].reshape(C, 9), prob.poses[:, :3, 3]],
                       1).index_select(0, edges.cam.long()).T,
        prob.points.repeat_interleave(o, 0).T, edges.obs, edges.inv_sigma2, edges.stereo,
        mask.reshape(-1), robust).numpy()
    hcc, bc, hpp, bp, err = _kernel_order_model(rows, edges, q, o, C)
    i6, j6 = zip(*cuda_ba.TRI6)
    i3, j3 = zip(*cuda_ba.TRI3)
    np.testing.assert_array_equal(got.Hcc.numpy()[:, i6, j6], hcc)
    np.testing.assert_array_equal(got.Hcc.numpy()[:, j6, i6], hcc)
    np.testing.assert_array_equal(got.bc.numpy(), bc)
    np.testing.assert_array_equal(got.Hpp.numpy()[:, i3, j3], hpp)
    np.testing.assert_array_equal(got.Hpp.numpy()[:, j3, i3], hpp)
    np.testing.assert_array_equal(got.bp.numpy(), bp)
    assert got.err.numpy() == err
    np.testing.assert_array_equal(
        got.We.numpy(), rows[cuda_ba.BA_ROW_W:cuda_ba.BA_ROW_HPP].T.reshape(q, o, 6, 3))
    assert not got.Hcc[3:].any() and not got.bc[3:].any()     # slots with no edge


def test_solve_ba_with_empty_slots_and_padded_edges_matches():
    """5 cameras in 8 slots, stereo, noiseless observations: both packages
    converge to the scene (with 0.5 px of noise the two part by up to 2.3
    cm on a point of this scene after 15 float32 LM iterations)."""
    rng = np.random.default_rng(5)
    cam, prob, *_ = make_ba_scene(rng, n_cams=5, C=8, noise=0.0, perturb=0.03, stereo=True)
    tcam = tcamera.Camera.make(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                               bf=float(cam.bf), device="cpu")
    assert (np.asarray(prob.obs_cam) < 0).any()
    want = jba.solve_ba(cam, prob, LEVEL_SIGMA2)
    got = convert.ba_result_to_numpy(
        tba.solve_ba(tcam, convert.ba_problem_from_numpy(prob, device="cpu"), LEVEL_SIGMA2))
    np.testing.assert_allclose(got["poses"], np.asarray(want.poses), rtol=0, atol=5e-4)
    np.testing.assert_allclose(got["points"], np.asarray(want.points), rtol=0, atol=5e-3)
    np.testing.assert_array_equal(got["edge_inlier"], np.asarray(want.edge_inlier))
