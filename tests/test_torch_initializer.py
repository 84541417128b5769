"""The port's two-view initializer (`solvers/initializer.py`) against the
JAX reference's on tests/test_initializer.py's scenes, on the CPU, with the
reference's RANSAC draws (`jax.random.randint(PRNGKey(0), (200, 8), 0,
n_valid)`, its default key) handed to the port as `draws`.

Required: the same success and the same model (homography or fundamental);
where it succeeds, R21 and t21 within 1e-4 per entry and the triangulation
mask `good` equal on >= 99 % of the rows. The SVDs are LAPACK's in both
packages but not the same routine, so singular vectors may differ in sign
and in the last bits: H and F scores do not depend on either, and the
candidates may come out in another order, so the chosen (R, t) is compared,
never a candidate index. The 30-point scene of the triangulation test also
holds the port's DLT against the reference's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geometry import se3 as jse3
from orb_slam2_tpu.geometry import triangulation as jtri
from orb_slam2_tpu.solvers import initializer as jinit

from orb_slam2_tpu_torch.geometry import triangulation as ttri
from orb_slam2_tpu_torch.solvers import initializer as tinit

from test_initializer import CX, CY, FX, FY, make_general_scene, make_planar_scene, project

torch.set_num_threads(2)
POSE_TOL = 1e-4
GOOD_FLOOR = 0.99


def _padded(p1, p2, n, pad_to=256):
    pp1 = np.zeros((pad_to, 2), np.float32)
    pp2 = np.zeros((pad_to, 2), np.float32)
    pp1[:n], pp2[:n] = p1, p2
    valid = np.zeros(pad_to, bool)
    valid[:n] = True
    return pp1, pp2, valid


def _exact(rng):
    X = np.stack([rng.uniform(-2, 2, 30), rng.uniform(-2, 2, 30), rng.uniform(3, 9, 30)], axis=-1)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.05, -0.02, 0.03])))
    t = np.array([0.5, 0.1, -0.05])
    p1, _ = project(X)
    p2, _ = project(X, R, t)
    return _padded(p1, p2, 30)


def _noiseless(rng):
    return make_general_scene(rng)[:3]


def _planar(rng):
    return make_planar_scene(rng)[:3]


def _noise_and_outliers(rng):
    p1, p2, valid, _, _, _ = make_general_scene(rng, n=200)
    p2 = p2.copy()
    p2[valid.nonzero()[0]] += rng.normal(0, 0.5, size=(200, 2))
    out = rng.choice(200, 30, replace=False)
    p2[out] += rng.uniform(30, 100, size=(30, 2))
    return p1, p2, valid


def _pure_rotation(rng):
    n = 150
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], axis=-1)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.02, -0.03, 0.01])))
    p1, _ = project(X)
    p2, _ = project(X, R, np.zeros(3))
    return _padded(p1, p2, n)


def _too_few(rng):
    return make_general_scene(rng, n=30)[:3]


SCENES = {"exact": (_exact, False), "noiseless": (_noiseless, True), "planar": (_planar, True),
          "noise_and_outliers": (_noise_and_outliers, True),
          "pure_rotation": (_pure_rotation, False), "too_few": (_too_few, False)}


def jax_draws(valid, key=0):
    """The reference initializer's RANSAC sets for PRNGKey(key)."""
    n_valid = int(np.sum(valid))
    return np.array(jax.random.randint(jax.random.PRNGKey(key), (jinit.RANSAC_ITERS, 8), 0,
                                       max(n_valid, 1)))


def assert_same_init(got, want, what=""):
    """The port's InitResult against the reference's (see the module
    docstring)."""
    assert bool(got.success) == bool(want.success), what
    assert bool(got.used_homography) == bool(want.used_homography), what
    if not bool(want.success):
        return
    np.testing.assert_allclose(got.R21.cpu().numpy(), np.asarray(want.R21), atol=POSE_TOL,
                               err_msg=what)
    np.testing.assert_allclose(got.t21.cpu().numpy(), np.asarray(want.t21), atol=POSE_TOL,
                               err_msg=what)
    same = (got.good.cpu().numpy() == np.asarray(want.good)).mean()
    assert same >= GOOD_FLOOR, (what, same)


@pytest.mark.parametrize("scene", list(SCENES))
def test_initialize_matches_reference(scene, rng):
    make, succeeds = SCENES[scene]
    p1, p2, valid = make(rng)
    want = jinit.initialize(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), FX, FY, CX, CY)
    got = tinit.initialize(torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid),
                           FX, FY, CX, CY, draws=torch.from_numpy(jax_draws(valid)))
    assert bool(want.success) == succeeds
    assert_same_init(got, want, scene)
    if scene == "exact":
        # the DLT of both packages on the 30 exact correspondences
        R = np.asarray(jse3.so3_exp(jnp.asarray([0.05, -0.02, 0.03])))
        t = np.array([0.5, 0.1, -0.05])
        K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
        P1 = (K @ np.hstack([np.eye(3), np.zeros((3, 1))])).astype(np.float32)
        P2 = (K @ np.hstack([R, t[:, None]])).astype(np.float32)
        Xj = np.asarray(jtri.triangulate(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(p1[:30]),
                                         jnp.asarray(p2[:30])))
        Xt = ttri.triangulate(torch.from_numpy(P1), torch.from_numpy(P2),
                              torch.from_numpy(p1[:30]), torch.from_numpy(p2[:30])).numpy()
        np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-4)


def test_generator_draws_in_range(rng):
    """The default draws (a CPU generator) index only the valid matches,
    and a seed repeats the run."""
    p1, p2, valid = _noiseless(rng)
    args = (torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid), FX, FY, CX, CY)
    a = tinit.initialize(*args, generator=torch.Generator().manual_seed(3))
    b = tinit.initialize(*args, generator=torch.Generator().manual_seed(3))
    assert bool(a.success) and not bool(a.used_homography)
    assert torch.equal(a.R21, b.R21) and torch.equal(a.good, b.good)
    assert not bool(a.good[~torch.from_numpy(valid)].any())
