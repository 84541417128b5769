"""The port's stereo rectification maps (`geometry/rectify.py`, NumPy
copied whole) and grayscale conversion (`ops/image.rgb_to_gray`) against
the JAX reference's on the CPU: the maps and the remap bit for bit (the
same NumPy code), the rectifier built from a reference-format settings
YAML equal on both sides, and the gray image within 1e-4 (one float32 ulp
at 255 is 1.5e-5; the two weighted sums may round in another order)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geometry import rectify as jrect
from orb_slam2_tpu.ops import image as jimage

from orb_slam2_tpu_torch.geometry import rectify as trect
from orb_slam2_tpu_torch.ops import image as timage

W, H = 64, 48
K = np.array([[100.0, 0.0, 32.0], [0.0, 102.0, 24.0], [0.0, 0.0, 1.0]])
D5 = np.array([-0.28, 0.07, 1e-4, -2e-5, 0.0])
D8 = np.array([-0.28, 0.07, 1e-4, -2e-5, 0.01, 0.002, -0.001, 0.0005])
TH = 0.01
R = np.array([[np.cos(TH), -np.sin(TH), 0], [np.sin(TH), np.cos(TH), 0], [0, 0, 1.0]])


@pytest.mark.parametrize("D,Rr,P", [(np.zeros(5), np.eye(3), K), (D5, np.eye(3), K),
                                    (D5, R, np.hstack([K, np.zeros((3, 1))])),
                                    (D8, R, K)], ids=["identity", "distorted", "rotated", "rational"])
def test_maps_and_remap_bit_exact(D, Rr, P):
    got = trect.init_undistort_rectify_map(K, D, Rr, P, W, H)
    want = jrect.init_undistort_rectify_map(K, D, Rr, P, W, H)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(0).uniform(0, 255, size=(H, W)).astype(np.float32)
    np.testing.assert_array_equal(trect.remap_bilinear(img, *got, fill=3.0),
                                  jrect.remap_bilinear(img, *want, fill=3.0))


def test_rectifier_from_settings(tmp_path):
    def mat(a):
        a = np.asarray(a, np.float64)
        return ("!!opencv-matrix\n   rows: %d\n   cols: %d\n   dt: d\n   data: [%s]"
                % (a.shape[0], a.shape[1], ", ".join(repr(float(x)) for x in a.ravel())))

    blocks = []
    for side, rot in (("LEFT", np.eye(3)), ("RIGHT", R)):
        blocks += [f"{side}.height: {H}", f"{side}.width: {W}", f"{side}.D: {mat(D5[None, :])}",
                   f"{side}.K: {mat(K)}", f"{side}.R: {mat(rot)}",
                   f"{side}.P: {mat(np.hstack([K, np.zeros((3, 1))]))}"]
    path = os.path.join(tmp_path, "euroc.yaml")
    with open(path, "w") as f:
        f.write("%YAML:1.0\n\n" + "\n".join(blocks) + "\n")
    assert trect.StereoRectifier.available(path)
    got = trect.StereoRectifier.from_settings(path)
    want = jrect.StereoRectifier.from_settings(path)
    rng = np.random.default_rng(1)
    left, right = (rng.uniform(0, 255, size=(H, W)).astype(np.float32) for _ in range(2))
    for a, b in zip(got(left, right), want(left, right)):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bgr", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_gray(bgr, dtype):
    img = np.random.default_rng(2).uniform(0, 255, size=(H, W, 3)).astype(dtype)
    got = timage.rgb_to_gray(torch.from_numpy(img), bgr=bgr)
    want = np.asarray(jimage.rgb_to_gray(jnp.asarray(img), bgr=bgr))
    assert got.dtype == torch.float32 and got.shape == (H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
