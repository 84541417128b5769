"""The port's image primitives, FAST stage and dense-stage twin against the
JAX reference (`orb_slam2_tpu`), on the CPU. Inputs come from a seed with
numpy and go to both packages; the tolerance of each comparison is stated
with its reason. Also: the port never imports jax, and CPU tensors run the
plain twins without launching anything."""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import extractor as jex
from orb_slam2_tpu.ops import fast as jfast
from orb_slam2_tpu.ops import image as jimage
from orb_slam2_tpu.ops import pallas_extract
from orb_slam2_tpu.utils.config import SlamConfig as JaxConfig

from orb_slam2_tpu_torch.ops import cuda_extract as ce
from orb_slam2_tpu_torch.ops import launch
from orb_slam2_tpu_torch.ops import extractor as tex
from orb_slam2_tpu_torch.ops import fast as tfast
from orb_slam2_tpu_torch.ops import image as timage

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E = tex.EDGE_THRESHOLD - 3


def _image(seed, h, w, integer=True):
    """Random gray image with sharp square blobs (real FAST structure)."""
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w)) * 255).astype(np.float32)
    for _ in range(60):
        y, x = rng.integers(20, h - 20), rng.integers(20, w - 20)
        img[y:y + 6, x:x + 6] = 255.0 * rng.random()
    return np.round(img) if integer else img


def test_port_imports_no_jax():
    """Every module of the port imports without jax or the reference."""
    code = ("import importlib, pkgutil, sys\n"
            "import orb_slam2_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert len(names) >= 50, names\n"
            "assert 'orb_slam2_tpu_torch.parallel.sharded_ba' in names, names\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'orb_slam2_tpu' not in sys.modules, 'reference imported'\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cpu_tensors_route_to_twins_without_launching():
    launch.reset_launches()
    img = torch.from_numpy(_image(1, 134, 178))
    taps = tex.pyramid_taps(tex.pyramid_sizes(134, 178, 3, 1.2), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(ce.pyramid(img, taps), ce.pyramid_plain(img, taps)))
    args = (20.0, 7.0, E, 178 - E, E, 134 - E)
    assert all(torch.equal(a, b) for a, b in
               zip(ce.dense_stage(img, *args), ce.dense_stage_plain(img, *args)))
    ys = torch.tensor([40, 60], dtype=torch.int32)
    cs = torch.tensor([1.0, 0.6]), torch.tensor([0.0, 0.8])
    pts = torch.zeros((2, 512))
    assert torch.equal(ce.brief_levels([img], ys, ys, *cs, pts, [2]),
                       ce.brief_levels_plain([img], ys, ys, *cs, pts, [2]))
    assert not any(launch.LAUNCHES.values())
    with pytest.raises(ValueError):
        ce.pyramid(img.to("meta"), taps)


def test_gaussian_taps_and_resize_tables_identical():
    np.testing.assert_array_equal(timage._gaussian_kernel_1d(9, 2.0),
                                  jimage._gaussian_kernel_1d(9, 2.0))
    for n_in, n_out in ((640, 533), (257, 214), (9, 7)):
        M = jimage._resize_matrix(n_in, n_out)
        np.testing.assert_array_equal(timage._resize_matrix(n_in, n_out), M)
        # the 2-tap tables reproduce every row of the reference's matrix
        idx, wt = timage._resize_taps(n_in, n_out)
        R = np.zeros_like(M)
        for k in range(2):
            np.add.at(R, (np.arange(n_out), idx[k]), wt[k])
        np.testing.assert_array_equal(R, M)


@pytest.mark.parametrize("h,w", [(134, 178), (240, 320)])
def test_gaussian_blur_matches(h, w):
    img = _image(h, h, w, integer=False)
    ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img)))
    got = timage.gaussian_blur(torch.from_numpy(img)).numpy()
    # the same left fold; XLA may contract a multiply-add into an FMA, the
    # port rounds each product (bound of the reference's own Pallas test)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_pyramid_plain_matches_f32_reference():
    h, w = 240, 320
    img = _image(7, h, w, integer=False)
    cfg = JaxConfig(width=w, height=h, n_levels=4, use_pallas=0)
    ref = jex.build_pyramid(jnp.asarray(img), cfg)
    taps = tex.pyramid_taps(tex.pyramid_sizes(h, w, 4, 1.2), device="cpu")
    got = ce.pyramid_plain(torch.from_numpy(img), taps)
    assert len(got) == len(ref)
    for lvl, (a, b) in enumerate(zip(ref, got)):
        assert tuple(b.shape) == a.shape
        # the reference is a f32 dot over the whole row (XLA's order, FMA);
        # the port sums the two nonzero taps: measured <= 5e-5 gray
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-3,
                                   err_msg=f"level {lvl}")
    # resize_bilinear is the same 2-tap rule, one level
    np.testing.assert_array_equal(timage.resize_bilinear(torch.from_numpy(img), 200, 267).numpy(),
                                  got[1].numpy())


@pytest.mark.parametrize("h,w", [(134, 178), (240, 320)])
def test_fast_score_and_candidates_bit_exact(h, w):
    img = _image(h + 1, h, w)
    region = (E, w - E, E, h - E)

    @jax.jit
    def reference(x):
        s = jfast.fast_score_map(x)
        return (s,) + jfast.compute_candidates(s, 20.0, 7.0, *region) + (jfast.nms3x3(s),)

    s_ref, c_ref, cs_ref, keep_ref = (np.asarray(a) for a in reference(jnp.asarray(img)))
    s_got = tfast.fast_score_map(torch.from_numpy(img))
    np.testing.assert_array_equal(s_got.numpy(), s_ref)   # subtract/min/max are exact
    c_got, cs_got = tfast.compute_candidates(s_got, 20.0, 7.0, *region)
    np.testing.assert_array_equal(c_got.numpy(), c_ref)
    np.testing.assert_array_equal(cs_got.numpy(), cs_ref)
    assert c_got.sum() > 20
    np.testing.assert_array_equal(tfast.nms3x3(s_got).numpy(), keep_ref)


@pytest.mark.parametrize("h,w", [(134, 178), (240, 320)])
def test_dense_stage_twin_matches_pallas_and_xla(h, w):
    img = _image(h + 2, h, w, integer=False)
    region = (E, w - E, E, h - E)
    s_ref, hi_ref, b_ref = pallas_extract.dense_stage_pallas(
        jnp.asarray(img), 20.0, 7.0, *region, interpret=True)
    cand_ref = np.asarray(pallas_extract.candidates_from_dense(s_ref, hi_ref, *region))
    _, cand_xla = jfast.compute_candidates(jfast.fast_score_map(jnp.asarray(img)),
                                           20.0, 7.0, *region)
    np.testing.assert_array_equal(cand_ref, np.asarray(cand_xla))

    s, hi, blur = ce.dense_stage_plain(torch.from_numpy(img), 20.0, 7.0, *region)
    cand = ce.candidates_from_dense(s, hi, *region).numpy()
    # candidate scores are bit-exact: subtract, min and max of f32 are exact
    np.testing.assert_array_equal(cand, cand_ref)
    # inside the detection region the Pallas kernel's reflected halo and the
    # twin's wrapped rolls read the same pixels; outside both are -inf / 0
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_ref))
    # blur: FMA contraction on the reference side only (its own bound)
    np.testing.assert_allclose(blur.numpy(), np.asarray(b_ref), rtol=0, atol=1e-3)
    assert np.isfinite(cand).sum() > 20
