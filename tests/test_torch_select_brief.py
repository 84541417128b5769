"""The port's keypoint selection, orientation and steered BRIEF against the
JAX reference (`orb_slam2_tpu`), on the CPU, with numpy-seeded inputs given
to both packages."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import fast as jfast
from orb_slam2_tpu.ops import image as jimage
from orb_slam2_tpu.ops import orient_brief as jbrief
from orb_slam2_tpu.ops import pallas_extract
from orb_slam2_tpu.ops import select as jselect

from orb_slam2_tpu_torch.ops import cuda_extract as ce
from orb_slam2_tpu_torch.ops import fast as tfast
from orb_slam2_tpu_torch.ops import orient_brief as tbrief
from orb_slam2_tpu_torch.ops import select as tselect

torch.set_num_threads(1)
E = 16
HALF = tbrief.HALF_PATCH


def _image(seed, h, w, integer=True):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w)) * 255).astype(np.float32)
    for _ in range(60):
        y, x = rng.integers(20, h - 20), rng.integers(20, w - 20)
        img[y:y + 6, x:x + 6] = 255.0 * rng.random()
    return np.round(img) if integer else img


def _flipped_bits(a_u32, b_i32):
    return int(np.unpackbits((np.asarray(a_u32, np.uint32)
                              ^ b_i32.numpy().view(np.uint32)).view(np.uint8)).sum())


def _pack_u32(bits):
    """(N, 256) bool -> (N, 8) uint32, bit b of word w = pair w*32+b."""
    b = bits.reshape(-1, 8, 32).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def test_constant_tables_identical():
    np.testing.assert_array_equal(tbrief.umax_table(), jbrief.umax_table())
    np.testing.assert_array_equal(tbrief._circular_mask(), jbrief._circular_mask())
    np.testing.assert_array_equal(tbrief.brief_pattern(), jbrief.brief_pattern())


@pytest.mark.parametrize("h,w,budget,per_cell", [
    pytest.param(h, w, budget, per_cell, id=f"{h}-{w}-{budget}" + ("-top2" if per_cell == 2 else ""))
    for per_cell in (1, 2) for h, w, budget in ((134, 250, 60), (240, 320, 217), (240, 320, 4096))])
def test_select_uniform_bit_exact(h, w, budget, per_cell):
    """Same candidate map -> same (ys, xs, resp, valid), including the order
    among equal responses (integer images tie often) and a budget no grid
    depth reaches (4096 = the finest grid's cell count at 240x320). At
    134x250 the ladder starts from two root cells, as the reference's nIni.
    per_cell=2 (`cfg.select_top2`) keeps each cell's runner-up too."""
    img = _image(h + budget, h, w)
    region = (E, w - E, E, h - E)
    _, cs = jfast.compute_candidates(jfast.fast_score_map(jnp.asarray(img)),
                                     20.0, 7.0, *region)
    ref = jax.jit(jselect.select_uniform, static_argnums=range(1, 7))(
        cs, budget, *region, per_cell)
    got = tselect.select_uniform(torch.from_numpy(np.array(cs)), budget, *region,
                                 per_cell=per_cell)
    for name, a, b in zip(("ys", "xs", "resp", "valid"), ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert got[0].dtype == torch.int32


def test_select_top2_not_ported():
    """per_cell=2 is ported: on a map with no candidate it selects nothing,
    and on one candidate pair per cell it keeps both of a cell before the
    next cell's winner."""
    ys, xs, resp, valid = tselect.select_uniform(torch.full((64, 64), float("-inf")), 10,
                                                 E, 48, E, 48, per_cell=2)
    assert not bool(valid.any()) and ys.shape == (10,)
    score = torch.full((64, 64), float("-inf"))
    score[20, 20], score[20, 21], score[40, 40] = 9.0, 8.0, 7.0
    _, xs, resp, valid = tselect.select_uniform(score, 3, E, 48, E, 48, per_cell=2)
    assert resp.tolist() == [9.0, 8.0, 7.0] and bool(valid.all())


def _angle_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 360.0 - d)


@pytest.mark.parametrize("integer", [True, False])
def test_ic_angles_match(integer):
    h, w = 134, 178
    img = _image(3, h, w, integer=integer)
    rng = np.random.default_rng(4)
    ys = rng.integers(15, h - 15, 200).astype(np.int32)
    xs = rng.integers(15, w - 15, 200).astype(np.int32)
    ref = np.asarray(jbrief.ic_angles(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)))
    got = tbrief.ic_angles(torch.from_numpy(img), torch.from_numpy(ys),
                           torch.from_numpy(xs)).numpy()
    assert ((got >= 0) & (got < 360)).all()
    if integer:
        # integer images keep every f32 moment sum exact (< 2^24): the
        # packages differ only by atan2 ULPs
        assert _angle_diff(got, ref).max() <= 1e-3
        return
    # non-integer levels: the reference's f32 sum over 961 terms rounds up
    # to ~3e-3 deg away from the exact angle (measured), the port's
    # reduction ~1e-4 deg. Hold the port to 1e-3 deg of the float64
    # moments, and to the reference within the reference's own error
    r = np.arange(-HALF, HALF + 1)
    patch = img.astype(np.float64)[ys[:, None, None] + r[None, :, None],
                                   xs[:, None, None] + r[None, None, :]]
    wts = tbrief.ic_weights().astype(np.float64)
    exact = np.degrees(np.arctan2((patch * wts[1]).sum((1, 2)),
                                  (patch * wts[0]).sum((1, 2)))) % 360.0
    assert _angle_diff(got, exact).max() <= 1e-3
    assert (_angle_diff(got, ref) <= _angle_diff(ref, exact) + 1e-3).all()


@pytest.mark.parametrize("h,w", [(134, 178), (240, 320)])
def test_brief_plain_matches_pallas_sampler(h, w):
    rng = np.random.default_rng(h)
    blur = (rng.random((h, w)) * 255).astype(np.float32)
    n = 77
    ys = rng.integers(19, h - 19, n).astype(np.int32)
    xs = rng.integers(19, w - 19, n).astype(np.int32)
    dx = rng.integers(-19, 20, (n, 512)).astype(np.int32)
    dy = rng.integers(-19, 20, (n, 512)).astype(np.int32)
    vals = np.asarray(pallas_extract.brief_sample_pallas(
        jnp.asarray(blur), jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(dx),
        jnp.asarray(dy), interpret=True))
    ref = _pack_u32(vals[:, :256] < vals[:, 256:])
    got = ce.brief_plain(torch.from_numpy(blur), torch.from_numpy(ys),
                         torch.from_numpy(xs), torch.from_numpy(dx), torch.from_numpy(dy))
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    assert _flipped_bits(ref, got) == 0           # a gather and a compare: exact
    assert (ref >= 2 ** 31).any()                 # top bits survive the int32 view


def test_steered_brief_matches():
    h, w = 240, 320
    rng = np.random.default_rng(5)
    blur = np.array(jimage.gaussian_blur(jnp.asarray(_image(6, h, w))))
    n = 96
    ys = rng.integers(19, h - 19, n).astype(np.int32)
    xs = rng.integers(19, w - 19, n).astype(np.int32)
    ang = (rng.random(n) * 360).astype(np.float32)
    ref = np.asarray(jbrief.steered_brief(jnp.asarray(blur), jnp.asarray(ys),
                                          jnp.asarray(xs), jnp.asarray(ang)))
    got = tbrief.steered_brief(torch.from_numpy(blur), torch.from_numpy(ys),
                               torch.from_numpy(xs), torch.from_numpy(ang))
    # cos/sin differ by ULPs between the two libraries and XLA may contract
    # px*cos - py*sin to an FMA, which can flip a half-way round: the
    # reference's own Pallas-vs-XLA bound of 8 bits over the set
    assert _flipped_bits(ref, got) <= 8
