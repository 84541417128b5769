"""K2 over a whole pyramid (`ops/cuda_extract.dense_stage_levels`, one
launch per frame on the card) on the CPU: its twin against the JAX
reference's Pallas kernel level by level, the CPU route, and numpy models
of what the CUDA kernel (`csrc/dense_stage.cu`) does differently from the
twin: the FAST score in the doubling form and the flat grid over the tiles
of all levels.

Tolerances, and why: scores and the high-threshold flag bit-exact (subtract,
min and max of float32 are exact); the blur within 1e-3 gray of the
reference's (FMA contraction on the reference side only, the bound of
`tests/test_torch_image_fast.py::test_dense_stage_twin_matches_pallas_and_xla`).
The models are exact: the doubling score equals the per-arc score and the
twin's score map bit for bit, and the grid covers every pixel once.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import pallas_extract

from orb_slam2_tpu_torch.ops import cuda_extract as ce
from orb_slam2_tpu_torch.ops import extractor as tex
from orb_slam2_tpu_torch.ops import fast as tfast
from orb_slam2_tpu_torch.ops import launch

torch.set_num_threads(1)
INI_TH, MIN_TH = 20.0, 7.0


def _image(seed, h, w):
    """Random gray image with sharp square blobs (real FAST structure)."""
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w)) * 255).astype(np.float32)
    for _ in range(60):
        y, x = rng.integers(20, h - 20), rng.integers(20, w - 20)
        img[y:y + 6, x:x + 6] = 255.0 * rng.random()
    return np.round(img)


def _pyramid(seed, h=240, w=320, n_levels=4):
    img = torch.from_numpy(_image(seed, h, w))
    taps = tex.pyramid_taps(tex.pyramid_sizes(h, w, n_levels, 1.2), device="cpu")
    levels = ce.pyramid_plain(img, taps)
    return levels, [tex.level_region(*lv.shape) for lv in levels]


@pytest.mark.parametrize("seed", [3, 4])
def test_levels_twin_matches_pallas_kernel_per_level(seed):
    levels, regions = _pyramid(seed)
    got = ce.dense_stage_levels_plain(levels, INI_TH, MIN_TH, regions)
    assert len(got) == len(levels) == 4
    n_corners = 0
    for lvl, (lv, region, (s, hi, blur)) in enumerate(zip(levels, regions, got)):
        s_ref, hi_ref, b_ref = pallas_extract.dense_stage_pallas(
            jnp.asarray(lv.numpy()), INI_TH, MIN_TH, *region, interpret=True)
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref), err_msg=f"level {lvl}")
        np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_ref), err_msg=f"level {lvl}")
        np.testing.assert_allclose(blur.numpy(), np.asarray(b_ref), rtol=0, atol=1e-3,
                                   err_msg=f"level {lvl}")
        n_corners += int(np.isfinite(s.numpy()).sum())
    assert n_corners > 50


def test_cpu_levels_run_the_twin_without_launching():
    levels, regions = _pyramid(5)
    launch.reset_launches()
    got = ce.dense_stage_levels(levels, INI_TH, MIN_TH, regions)
    want = ce.dense_stage_levels_plain(levels, INI_TH, MIN_TH, regions)
    one = ce.dense_stage(levels[2], INI_TH, MIN_TH, *regions[2])
    assert not any(launch.LAUNCHES.values())
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(one, want[2]))


# ---------------------------------------------------------------------------
# numpy models of the kernel's score
# ---------------------------------------------------------------------------

def _circle_diffs(img):
    """(16, n) float32: circle pixel minus centre at every pixel >= 3 px from
    the border, in the kernel's circle order (fast.CIRCLE)."""
    h, w = img.shape
    p = img[3:h - 3, 3:w - 3]
    return np.stack([img[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] - p
                     for dx, dy in tfast.CIRCLE]).reshape(16, -1)


def _score_arcs(d):
    """The per-arc body: max over 16 arcs of max(min(arc), -max(arc))."""
    out = np.full(d.shape[1], -np.inf, np.float32)
    for s in range(16):
        arc = d[[(s + j) % 16 for j in range(9)]]
        out = np.maximum(out, np.maximum(arc.min(0), -arc.max(0)))
    return out


def _score_doubling(d):
    """The kernel's doubling form, step for step (`score_doubling`)."""
    r = lambda a, k: a[[(i + k) % 16 for i in range(16)]]
    m2, M2 = np.minimum(d, r(d, 1)), np.maximum(d, r(d, 1))
    m4, M4 = np.minimum(m2, r(m2, 2)), np.maximum(M2, r(M2, 2))
    m8, M8 = np.minimum(m4, r(m4, 4)), np.maximum(M4, r(M4, 4))
    bright = np.minimum(m8, r(d, 8)).max(0)
    dark = np.maximum(M8, r(d, 8)).min(0)
    return np.maximum(bright, -dark)


def _patches(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.random((90, 110)) * 255).astype(np.float32)
    if kind == "integer":
        return _image(seed, 90, 110).astype(np.float32)
    # tie-heavy: few levels, steps of exactly the thresholds
    base = rng.integers(0, 4, (90, 110)).astype(np.float32) * np.float32(MIN_TH)
    base[rng.random((90, 110)) < 0.2] += np.float32(INI_TH)
    return base


@pytest.mark.parametrize("kind", ["random", "integer", "ties"])
def test_doubling_score_model(kind):
    img = _patches(kind, {"random": 0, "integer": 1, "ties": 2}[kind])
    d = _circle_diffs(img)
    arcs, dbl = _score_arcs(d), _score_doubling(d)
    np.testing.assert_array_equal(dbl, arcs)
    # the twin's score map is the same function
    twin = tfast.fast_score_map(torch.from_numpy(img)).numpy()[3:-3, 3:-3].reshape(-1)
    np.testing.assert_array_equal(twin, dbl)
    assert (arcs > MIN_TH).any() and (arcs <= MIN_TH).any()
    if kind == "ties":       # scores land exactly on the thresholds
        assert (arcs == MIN_TH).any()


# ---------------------------------------------------------------------------
# numpy model of the flat grid over the tiles of all levels
# ---------------------------------------------------------------------------

def _grid(sizes, tw, th):
    """The launcher's table (`orb_dense_stage_levels`): per level its first
    block and tiles per row; the blocks' count."""
    tile0, tiles_x, n = [], [], 0
    for h, w in sizes:
        tile0.append(n)
        tiles_x.append(-(-w // tw))
        n += tiles_x[-1] * -(-h // th)
    return tile0, tiles_x, n


@pytest.mark.parametrize("tw,th", [(32, 16), (32, 32)])
def test_flat_grid_covers_every_pixel_of_every_level_once(tw, th):
    """Levels of an 8-level 100x75 pyramid (tiles overhang, levels under 32
    px wide) and of a 480x640 one: each block finds its level by the
    kernel's scan and its tile by (tile / tiles_x, tile % tiles_x); the
    blocks' in-image pixels cover each level exactly once."""
    for h0, w0 in ((100, 75), (480, 640)):
        sizes = tex.pyramid_sizes(h0, w0, 8, 1.2)
        assert min(w for _, w in sizes) < 32 or h0 == 480
        tile0, tiles_x, n = _grid(sizes, tw, th)
        seen = [np.zeros(s, np.int32) for s in sizes]
        for b in range(n):
            lvl = 0
            while lvl + 1 < len(sizes) and b >= tile0[lvl + 1]:
                lvl += 1
            t = b - tile0[lvl]
            y0, x0 = (t // tiles_x[lvl]) * th, (t % tiles_x[lvl]) * tw
            h, w = sizes[lvl]
            assert y0 < h and x0 < w
            seen[lvl][y0:y0 + th, x0:x0 + tw] += 1
        assert all((s == 1).all() for s in seen)
