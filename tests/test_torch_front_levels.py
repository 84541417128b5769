"""K1 (the pyramid, `csrc/pyramid.cu`) and K3 (steered BRIEF, `csrc/brief.cu`),
each one launch per frame over all levels on the card, on the CPU: the packed
tap tables, a numpy model of K1's ticket order between levels, a numpy float32
model of K3's in-kernel rotation of the pattern, K3's levels twin against the
per-level path and the JAX reference, and the CPU route.

Tolerances, and why: the tables and the models are exact (K1's taps are copied,
its order is integer bookkeeping, K3's rotation is two float32 products, a
float32 sum and a round half-to-even, as `rotated_offsets` computes it). The
levels twin equals the per-level `steered_brief` bit for bit (the same
operations on the same values); against the JAX `steered_brief` it is held to
the reference's own bound between its paths, 8 flipped bits a level (cos and
sin differ by ULPs between the libraries and XLA may contract
px*cos - py*sin into an FMA, which flips a half-way round;
`tests/test_torch_select_brief.py::test_steered_brief_matches`).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import orient_brief as jbrief

from orb_slam2_tpu_torch.ops import cuda_extract as ce
from orb_slam2_tpu_torch.ops import extractor as tex
from orb_slam2_tpu_torch.ops import image as timage
from orb_slam2_tpu_torch.ops import launch
from orb_slam2_tpu_torch.ops import orient_brief as tbrief

torch.set_num_threads(1)
SIZES = [(480, 640), (134, 178), (101, 257)]     # the bench's frame, a small one, an odd one


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w)) * 255).astype(np.float32)
    for _ in range(max(h * w // 2000, 4)):
        y, x = rng.integers(0, max(h - 6, 1)), rng.integers(0, max(w - 6, 1))
        img[y:y + 6, x:x + 6] = 255.0 * rng.random()
    return np.round(img)


def _flipped_bits(a_u32, b_i32):
    return int(np.unpackbits((np.asarray(a_u32, np.uint32)
                              ^ b_i32.numpy().view(np.uint32)).view(np.uint8)).sum())


@pytest.mark.parametrize("h,w", SIZES)
def test_packed_pyramid_taps_equal_resize_tables(h, w):
    """`pack_pyramid_taps` lays each level's iy then ix (int32) and wy then
    wx (float32) one level after another, as the launcher reads them, and
    keeps the per-level list for the twin; every entry is
    `image._resize_taps`'s, bit for bit."""
    sizes = tex.pyramid_sizes(h, w, 8, 1.2)
    taps = ce.pack_pyramid_taps(tex.pyramid_taps(sizes, device="cpu"), sizes[0])
    assert taps.sizes == tuple(sizes) and list(taps.dims) == [v for hw in sizes for v in hw]
    off = 0
    for (ph, pw), (lh, lw), level in zip(sizes[:-1], sizes[1:], taps.levels):
        iy, wy = timage._resize_taps(ph, lh)
        ix, wx = timage._resize_taps(pw, lw)
        for want, got in zip((iy, wy, ix, wx), level):
            np.testing.assert_array_equal(got.numpy(), want)
        for want_i, want_f, n in ((iy, wy, 2 * lh), (ix, wx, 2 * lw)):
            np.testing.assert_array_equal(taps.itaps[off:off + n].numpy(), want_i.reshape(-1))
            assert taps.ftaps[off:off + n].numpy().view(np.uint32).tolist() == \
                want_f.reshape(-1).view(np.uint32).tolist()
            off += n
    assert off == taps.itaps.numel() == taps.ftaps.numel()
    assert taps.itaps.dtype == torch.int32 and taps.ftaps.dtype == torch.float32


def _row0(sizes):
    """The launcher's numbering (`orb_pyramid`): per output level the ticket
    of its first row; the rows of all output levels."""
    row0, n = [], 0
    for h, _ in sizes[1:]:
        row0.append(n)
        n += h
    return row0, n


@pytest.mark.parametrize("h,w", SIZES + [(7, 9)])
def test_ticket_order_covers_each_pixel_once_and_waits_only_on_lower_tickets(h, w):
    """Each ticket finds its level by the kernel's scan and takes one row;
    the tickets cover every pixel of levels 1..7 exactly once. A row of
    level 2.. waits for the two rows of the level before that its row taps
    name (clamped, as the kernel clamps them; `image.resize_taps` reads no
    other row): both have lower tickets. Level 1 reads the input and waits
    for nothing."""
    sizes = tex.pyramid_sizes(h, w, 8, 1.2)
    taps = tex.pyramid_taps(sizes, device="cpu")
    row0, n = _row0(sizes)
    seen = [np.zeros(s, np.int32) for s in sizes[1:]]
    waits = 0
    for t in range(n):
        lvl = 0
        while lvl + 1 < len(row0) and t >= row0[lvl + 1]:
            lvl += 1
        r = t - row0[lvl]
        assert 0 <= r < sizes[lvl + 1][0]
        seen[lvl][r] += 1
        if lvl == 0:
            continue
        iy = np.clip(taps[lvl][0].numpy()[:, r], 0, sizes[lvl][0] - 1)
        waited = {row0[lvl - 1] + int(y) for y in iy}
        assert max(waited) < t and len(waited) <= 2
        waits += len(waited)
    assert all((s == 1).all() for s in seen) and waits > 0


def _halfway_angles():
    """4,096 float32 angles: a uniform sweep of [0, 360) with 30 and 210
    degrees among them, where the float32 sine is exactly +-0.5, so the
    pattern points on an axis rotate onto exact half-integers."""
    ang = (np.arange(4096) * (360.0 / 4096)).astype(np.float32)
    ang[[1, 2, 3]] = [30.0, np.nextafter(np.float32(30.0), np.float32(90.0)), 210.0]
    return torch.from_numpy(ang)


def test_in_kernel_rotation_model_equals_rotated_offsets():
    """K3 rotates the pattern itself: dx = rint(px*ca - py*sa), dy =
    rint(px*sa + py*ca), each product rounded to float32, then the
    difference or sum rounded to float32 (__fmul_rn, __fsub_rn, __fadd_rn),
    then half to even (__float2int_rn). The numpy float32 model of that
    equals `rotated_offsets` bit for bit over all 512 points and 4,096
    angles, exact half-way cases among them."""
    points = torch.as_tensor(tbrief.brief_points())
    ang = _halfway_angles()
    ca, sa = tbrief.angle_cos_sin(ang)
    px, py = points[0].numpy()[None, :], points[1].numpy()[None, :]
    c, s = ca.numpy()[:, None], sa.numpy()[:, None]
    vx = np.float32(px * c) - np.float32(py * s)
    vy = np.float32(px * s) + np.float32(py * c)
    assert vx.dtype == vy.dtype == np.float32
    halfway = int((vx - np.floor(vx) == 0.5).sum() + (vy - np.floor(vy) == 0.5).sum())
    assert halfway >= 16
    dx, dy = tbrief.rotated_offsets(ang, points)
    np.testing.assert_array_equal(np.rint(vx).astype(np.int32), dx.numpy())
    np.testing.assert_array_equal(np.rint(vy).astype(np.int32), dy.numpy())
    # half to even, not half away from zero: the half-way cases tell them apart
    assert (np.rint(vx) != np.trunc(vx + np.copysign(0.5, vx))).sum() > 0


def _frame_levels(seed, h, w, counts):
    """Blurred levels of an 8-level pyramid and, per level, counts[l]
    keypoints anywhere inside it (BRIEF clamps every sample) with random
    angles: (blurs, ys, xs, angles), the last three concatenated."""
    rng = np.random.default_rng(seed)
    sizes = tex.pyramid_sizes(h, w, len(counts), 1.2)
    pyr = ce.pyramid_plain(torch.from_numpy(_image(seed, h, w)),
                           tex.pyramid_taps(sizes, device="cpu"))
    blurs = [timage.gaussian_blur(lv) for lv in pyr]
    ys = np.concatenate([rng.integers(0, lh, c) for (lh, _), c in zip(sizes, counts)])
    xs = np.concatenate([rng.integers(0, lw, c) for (_, lw), c in zip(sizes, counts)])
    ang = (rng.random(sum(counts)) * 360).astype(np.float32)
    return blurs, *(torch.from_numpy(a.astype(np.int32)) for a in (ys, xs)), \
        torch.from_numpy(ang)


@pytest.mark.parametrize("h,w,counts", [(240, 320, [60, 50, 0, 35, 30, 25, 0, 17]),
                                        (100, 75, [20, 0, 13, 9, 7, 5, 3, 1])])
def test_brief_levels_twin_equals_per_level_and_reference(h, w, counts):
    """All levels of a frame at once (empty levels among them; 100x75 has
    levels under 39 px, where samples clamp) against `steered_brief` level
    by level: bit for bit, with each level's cosine and sine computed as
    `steered_brief` computes them; and within the reference's 8-bit bound
    of the JAX `steered_brief` on each level."""
    blurs, ys, xs, ang = _frame_levels(h + w, h, w, counts)
    points = torch.as_tensor(tbrief.brief_points())
    bounds = np.cumsum([0] + counts)
    cs = [tbrief.angle_cos_sin(ang[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    ca, sa = (torch.cat(t) for t in zip(*cs))
    got = ce.brief_levels_plain(blurs, ys, xs, ca, sa, points, counts)
    assert got.dtype == torch.int32 and got.shape == (sum(counts), 8)
    for lvl, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        want = tbrief.steered_brief(blurs[lvl], ys[a:b], xs[a:b], ang[a:b], points)
        assert torch.equal(got[a:b], want), lvl
        if b > a:
            ref = np.asarray(jbrief.steered_brief(
                jnp.asarray(blurs[lvl].numpy()), jnp.asarray(ys[a:b].numpy()),
                jnp.asarray(xs[a:b].numpy()), jnp.asarray(ang[a:b].numpy())))
            assert _flipped_bits(ref, got[a:b]) <= 8, lvl
    assert bool((got < 0).any())              # words with the top bit set survive


def test_cpu_front_levels_run_the_twins_without_launching():
    """CPU tensors take K1's and K3's twins, packed taps and all, and
    launch nothing; a tensor on another device raises."""
    launch.reset_launches()
    h, w = 134, 178
    sizes = tex.pyramid_sizes(h, w, 8, 1.2)
    levels = tex.pyramid_taps(sizes, device="cpu")
    img = torch.from_numpy(_image(5, h, w))
    packed = ce.pack_pyramid_taps(levels, sizes[0])
    got = ce.pyramid(img, packed)
    assert len(got) == 8
    assert all(torch.equal(a, b) for a, b in zip(got, ce.pyramid_plain(img, levels)))
    counts = [30, 0, 20, 10, 5, 5, 3, 2]
    blurs, ys, xs, ang = _frame_levels(9, h, w, counts)
    ca, sa = tbrief.angle_cos_sin(ang)
    points = torch.as_tensor(tbrief.brief_points())
    assert torch.equal(ce.brief_levels(blurs, ys, xs, ca, sa, points, counts),
                       ce.brief_levels_plain(blurs, ys, xs, ca, sa, points, counts))
    assert not any(launch.LAUNCHES.values())
    with pytest.raises(ValueError):
        ce.brief_levels([b.to("meta") for b in blurs], ys.to("meta"), xs, ca, sa, points, counts)
