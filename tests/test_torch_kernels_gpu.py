"""The port's CUDA kernels against their plain-PyTorch twins, on the card.

CUDA kernels have no CPU mode, so every test here needs a CUDA device and
skips without one (CPU tensors route to the twins, which the other
`test_torch_*` files hold against the JAX reference). Run on the GPU with

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

(`--noconftest`: the suite's conftest imports JAX, which the port does not
need). The front-end twins round every product and sum in the kernels'
order, and the matching kernels decide integers by exact compares, so those
comparisons are bit-exact. The pose kernels sum the edges in another order
than their twins: K6 is held to Tcw within 1e-4 and equal inlier sets except
at the chi2 threshold, K7 to the reference's own tolerance between its XLA
and Pallas builds (H rtol 3e-4 atol 2e-3, b atol 2e-2), and two K7
launches equal bit for bit. K4 (both gates)
and K8 (from the map's rows) decide integers from float32 values rounded as
in their twins: bit-exact. K9 (the whole BA
assembly) performs its twin's per-edge float32 operations and sums in the
same order: every field of `schur_ba.Lin` bit-exact, NaN where the twin has
NaN.
"""
import os
import sys

import numpy as np
import pytest
import torch

from orb_slam2_tpu_torch.geometry import camera as camera_mod
from orb_slam2_tpu_torch.geometry import se3
from orb_slam2_tpu_torch.mapstate import map as mapstate
from orb_slam2_tpu_torch.ops import cuda_ba as cb
from orb_slam2_tpu_torch.ops import cuda_extract as ce
from orb_slam2_tpu_torch.ops import cuda_match as cm
from orb_slam2_tpu_torch.ops import cuda_pose as cp
from orb_slam2_tpu_torch.ops import launch
from orb_slam2_tpu_torch.ops import extractor as ex
from orb_slam2_tpu_torch.ops import orient_brief
from orb_slam2_tpu_torch.pipeline import frame as frame_mod
from orb_slam2_tpu_torch.pipeline import mapping_ops, tracking_step
from orb_slam2_tpu_torch.solvers import schur_ba
from orb_slam2_tpu_torch.utils.config import SlamConfig, SENSOR_RGBD
from orb_slam2_tpu_torch.utils.synthetic import PlateWorld, loop_trajectory

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import _synthetic_epi, _synthetic_node, _synthetic_proj_tiles  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _image(rng, h, w):
    img = np.round(rng.random((h, w)) * 255).astype(np.float32)
    for _ in range(max(h * w // 2000, 4)):
        y, x = rng.integers(0, max(h - 6, 1)), rng.integers(0, max(w - 6, 1))
        img[y:y + 6, x:x + 6] = np.float32(np.round(255.0 * rng.random()))
    return img


@pytest.mark.parametrize("h,w", [(480, 640), (240, 320), (100, 75)])
def test_pyramid_kernel_bit_exact(cuda, h, w):
    img = torch.from_numpy(_image(np.random.default_rng(h), h, w)).to(cuda)
    taps = ex.pyramid_taps(ex.pyramid_sizes(h, w, 8, 1.2), cuda)
    before = launch.LAUNCHES["pyramid"]
    got = ce.pyramid(img, taps)
    want = ce.pyramid_plain(img, taps)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["pyramid"] == before + 1
    for lvl, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        assert torch.equal(a, b), (lvl, float((a - b).abs().max()))
    assert got[1].data_ptr() + 4 * got[1].numel() == got[2].data_ptr()   # one allocation


def _pyramid_cases(dev, sizes, n_images=4):
    """Per size: n_images distinct frames, the packed taps and each frame's
    twin pyramid (so a stale read of another frame's level shows)."""
    cases = []
    for h, w in sizes:
        taps = ce.pack_pyramid_taps(ex.pyramid_taps(ex.pyramid_sizes(h, w, 8, 1.2), dev), (h, w))
        imgs = [torch.from_numpy(_image(np.random.default_rng(h * w + i), h, w)).to(dev)
                for i in range(n_images)]
        cases.append((taps, imgs, [ce.pyramid_plain(im, taps) for im in imgs]))
    return cases


def test_pyramid_one_launch_repeats_under_load(cuda):
    """K1's order between levels under load: 200 launches per frame size
    (the bench's 480x640, a 134x179 pyramid, an odd 101x257), queued while
    another stream runs matrix products, each launch bit-exact on every
    level. A stale read of a level before it is written shows as a rare
    bit difference, not a crash."""
    cases = _pyramid_cases(cuda, [(480, 640), (134, 179), (101, 257)])
    side = torch.cuda.Stream(cuda)
    a = torch.randn(4096, 4096, device=cuda)
    c = torch.empty_like(a)
    torch.cuda.synchronize()
    for taps, imgs, wants in cases:
        with torch.cuda.stream(side):
            for _ in range(30):
                torch.mm(a, a, out=c)
        runs = [ce.pyramid(imgs[i % len(imgs)], taps) for i in range(200)]
        torch.cuda.synchronize()
        for i, got in enumerate(runs):
            for lvl, (g, w) in enumerate(zip(got, wants[i % len(imgs)])):
                assert torch.equal(g, w), (taps.sizes[0], i, lvl)


def test_pyramid_on_two_streams(cuda):
    """Pyramids in flight on two streams at once: each stream has its own
    tickets and flags, and every level equals its twin bit for bit."""
    (taps, imgs, wants), = _pyramid_cases(cuda, [(480, 640)])
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for i in range(16):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[k].append(ce.pyramid(imgs[(i + k) % len(imgs)], taps))
    torch.cuda.synchronize()
    n = sum(h for h, _ in taps.sizes[1:]) + 2
    assert len({launch._counters("pyramid", cuda, s.cuda_stream, n).data_ptr()
                for s in streams}) == 2
    for k, runs in enumerate(got):
        for i, pyr in enumerate(runs):
            for g, w in zip(pyr, wants[(i + k) % len(imgs)]):
                assert torch.equal(g, w), (k, i)


@pytest.mark.parametrize("h,w", [(480, 640), (231, 309), (134, 179), (33, 47), (7, 9)])
def test_dense_stage_kernel_bit_exact(cuda, h, w):
    img = torch.from_numpy(_image(np.random.default_rng(h * w), h, w)).to(cuda)
    # a non-integer level as well (levels > 0 of the pyramid)
    for im in (img, img * 0.7 + 0.3):
        E = ex.EDGE_THRESHOLD - 3
        args = (20.0, 7.0, E, w - E, E, h - E)
        got = ce.dense_stage(im.contiguous(), *args)
        want = ce.dense_stage_plain(im, *args)
        torch.cuda.synchronize()
        for name, a, b in zip(("score_nms", "hi", "blur"), got, want):
            assert torch.equal(a, b), (name, h, w)
    if h > 50:
        assert bool(torch.isfinite(got[0]).any())      # real corners were tested


@pytest.mark.parametrize("h,w", [(480, 640), (100, 75), (37, 250)])
def test_dense_stage_levels_one_launch_bit_exact(cuda, h, w):
    """An 8-level pyramid in one launch: tiles overhang every level, and
    the small levels are under 32 px wide (100x75: 28x21 at level 7) or
    under 16 px tall (37x250: 13 at level 6); at the path's thresholds and
    at a negative and an inverted pair, bit-exact against the twin."""
    img = torch.from_numpy(_image(np.random.default_rng(h + w), h, w)).to(cuda)
    sizes = [s for s in ex.pyramid_sizes(h, w, 8, 1.2) if min(s) > 5]
    levels = ce.pyramid_plain(img, ex.pyramid_taps(sizes, cuda))
    regions = [ex.level_region(*lv.shape) for lv in levels]
    for ini_th, min_th in ((20.0, 7.0), (5.0, -1.0), (7.0, 20.0)):
        want = ce.dense_stage_levels_plain(levels, ini_th, min_th, regions)
        before = launch.LAUNCHES["dense_stage"]
        got = ce.dense_stage_levels(levels, ini_th, min_th, regions)
        torch.cuda.synchronize()
        assert launch.LAUNCHES["dense_stage"] == before + 1
        for lvl, (g, wnt) in enumerate(zip(got, want)):
            for name, a, b in zip(("score_nms", "hi", "blur"), g, wnt):
                assert torch.equal(a, b), (ini_th, min_th, lvl, name)
    assert got[0][0].data_ptr() + 4 * h * w == got[1][0].data_ptr()    # one allocation
    with pytest.raises(ValueError):
        ce.dense_stage_levels(levels * 3, 20.0, 7.0, regions * 3)      # 24 levels: over 16


def _brief_args(rng, sizes, counts, dev, points=None):
    """K3's arguments over levels of these sizes: random blurred levels,
    counts[l] keypoints anywhere in level l (the kernel clamps every
    sample as the twin does), random angles' cosine and sine."""
    blurs = [torch.from_numpy(rng.random(s).astype(np.float32) * 255).to(dev) for s in sizes]
    ys = np.concatenate([rng.integers(0, h, c) for (h, _), c in zip(sizes, counts)])
    xs = np.concatenate([rng.integers(0, w, c) for (_, w), c in zip(sizes, counts)])
    ang = torch.from_numpy((rng.random(sum(counts)) * 360).astype(np.float32)).to(dev)
    ca, sa = orient_brief.angle_cos_sin(ang)
    if points is None:
        points = torch.as_tensor(orient_brief.brief_points(), device=dev)
    t = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    return blurs, t(ys), t(xs), ca, sa, points, list(counts)


@pytest.mark.parametrize("h,w,n", [(480, 640, 217), (134, 179, 60), (30, 37, 13)])
def test_brief_kernel_bit_exact(cuda, h, w, n):
    """One level (`steered_brief`'s case): the rotated pattern, the clamped
    samples and the packed words bit-exact against the twin."""
    args = _brief_args(np.random.default_rng(n), [(h, w)], [n], cuda)
    got = ce.brief_levels(*args)
    want = ce.brief_levels_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    assert torch.equal(got, want)
    assert bool((got < 0).any())          # words with the top bit set survive


@pytest.mark.parametrize("h,w", [(480, 640), (100, 75)])
def test_brief_levels_one_launch_bit_exact(cuda, h, w):
    """A frame's 8 levels in one launch, empty levels among them and, at
    100x75, levels under 39 px (every sample clamps); rotation of
    exact-half-way cases (30 and 210 degrees) too: bit-exact against the
    twin, one launch."""
    rng = np.random.default_rng(h + w)
    sizes = ex.pyramid_sizes(h, w, 8, 1.2)
    counts = [217, 0, 150, 125, 0, 87, 72, 60]
    args = list(_brief_args(rng, sizes, counts, cuda))
    ang = torch.full((sum(counts),), 30.0, device=cuda)
    ang[1::2] = 210.0
    half = orient_brief.angle_cos_sin(ang)
    for ca, sa in ((args[3], args[4]), half):
        args[3], args[4] = ca, sa
        before = launch.LAUNCHES["brief"]
        got = ce.brief_levels(*args)
        want = ce.brief_levels_plain(*args)
        torch.cuda.synchronize()
        assert launch.LAUNCHES["brief"] == before + 1
        assert torch.equal(got, want)
    assert min(min(s) for s in sizes) < 39 or h == 480


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    img = torch.zeros((64, 64), device=cuda)
    with pytest.raises(ValueError):
        ce.dense_stage(img.double(), 20.0, 7.0, 16, 48, 16, 48)
    with pytest.raises(ValueError):
        ce.dense_stage(img.t()[:, :60], 20.0, 7.0, 16, 44, 16, 48)
    blurs, ys, xs, ca, sa, points, counts = _brief_args(np.random.default_rng(0), [(64, 64)],
                                                        [4], cuda)
    with pytest.raises(ValueError):
        ce.brief_levels(blurs, ys.long(), xs, ca, sa, points, counts)
    with pytest.raises(ValueError):
        ce.brief_levels(blurs, ys, xs, ca, sa, points, [3])              # counts != N
    with pytest.raises(ValueError):
        ce.brief_levels([img.t()], ys, xs, ca, sa, points, counts)       # not contiguous
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda)
    assert ce.brief_levels(blurs, empty, empty, ca[:0], sa[:0], points, [0]).shape == (0, 8)
    taps = ce.pack_pyramid_taps(ex.pyramid_taps(ex.pyramid_sizes(64, 64, 3, 1.2), cuda), (64, 64))
    with pytest.raises(ValueError):
        ce.pyramid(torch.zeros((64, 63), device=cuda), taps)           # taps of another size


def test_make_frame_rgbd_kernel_path_equals_twin_path(cuda, monkeypatch):
    rng = np.random.default_rng(3)
    h, w = 240, 320
    cfg = SlamConfig(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=w, height=h,
                     bf=65.0, sensor=SENSOR_RGBD, n_features=300, n_levels=4,
                     k1=0.05)
    gray = torch.from_numpy(_image(rng, h, w).astype(np.uint8)).to(cuda)
    depth = torch.from_numpy(rng.uniform(0.0, 4.0, (h, w)).astype(np.float32)).to(cuda)
    launch.reset_launches()
    got = frame_mod.make_frame_rgbd(gray, depth, cfg)
    torch.cuda.synchronize()
    assert launch.LAUNCHES == {**dict.fromkeys(launch.LAUNCHES, 0),
                               "pyramid": 1, "dense_stage": 1, "brief": 1}
    monkeypatch.setattr(ce, "pyramid", ce.pyramid_plain)
    monkeypatch.setattr(ce, "dense_stage_levels", ce.dense_stage_levels_plain)
    monkeypatch.setattr(ce, "brief_levels", ce.brief_levels_plain)
    want = frame_mod.make_frame_rgbd(gray, depth, cfg)
    torch.cuda.synchronize()
    assert int(got.valid.sum()) > 250
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


def _desc(rng, n, dev):
    words = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(dev)


@pytest.mark.parametrize("n,m,density", [(2048, 2048, 0.02), (130, 257, 0.5), (7, 1, 1.0)])
def test_best_two_kernel_bit_exact(cuda, n, m, density):
    """K4's node form: vocabulary nodes giving about this density of
    candidates (density 1: every node 0, the tracking fallback), invalid
    features, sources with node -1, near duplicates and ties."""
    args = _synthetic_node(np.random.default_rng(n + m), n, m, round(1 / density), cuda)
    before = launch.LAUNCHES["best_two_node"]
    got = cm.node_best_two(*args)
    want = cm.node_best_two_plain(*args)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["best_two_node"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] < cm.BIG).sum()) > 0
    assert bool((got[0][~args[2]] == cm.BIG).all()) and bool((got[1][~args[2]] == 0).all())


@pytest.mark.parametrize("rule", [(-1, 1), (0, cm.OPEN), (cm.OPEN, 0)])
def test_window_best_two_kernel_bit_exact(cuda, rule):
    """K4's window form at 2048 x 2048 under each octave rule (neither,
    forward, backward), with empty rows (radius 0) and forced ties: bit-exact
    against the twin, one launch."""
    args, expect = _synthetic_proj_tiles(np.random.default_rng(11), cuda, p=2048, n=2048)
    args[1][100::9] = 0.0
    args = args + (rule,)
    before = launch.LAUNCHES["best_two"]
    got = cm.window_best_two(*args)
    want = cm.window_best_two_plain(*args)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["best_two"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for row, triple in expect.items():
        assert tuple(int(t[row]) for t in got) == triple, row
    assert not bool((got[0][100::9] < cm.BIG).any()) and int((got[0] < 100).sum()) > 500


@pytest.mark.parametrize("m", [cm.PROJ_TILE + 1, 2 * cm.PROJ_TILE])
def test_window_best_two_kernel_above_one_tile(cuda, m):
    """K4's window form past one tile of staged targets (M = 8193: a last
    tile of one; 16,384: two full tiles), best and second in different
    tiles, empty rows: bit-exact against the twin; no cap on M."""
    args, expect = _synthetic_proj_tiles(np.random.default_rng(m), cuda, p=2048, n=m)
    args[1][100::9] = 0.0
    args = args + ((-1, 1),)
    got = cm.window_best_two(*args)
    want = cm.window_best_two_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for row, triple in expect.items():
        assert tuple(int(t[row]) for t in got) == triple, row


def test_reloc_window_search_kernel_bit_exact(cuda):
    """K4's window form as the relocalization rescue calls it
    (`matching.search_by_projection_reloc`): octaves (-1, +1), no stereo
    test (every source's right x -1), the targets' validity with the
    already-matched keypoints taken out: bit-exact against the twin, and
    the whole search's matches equal on both paths."""
    from orb_slam2_tpu_torch.ops import matching
    args, _ = _synthetic_proj_tiles(np.random.default_rng(12), cuda, p=2048, n=2048)
    uv, radius, level, _, valid, desc, kp_xy, kp_level, kp_ur, kp_valid, kp_desc = args
    already = torch.from_numpy(np.random.default_rng(13).random(2048) < 0.3).to(cuda)
    k4 = (uv, radius, level, torch.full_like(radius, -1.0), valid, desc, kp_xy, kp_level,
          kp_ur, (kp_valid & ~already).contiguous(), kp_desc, (-1, 1))
    got, want = cm.window_best_two(*k4), cm.window_best_two_plain(*k4)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    angle = torch.from_numpy(np.random.default_rng(14).uniform(0, 360, 2048)
                             .astype(np.float32)).to(cuda)
    sf = tuple(1.2 ** i for i in range(8))
    search = (uv, level, desc, valid, angle, kp_xy, kp_level, kp_desc, kp_valid, angle,
              already, sf)
    before = launch.LAUNCHES["best_two"]
    mm = matching.search_by_projection_reloc(*search, th=10.0, orb_dist=100)
    assert launch.LAUNCHES["best_two"] == before + 1
    cpu = matching.search_by_projection_reloc(*(t.cpu() if torch.is_tensor(t) else t
                                                for t in search), th=10.0, orb_dist=100)
    assert torch.equal(mm.idx.cpu(), cpu.idx) and torch.equal(mm.valid.cpu(), cpu.valid)
    assert int(mm.valid.sum()) > 100


def _proj_inputs(rng, p, n, dev):
    kp_xy = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    kp_level = rng.integers(0, 8, n).astype(np.int32)
    kp_ur = np.where(rng.random(n) < 0.5, kp_xy[:, 0] - rng.uniform(1, 30, n), -1.0)
    src = rng.integers(0, n, p)
    uv = (kp_xy[src] + rng.normal(0, 6, (p, 2))).astype(np.float32)
    p_ur = np.where(rng.random(p) < 0.5, uv[:, 0] - rng.uniform(1, 30, p), -1.0)
    t = lambda x, dt=None: torch.from_numpy(np.ascontiguousarray(x if dt is None else
                                                                 x.astype(dt))).to(dev)
    kp_desc = _desc(rng, n, dev)
    p_desc = kp_desc[torch.from_numpy(src).to(dev)] ^ _desc(rng, p, dev) & 0x01010101
    return (t(uv), t(rng.uniform(5, 60, p), np.float32),
            t(np.clip(kp_level[src] + rng.integers(0, 2, p), 0, 7), np.int32),
            t(p_ur, np.float32), t(rng.random(p) < 0.8), p_desc.contiguous(),
            t(kp_xy), t(kp_level), t(kp_ur, np.float32), t(rng.random(n) < 0.9), kp_desc)


@pytest.mark.parametrize("p,n", [(8192, 2048), (300, 100), (33, 1)])
def test_proj_match_kernel_bit_exact(cuda, p, n):
    args = _proj_inputs(np.random.default_rng(p + n), p, n, cuda)
    got = cm.projection_best_two(*args)
    want = cm.projection_best_two_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if n > 1:
        assert int((got[0] < 100).sum()) > p // 4 and int((got[2] < cm.BIG).sum()) > 0


def _proj_case(case, dev):
    """K5's adversarial inputs (P = 2048 points x N = 2048 keypoints unless
    the case says otherwise)."""
    rng = np.random.default_rng(7)
    p, n = {"n1": (500, 1), "n33": (500, 33), "p0": (0, 300)}.get(case, (2048, 2048))
    args = list(_proj_inputs(rng, p, n, dev))
    uv, radius, kp_xy = args[0], args[1], args[6]
    if case == "one_cell":                  # every keypoint in one 32 px cell
        kp_xy.copy_(torch.rand_like(kp_xy) * 31.0 + torch.tensor([96.0, 192.0], device=dev))
        uv.copy_(kp_xy[torch.randint(0, n, (p,), device=dev)] + torch.randn_like(uv) * 3)
    elif case == "whole_frame":             # windows wider than the frame
        radius.fill_(1000.0)
    elif case == "r0":
        radius.zero_()
    elif case == "nan_row":                 # valid rows with a NaN projection or radius
        args[4][:64] = True
        uv[:32, 0] = float("nan")
        radius[32:64] = float("nan")
    elif case == "outside":                 # keypoints and points outside the image
        kp_xy.mul_(1.5).sub_(160.0)
        uv.mul_(1.5).sub_(160.0)
    elif case == "ties":                    # every distance 0 or 1, duplicate keypoints
        args[10].copy_(args[10][:1].clone().expand(n, 8))
        args[5].copy_(args[10][:1].expand(p, 8) ^ (torch.arange(p, device=dev)[:, None] % 2
                                                   * (torch.arange(8, device=dev) == 0)))
        kp_xy[n // 2:] = kp_xy[: n - n // 2]
    return tuple(a.contiguous() for a in args)


@pytest.mark.parametrize("case", ["one_cell", "whole_frame", "r0", "nan_row", "outside", "n1",
                                  "n33", "p0", "ties"])
def test_proj_match_kernel_bit_exact_on_edge_cases(cuda, case):
    args = _proj_case(case, cuda)
    before = launch.LAUNCHES["proj_match"]
    got = cm.projection_best_two(*args)
    want = cm.projection_best_two_plain(*args)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["proj_match"] == before + (case != "p0")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case in ("one_cell", "whole_frame", "ties"):
        assert int((got[2] < cm.BIG).sum()) > 0 and int((got[0] < cm.BIG).sum()) > 100
    if case in ("r0", "p0"):
        assert not bool((got[0] < cm.BIG).any())


def _across_tiles(args):
    """For the first points (up to 64): a keypoint in the last tile of
    PROJ_TILE staged keypoints equal to the point, and one in tile 0 at the
    same place and octave that is equal too (even rows: a tie, which the
    lower column, in tile 0, wins, the second best 0 from the last tile) or
    one bit off (odd rows: the best in the last tile turns tile 0's best
    into the second best, 1). Returns the rows with their expected (best,
    index, second)."""
    n = args[6].shape[0]
    last = (n - 1) // cm.PROJ_TILE * cm.PROJ_TILE
    expect = {}
    for row, other in enumerate(range(last, min(n, last + 64))):
        first = 64 + row
        for k in (first, other):
            args[6][k], args[7][k], args[8][k], args[9][k] = args[0][row], args[2][row], -1.0, True
        args[10][first], args[10][other] = args[5][row], args[5][row]
        if row % 2:
            args[10][first][0] ^= 1
        args[1][row], args[4][row] = 6.0, True
        expect[row] = (0, first, 0) if row % 2 == 0 else (0, other, 1)
    return expect


@pytest.mark.parametrize("n", [cm.PROJ_TILE + 1, 2 * cm.PROJ_TILE, 20000])
def test_proj_match_kernel_bit_exact_above_one_tile(cuda, n):
    """K5 past one tile of staged keypoints: N = 8193 (a last tile of one),
    16,384 (two full tiles: an 8,000-feature setting's max_keypoints) and
    20,000 (three), with P = 8192 points, a tie across a tile border and a
    best that moves to a later tile: bit-exact against the twin, one
    launch."""
    args = list(_proj_inputs(np.random.default_rng(n), 8192, n, cuda))
    expect = _across_tiles(args)
    args = tuple(a.contiguous() for a in args)
    before = launch.LAUNCHES["proj_match"]
    got = cm.projection_best_two(*args)
    want = cm.projection_best_two_plain(*args)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["proj_match"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for row, triple in expect.items():
        assert tuple(int(t[row]) for t in got) == triple, row
    assert int((got[0] < 100).sum()) > 8192 // 4


def _pose_scene(rng, n, stereo, outliers, dev, bf=40.0):
    Xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 15, n)],
                  -1).astype(np.float32)
    xi = torch.tensor([0.1, -0.05, 0.08, 0.02, -0.03, 0.01])
    T_true = se3.exp(xi).numpy()
    pc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
    u = 500.0 * pc[:, 0] / pc[:, 2] + 320.0
    v = 500.0 * pc[:, 1] / pc[:, 2] + 240.0
    ur = np.where(rng.random(n) < 0.8, u - bf / pc[:, 2], -1.0) if stereo else -np.ones(n)
    obs = np.stack([u, v, ur], -1).astype(np.float32)
    k = int(outliers * n)
    obs[:k, :2] += (rng.uniform(20, 80, (k, 2)) * rng.choice([-1, 1], (k, 2))).astype(np.float32)
    obs[k:, :2] += rng.normal(0, 0.5, (n - k, 2)).astype(np.float32)
    level = rng.integers(0, 8, n)
    inv_s2 = (1.0 / 1.44 ** level).astype(np.float32)
    T0 = se3.orthonormalize(se3.retract(torch.from_numpy(T_true),
                                        torch.tensor([0.1, -0.08, 0.05, 0.03, -0.02, 0.04])))
    cam = camera_mod.Camera.make(500.0, 500.0, 320.0, 240.0, bf=bf if stereo else 0.0,
                                 device=dev)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (cam, T0.to(dev), t(Xw), t(obs), t(inv_s2), t(obs[:, 2] >= 0),
            t(rng.random(n) < 0.95)), T_true


@pytest.mark.parametrize("stereo,outliers,n", [(False, 0.0, 2048), (True, 0.2, 2048),
                                               (False, 0.2, 2048), (True, 0.2, 300)])
def test_pose_lm_kernel_within_tolerance(cuda, stereo, outliers, n):
    args, T_true = _pose_scene(np.random.default_rng(40 + stereo), n, stereo, outliers, cuda)
    T, inl, n_inl, chi2 = cp.pose_lm(*args, 4, 10)
    Tp, inl_p, n_p, chi2_p = cp.pose_lm_plain(*args, 4, 10)
    torch.cuda.synchronize()
    assert float((T - Tp).abs().max()) <= 1e-4
    assert float((T.cpu() - torch.from_numpy(T_true).float()).abs().max()) <= 2e-2
    d2 = torch.where(args[5], 7.815, 5.991)
    near = (chi2_p - d2).abs() <= 1e-3 * d2
    assert not bool(((inl != inl_p) & ~near).any())
    assert int(n_inl) == int(inl.sum()) and int(n_inl) > n // 2
    k = int(outliers * n)
    assert not bool(inl[:k].any())


@pytest.mark.parametrize("n", [1, 7, 2048, 5000])
def test_pose_lm_cluster_kernel_at_any_edge_count(cuda, n):
    """One stereo edge per thread of the 8-CTA cluster, threads with no edge
    (E = 1, 7), and edges beyond the cluster's 2048 looped over from global
    memory (E = 5000): Tcw within 1e-4 of the twin, the same inliers, and
    two launches equal bit for bit. One edge gives H of rank 3, so the pose
    is not unique: the kernel's sums equal the twin's bit for bit there (one
    term each), but its Cholesky and the twin's LU part along the null space
    (1.6e-4 on an H100), so E = 1 is held as the rank-deficient case is:
    a finite pose, the same inliers and the same residual error."""
    args, _ = _pose_scene(np.random.default_rng(70 + n), n, True, 0.0 if n < 10 else 0.2,
                          cuda)
    args = args[:6] + (torch.ones_like(args[6]),)
    got = cp.pose_lm(*args, 4, 10)
    again = cp.pose_lm(*args, 4, 10)
    Tp, inl_p, n_p, chi2_p = cp.pose_lm_plain(*args, 4, 10)
    torch.cuda.synchronize()
    T, inl, n_inl, chi2 = got
    if n == 1:
        assert bool(torch.isfinite(T).all())
        assert abs(float(chi2[inl].sum()) - float(chi2_p[inl_p].sum())) <= 1e-4
    else:
        assert float((T - Tp).abs().max()) <= 1e-4
    assert torch.equal(inl, inl_p) and int(n_inl) == int(n_p) == int(inl.sum())
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert int(n_inl) >= max(1, n // 2)


def test_pose_normal_eqs_kernel_within_tolerance(cuda):
    args, _ = _pose_scene(np.random.default_rng(50), 2048, True, 0.1, cuda)
    cam, T0, Xw, obs, inv_s2, st, valid = args
    Xw[:8, 2] = -0.5                     # behind the camera: invz guarded to 0
    mask = valid.to(torch.float32)
    for robust in (True, False):
        H, b, err = cp.pose_normal_eqs(cam, T0, Xw, obs, inv_s2, st, mask, robust)
        Hp, bp, errp = cp.pose_normal_eqs_plain(cam, T0, Xw, obs, inv_s2, st, mask, robust)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(H).all())
        torch.testing.assert_close(H, Hp, rtol=3e-4, atol=2e-3)
        torch.testing.assert_close(b, bp, rtol=3e-4, atol=2e-2)
        torch.testing.assert_close(err, errp, rtol=3e-4, atol=0.0)


@pytest.mark.parametrize("n", [1, 100, 2048, 5000])
@pytest.mark.parametrize("case", ["valid", "weights_with_zeros", "rank_deficient",
                                  "nan_point"])
@pytest.mark.parametrize("robust", [True, False])
def test_pose_normal_eqs_cluster_kernel(cuda, n, case, robust):
    """K7 as one cluster of 8 CTAs: threads with no edge (E = 1, 100), one
    edge per thread (2048) and edges looped past the cluster's width
    (5000); a 0/1 mask, float weights with zeros, 2 valid edges (H of rank
    4) and a NaN world point (err NaN on both sides), each robust and not:
    within the twin's tolerance, one launch, and two launches equal bit for
    bit (fixed-order sums, no atomics)."""
    args, _ = _pose_scene(np.random.default_rng(80 + n), n, True, 0.0 if n < 10 else 0.2,
                          cuda)
    cam, T0, Xw, obs, inv_s2, st, valid = args
    rng = np.random.default_rng(90 + n)
    mask = valid.to(torch.float32)
    if case == "weights_with_zeros":
        w = rng.uniform(0.1, 2.0, n) * (rng.random(n) < 0.7)
        mask = torch.from_numpy(w.astype(np.float32)).to(cuda)
    elif case == "rank_deficient":
        mask = torch.zeros_like(mask)
        mask[[0, n - 1]] = 1.0
    elif case == "nan_point":
        Xw[n // 2] = float("nan")
    before = launch.LAUNCHES["pose_normal_eqs"]
    got = cp.pose_normal_eqs(cam, T0, Xw, obs, inv_s2, st, mask, robust)
    again = cp.pose_normal_eqs(cam, T0, Xw, obs, inv_s2, st, mask, robust)
    H, b, err = got
    Hp, bp, errp = cp.pose_normal_eqs_plain(cam, T0, Xw, obs, inv_s2, st, mask, robust)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["pose_normal_eqs"] == before + 2
    for a, c in zip(got, again):
        assert torch.equal(a.nan_to_num(), c.nan_to_num())
        assert torch.equal(a.isnan(), c.isnan())
    torch.testing.assert_close(H, Hp, equal_nan=True, rtol=3e-4, atol=2e-3)
    torch.testing.assert_close(b, bp, equal_nan=True, rtol=3e-4, atol=2e-2)
    if case == "nan_point":
        assert bool(err.isnan()) and bool(errp.isnan())
    else:
        assert bool(torch.isfinite(H).all())
        torch.testing.assert_close(err, errp, rtol=3e-4, atol=0.0)


@pytest.mark.parametrize("case", ["rank_deficient", "nan_point"])
def test_pose_kernels_on_degenerate_edges(cuda, case):
    """Rank-deficient: 2 valid mono edges, H of rank 4, so the pose is not
    unique: a finite pose, the same inliers and the same residual error as
    the twin, and K7 within its tolerance. NaN point: every sweep's err is
    NaN (0 * NaN, as in the reference), so K6 rejects every step and keeps
    its seed, as the twin does; K7 there gives NaN err on both sides."""
    args, _ = _pose_scene(np.random.default_rng(60), 2048, case == "nan_point", 0.0, cuda)
    cam, T0, Xw, obs, inv_s2, st, valid = args
    if case == "rank_deficient":
        valid = torch.zeros_like(valid)
        valid[[100, 900]] = True
    else:
        Xw[700] = float("nan")
    args = (cam, T0, Xw, obs, inv_s2, st, valid)
    T, inl, n_inl, chi2 = cp.pose_lm(*args, 4, 10)
    Tp, inl_p, n_p, chi2_p = cp.pose_lm_plain(*args, 4, 10)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(T).all()) and torch.equal(inl, inl_p)
    assert abs(float(chi2[inl].sum()) - float(chi2_p[inl_p].sum())) <= 1e-4
    mask = valid.to(torch.float32)
    H, b, err = cp.pose_normal_eqs(cam, T0, Xw, obs, inv_s2, st, mask, True)
    Hp, bp, errp = cp.pose_normal_eqs_plain(cam, T0, Xw, obs, inv_s2, st, mask, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(H, Hp, equal_nan=True, rtol=3e-4, atol=2e-3)
    torch.testing.assert_close(b, bp, equal_nan=True, rtol=3e-4, atol=2e-2)
    if case == "rank_deficient":
        assert int(n_inl) == 2 and bool(torch.isfinite(H).all())
        torch.testing.assert_close(err, errp, rtol=3e-4, atol=0.0)
    else:
        assert torch.equal(T[:3], T0[:3]) and torch.equal(Tp[:3], T0[:3])
        assert bool(err.isnan()) and bool(errp.isnan())


def test_tracking_step_kernel_path_equals_twin_path(cuda, monkeypatch):
    """Initialization and two tracked frames at 240x320 on the card, through
    the kernels and then through the twins: the same poses and bindings."""
    h, w, fx = 240, 320, 260.0
    cfg = SlamConfig(fx=fx, fy=fx, cx=w / 2, cy=h / 2, width=w, height=h, bf=0.25 * fx,
                     sensor=SENSOR_RGBD, th_depth=40.0, n_features=300, max_keyframes=8,
                     max_map_points=4096, max_local_points=1024)
    world = PlateWorld(fx, fx, w / 2, h / 2, w, h, z0=5.0)
    images = []
    for T in loop_trajectory(181, radius=3.0, overshoot=0.5, spiral=0.12)[:3]:
        gray, depth = world.render_with_depth(T)
        images.append((torch.from_numpy(np.clip(np.round(gray), 0, 255).astype(np.uint8))
                       .to(cuda), torch.from_numpy(depth).to(cuda)))

    def run():
        f0 = frame_mod.make_frame_rgbd(*images[0], cfg)
        m = mapstate.empty(8, 4096, cfg.max_keypoints, device=cuda)
        eye = torch.eye(4, device=cuda)
        m, kf = mapping_ops.insert_keyframe(
            cfg, m, f0, eye, torch.full((cfg.max_keypoints,), -1, dtype=torch.int32,
                                        device=cuda), 0, 0.0, all_depth=True)
        lm = mapstate.take(m.kf_obs, kf)
        out, last, lp, lpv, T_last, vel = [], f0, m.pt_pos[lm.clamp(min=0).long()], lm >= 0, \
            eye, eye
        for i in (1, 2):
            r = tracking_step.full_tracking_step_from_images(
                cfg, m, images[i], last, lp, lpv, lm, T_last, vel, i > 1, kf, 30, "rgbd")
            out.append(r)
            m, last, lp, lpv, lm, T_last, vel, kf = (r.m, r.frame, r.next_pts,
                                                     r.next_pts_valid, r.matched_pt, r.Tcw,
                                                     r.next_vel, r.ref_kf)
        return out

    launch.reset_launches()
    got = run()
    torch.cuda.synchronize()
    for name in ("best_two", "proj_match", "pose_lm"):
        assert launch.LAUNCHES[name] >= 2, launch.LAUNCHES
    for name, twin in (("pyramid", ce.pyramid_plain),
                       ("dense_stage_levels", ce.dense_stage_levels_plain),
                       ("brief_levels", ce.brief_levels_plain),
                       ("window_best_two", cm.window_best_two_plain),
                       ("node_best_two", cm.node_best_two_plain),
                       ("projection_best_two", cm.projection_best_two_plain),
                       ("pose_lm", cp.pose_lm_plain)):
        monkeypatch.setattr(ce if name in ("pyramid", "dense_stage_levels", "brief_levels") else
                            cm if "best_two" in name else cp, name, twin)
    launch.reset_launches()
    want = run()
    torch.cuda.synchronize()
    assert not any(launch.LAUNCHES.values())
    for g, w in zip(got, want):
        assert bool(g.scalars[0]) and torch.equal(g.scalars[[0, 7, 8, 9]], w.scalars[[0, 7, 8, 9]])
        assert float((g.Tcw - w.Tcw).abs().max()) <= 1e-3
        assert float((g.matched_pt == w.matched_pt).float().mean()) >= 0.99


@pytest.mark.parametrize("b,n", [(10, 2048), (1, 256), (0, 64), (10, 4096)])
def test_epi_match_kernel_bit_exact(cuda, b, n):
    """K8 from the map's rows: ties, a neighbour with no candidate column,
    NaN lines and a clamped den (B >= 3), a map whose kf1 has no unbound
    feature; B = 0 (no launch), 1 and 10; N = 4096 (two column chunks):
    bit-exact against the twin."""
    rng = np.random.default_rng(n + b)
    for args in (_synthetic_epi(rng, b, n, cuda), _synthetic_epi(rng, b, n, cuda, True)):
        before = launch.LAUNCHES["epi_match"]
        got, want = cm.epi_match_keyframes(*args), cm.epi_match_keyframes_plain(*args)
        torch.cuda.synchronize()
        assert launch.LAUNCHES["epi_match"] == before + (b > 0)
        for g, w in zip(got, want):
            assert g.shape == (b, n) and torch.equal(g, w)
    args = _synthetic_epi(rng, b, n, cuda)
    hits = cm.epi_match_keyframes(*args)[0] < cm.BIG
    assert b == 0 or int(hits.sum()) > 0
    if b >= 3:
        assert not bool(hits[0].any()) and not bool(hits[1].any()) and int(hits[2].sum()) > 0


def _ba_problem(rng, q, o, c, dev, drop_cam=None):
    """K9's arguments at E = q * o edges: 16 cameras in c slots (slots 0-15,
    or every 32nd from slot 7 where c > 64; the rest empty), points 4-15 m
    ahead, 5 % behind their camera, 2 % of the edges padded (camera -1), 1 %
    masked, 30 % stereo; camera drop_cam's edges padded, with weight 1.
    Returns (cam, poses, points, pt_valid, edges, edge_mask)."""
    T = se3.exp(torch.from_numpy(rng.normal(0, 0.1, (c, 6)).astype(np.float32)))
    X = np.stack([rng.uniform(-3, 3, q), rng.uniform(-2, 2, q), rng.uniform(4, 15, q)], -1)
    X[: max(q // 20, 1), 2] = -1.5
    slots = np.arange(min(c, 16)) if c <= 64 else 7 + 32 * np.arange(16)
    obs_cam = slots[rng.integers(0, len(slots), (q, o))].astype(np.int32)
    obs_cam[rng.random((q, o)) < 0.02] = -1
    mask = rng.random((q, o)) > 0.01
    if drop_cam is not None:
        mask |= obs_cam == drop_cam
        obs_cam[obs_cam == drop_cam] = -1
    uvr = np.stack([rng.uniform(0, 640, (q, o)), rng.uniform(0, 480, (q, o)),
                    np.where(rng.random((q, o)) < 0.3, rng.uniform(0, 640, (q, o)), -1.0)], -1)
    t = lambda a, dt=np.float32: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    prob = schur_ba.BAProblem(
        poses=T.to(dev), cam_valid=torch.ones(c, dtype=torch.bool, device=dev),
        cam_fixed=torch.zeros(c, dtype=torch.bool, device=dev), points=t(X),
        pt_valid=t(rng.random(q) < 0.97, bool), obs_cam=t(obs_cam, np.int32), obs_uvr=t(uvr),
        obs_level=t(rng.integers(0, 8, (q, o)), np.int32))
    edges = schur_ba._edges(prob, t(1.0 / 1.44 ** rng.integers(0, 8, (q, o))))
    cam = camera_mod.Camera.make(517.3, 517.3, 320.0, 240.0, bf=129.3, device=dev)
    return cam, prob.poses, prob.points, prob.pt_valid, edges, t(mask)


def _lin_equal(got, want):
    """Every field equal bit for bit, NaN where the twin has NaN."""
    for name, a, b in zip(schur_ba.Lin._fields, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b)), name
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        assert torch.equal(a, b), (name, float((a.double() - b.double()).abs().max()))


@pytest.mark.parametrize("case", ["robust", "plain", "all_masked", "nan_point", "tiny",
                                  "empty_camera", "c512"])
def test_ba_edge_kernel_within_tolerance(cuda, case):
    """K9 as the whole assembly, at a tolerance of zero: one launch gives
    every `Lin` field bit for bit with its twin (the same per-edge float32
    operations, the same fixed summation order), and
    a second launch repeats it. Event size (4096 points x 12, 64 slots);
    every edge masked (err 0, all sums 0); a NaN point (err NaN, only its
    cameras' Hcc NaN); one point of one edge; cameras with no edge (zeros);
    512 slots, as global BA over the default `max_keyframes` hands it, with
    16 cameras in both of the chunk scan's 256-camera segments."""
    rng = np.random.default_rng(9)
    q, o, c = {"tiny": (1, 1, 2), "c512": (4096, 12, 512)}.get(case, (4096, 12, 64))
    cam, poses, points, pt_valid, edges, mask = _ba_problem(
        rng, q, o, c, cuda, 3 if case == "empty_camera" else None)
    robust = case != "plain"
    if case == "all_masked":
        mask = torch.zeros_like(mask)
    if case == "nan_point":
        points[7] = float("nan")
    args = (cam, poses, points, pt_valid, edges, mask, robust)
    before = launch.LAUNCHES["ba_edge"]
    got, again = cb.ba_assemble(*args), cb.ba_assemble(*args)
    want = cb.ba_assemble_plain(*args)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["ba_edge"] == before + 2
    _lin_equal(got, want)
    _lin_equal(got, again)
    lin = schur_ba.Lin(*got)
    if case == "nan_point":
        assert bool(lin.err.isnan())
        nan_cams = torch.isnan(lin.Hcc).any(dim=(1, 2))
        assert bool(nan_cams.any()) and not bool(nan_cams.all())
    elif case == "all_masked":
        assert float(lin.err) == 0.0 and not bool(lin.Hcc.any()) and not bool(lin.Hpp.any())
    elif case == "empty_camera":
        assert not bool(lin.Hcc[3].any()) and not bool(lin.bc[3].any())
        assert not bool(lin.Hcc[16:].any()) and bool(lin.Hcc[2].any())
    elif case == "c512":
        used = torch.zeros(c, dtype=torch.bool, device=cuda)
        used[7::32] = True
        assert bool(lin.Hcc[used].any(dim=(1, 2)).all()) and not bool(lin.Hcc[~used].any())
    else:
        assert bool(torch.isfinite(lin.err)) and (case == "tiny" or float(lin.err) > 0)


def test_ba_assemble_on_two_streams(cuda):
    """Assemblies in flight on two streams at once: each stream has its own
    arrival counters, and every result equals its twin bit for bit."""
    rng = np.random.default_rng(11)
    problems = [_ba_problem(rng, 4096, 12, 64, cuda) for _ in range(2)]
    streams = [torch.cuda.Stream(cuda) for _ in problems]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(8):
        for i, (s, args) in enumerate(zip(streams, problems)):
            with torch.cuda.stream(s):
                got[i].append(cb.ba_assemble(*args, True))
    torch.cuda.synchronize()
    bufs = {launch._counters("ba_edge", cuda, s.cuda_stream, 65).data_ptr() for s in streams}
    assert len(bufs) == 2
    for args, runs in zip(problems, got):
        want = cb.ba_assemble_plain(*args, True)
        for lin in runs:
            _lin_equal(lin, want)


def test_keyframe_pass_kernel_path_equals_twin_path(cuda, monkeypatch):
    """Initialization, four tracked frames and two keyframe events (local BA
    on the second) at 240x320 on the card, through the kernels and then
    through the twins: the same event statistics and map."""
    h, w, fx = 240, 320, 260.0
    cfg = SlamConfig(fx=fx, fy=fx, cx=w / 2, cy=h / 2, width=w, height=h, bf=0.25 * fx,
                     sensor=SENSOR_RGBD, th_depth=40.0, n_features=300, max_keyframes=16,
                     max_map_points=4096, max_local_points=1024, ba_local_cams=4,
                     ba_fixed_cams=4, ba_max_points=1024, ba_max_obs=8)
    world = PlateWorld(fx, fx, w / 2, h / 2, w, h, z0=5.0)
    images = []
    for T in loop_trajectory(181, radius=3.0, overshoot=0.5, spiral=0.12)[:5]:
        gray, depth = world.render_with_depth(T)
        images.append((torch.from_numpy(np.clip(np.round(gray), 0, 255).astype(np.uint8))
                       .to(cuda), torch.from_numpy(depth).to(cuda)))

    def run():
        f0 = frame_mod.make_frame_rgbd(*images[0], cfg)
        m = mapstate.empty(16, 4096, cfg.max_keypoints, device=cuda)
        eye = torch.eye(4, device=cuda)
        m, kf = mapping_ops.insert_keyframe(
            cfg, m, f0, eye, torch.full((cfg.max_keypoints,), -1, dtype=torch.int32,
                                        device=cuda), 0, 0.0, all_depth=True)
        lm = mapstate.take(m.kf_obs, kf)
        last, lp, lpv, T_last, vel = f0, m.pt_pos[lm.clamp(min=0).long()], lm >= 0, eye, eye
        summaries = []
        for i in range(1, 5):
            r = tracking_step.full_tracking_step_from_images(
                cfg, m, images[i], last, lp, lpv, lm, T_last, vel, i > 1, kf, 30, "rgbd")
            m, lm, lp, lpv, kf = r.m, r.matched_pt, r.next_pts, r.next_pts_valid, r.ref_kf
            if i % 2 == 0:
                m, _, summary = mapping_ops.keyframe_pass(cfg, m, r.frame, r.Tcw, r.matched_pt,
                                                          i, i / 30)
                summaries.append(summary)
                kf = summary[0]
                lm = mapstate.take(m.kf_obs, kf)
                lp, lpv = m.pt_pos[lm.clamp(min=0).long()], lm >= 0
            last, T_last, vel = r.frame, r.Tcw, r.next_vel
        return m, torch.stack(summaries)

    launch.reset_launches()
    m_k, s_k = run()
    torch.cuda.synchronize()
    assert launch.LAUNCHES["epi_match"] == 2 and launch.LAUNCHES["ba_edge"] == 17
    for mod, name, twin in ((ce, "pyramid", ce.pyramid_plain),
                            (ce, "dense_stage_levels", ce.dense_stage_levels_plain),
                            (ce, "brief_levels", ce.brief_levels_plain),
                            (cm, "window_best_two", cm.window_best_two_plain),
                            (cm, "node_best_two", cm.node_best_two_plain),
                            (cm, "projection_best_two", cm.projection_best_two_plain),
                            (cm, "epi_match_keyframes", cm.epi_match_keyframes_plain),
                            (cp, "pose_lm", cp.pose_lm_plain),
                            (cb, "ba_assemble", cb.ba_assemble_plain)):
        monkeypatch.setattr(mod, name, twin)
    launch.reset_launches()
    m_t, s_t = run()
    torch.cuda.synchronize()
    assert not any(launch.LAUNCHES.values())
    assert int(s_k[1, 6]) > 0                       # BA erased outliers
    assert float((s_k - s_t).abs().max()) <= 0.25 * float(s_k.abs().max())
    assert torch.equal(s_k[:, :4], s_t[:, :4])
    keep = m_k.pt_valid & m_t.pt_valid
    assert float(keep.float().mean()) >= 0.9 * float(m_k.pt_valid.float().mean())
    assert float((m_k.pt_pos[keep] - m_t.pt_pos[keep]).abs().max()) <= 1e-2


# ---------------------------------------------------------------------------
# Loop closing: K4 and K9 at the loop path's inputs, the loop path on the card
# ---------------------------------------------------------------------------

def test_window_best_two_kernel_open_octaves(cuda):
    """K4's window form as SearchBySim3 calls it (`matching.search_by_sim3`):
    both octave sides open, no stereo test (right x -1 on both sides), the
    projected depth folded into the sources' validity, at 2048 x 2048:
    bit-exact against the twin, one launch."""
    args, _ = _synthetic_proj_tiles(np.random.default_rng(5), cuda, p=2048, n=2048)
    args = list(args)
    args[3] = torch.full_like(args[3], -1.0)
    args[8] = torch.full_like(args[8], -1.0)
    behind = torch.from_numpy(np.random.default_rng(6).random(2048) < 0.2).to(cuda)
    args[4] = (args[4] & ~behind).contiguous()
    args = tuple(args) + ((cm.OPEN, cm.OPEN),)
    before = launch.LAUNCHES["best_two"]
    got = cm.window_best_two(*args)
    want = cm.window_best_two_plain(*args)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["best_two"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[0][behind] == cm.BIG).all()) and int((got[0] < 100).sum()) > 500


def test_ba_edge_kernel_at_the_global_ba_shape(cuda):
    """K9 at global BA's shape on the bench's capacities: C = 128 camera
    slots, Q x O = 16,384 x 12 = 196,608 edges, the robust kernel off:
    every `Lin` field bit for bit with its twin, and a second launch
    repeats it."""
    cam, poses, points, pt_valid, edges, mask = _ba_problem(np.random.default_rng(12), 16384,
                                                            12, 128, cuda)
    args = (cam, poses, points, pt_valid, edges, mask, False)
    got, again = cb.ba_assemble(*args), cb.ba_assemble(*args)
    want = cb.ba_assemble_plain(*args)
    torch.cuda.synchronize()
    _lin_equal(got, want)
    _lin_equal(got, again)
    assert bool(torch.isfinite(schur_ba.Lin(*got).err))


def _drifted_map(dev):
    """`tests/test_loop_closing.py`'s drifted map built with the port's
    map functions: two keyframes at one viewpoint, the second's pose and its
    own copies of the points carrying a 0.4 m drift (K = 16, P = 512,
    N = 64)."""
    K, P, N, fx = 16, 512, 64, 300.0
    cfg = SlamConfig(fx=fx, fy=fx, cx=160.0, cy=120.0, width=320, height=240, n_features=N,
                     max_keypoints=N, sensor=SENSOR_RGBD, bf=fx * 0.1, max_keyframes=K,
                     max_map_points=P, min_covis_weight=5)
    rng = np.random.default_rng(0)
    Xw = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1.0, 1.0, N),
                   rng.uniform(3.0, 5.0, N)], -1).astype(np.float32)
    desc = torch.from_numpy(rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32).view(np.int32))
    uv = np.stack([fx * Xw[:, 0] / Xw[:, 2] + 160, fx * Xw[:, 1] / Xw[:, 2] + 120], -1)
    ok = (uv[:, 0] > 10) & (uv[:, 0] < 310) & (uv[:, 1] > 10) & (uv[:, 1] < 230)
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a, dt)).to(dev)
    m = mapstate.empty(K, P, N, device=dev)
    drift = np.float32([0.4, 0.0, 0.1])
    for fid, (T, X) in enumerate(((np.eye(4), Xw), (np.eye(4), Xw + drift))):
        T = np.array(T, np.float32)
        if fid:
            T[:3, 3] = -drift
        m, k = mapstate.add_keyframe(m, t(T), t(uv, np.float32), t(np.zeros(N), np.int32),
                                     t(np.zeros(N), np.float32), desc.to(dev),
                                     t(np.full(N, -1.0), np.float32),
                                     t(np.full(N, -1.0), np.float32), t(ok),
                                     t(np.full(N, -1), np.int32), 10 * fid, 0.0)
        slots = mapstate.allocate_points(m, t(ok))
        m = mapstate.add_points(m, slots, t(X, np.float32), desc.to(dev), k, k)
        m = mapstate.bind_observations(m, k, t(np.arange(N)), slots, t(ok) & (slots >= 0))
    for k in (0, 1):
        m = mapstate.update_connections(m, torch.tensor(k, device=dev))
    m = mapstate.update_point_normals(m, torch.ones(P, dtype=torch.bool, device=dev),
                                      cfg.scale_factors)
    return cfg, m


def test_loop_path_on_the_card_equals_the_twins(cuda):
    """compute_sim3 (K4's node form on all pairs, RANSAC, K4's window form
    both ways, the refinement, the projection gate) and correct_loop (K5's
    loop fusion, the essential graph, global BA through K9) on the drifted
    map, on the card and on the CPU twins: the same decision, inlier count
    and loop edges; the Sim3 within 1e-4, the corrected poses and points
    within 1e-3 (cuSOLVER against LAPACK, cuBLAS against the CPU's sums)."""
    from orb_slam2_tpu_torch.pipeline import loop_closing as lc

    out = {}
    for dev in (torch.device("cpu"), cuda):
        cfg, m = _drifted_map(dev)
        ok, Scm, n_inl = lc.compute_sim3(cfg, m, 1, 0)
        assert ok
        out[dev.type] = (n_inl, Scm, lc.correct_loop(cfg, m, 1, 0, Scm, run_gba=True))
    (n_c, S_c, m_c), (n_g, S_g, m_g) = out["cpu"], out["cuda"]
    assert n_c == n_g > 40
    for f in ("R", "t", "s"):
        assert torch.allclose(getattr(S_g, f).cpu(), getattr(S_c, f), atol=1e-4), f
    assert torch.equal(m_g.loop_edges.cpu(), m_c.loop_edges)
    assert torch.allclose(m_g.kf_pose.cpu(), m_c.kf_pose, atol=1e-3)
    pv = m_c.pt_valid
    assert torch.equal(m_g.pt_valid.cpu(), pv)
    assert torch.allclose(m_g.pt_pos.cpu()[pv], m_c.pt_pos[pv], atol=1e-3)
