"""The frame front end's three CUDA kernels, their plain-PyTorch twins and
their wrappers (port of `orb_slam2_tpu/ops/pallas_extract.py`).

| wrapper       | kernel (csrc/)    | replaces (TPU kernel)                          | twin                |
|---------------|-------------------|------------------------------------------------|---------------------|
| `pyramid`     | `pyramid.cu`      | `pallas_extract.pyramid_pallas`                | `pyramid_plain`     |
| `dense_stage_levels` | `dense_stage.cu` | `pallas_extract.dense_stage_pallas` | `dense_stage_levels_plain` |
| `dense_stage` (one level) | `dense_stage.cu` | the same          | `dense_stage_plain` |
| `brief_levels` | `brief.cu`       | `pallas_extract.brief_sample_pallas` + rotation and packing | `brief_levels_plain` |

Each kernel is one launch per frame over every level.

Each wrapper dispatches on the device of its input (`launch.py`): a CPU
tensor runs the twin, a CUDA tensor launches the kernel on the current
stream or raises. There is no switch and no fallback; `launch.LAUNCHES`
counts the launches. The twins are written from the reference's XLA path
and are bit-identical to the kernels: every product and sum is rounded in
the same order on both sides (the kernels use `__fmul_rn`/`__fadd_rn`, so
no FMA).
"""
from __future__ import annotations

import ctypes
import itertools
from typing import NamedTuple

import torch

from . import fast as fast_ops
from . import image as image_ops
from .launch import check as _check, counters as _counters, launch as _launch
from .launch import on_cpu as _on_cpu, ptr as _p

NEG = float("-inf")
BRIEF_PAIRS = 256
_DENSE_PAD = 5     # the dense kernel's reflect-101 halo (blur 4, FAST 3, NMS +1)
_DENSE_MAX_LEVELS = 16
_MAX_LEVELS = 16   # the pyramid's output levels and BRIEF's levels per launch


# ---------------------------------------------------------------------------
# K1: pyramid (cascaded bilinear resize, one launch for all levels)
# ---------------------------------------------------------------------------

class PyramidTaps(NamedTuple):
    """The resize taps of a pyramid, per level and packed for the kernel:
    built once per image size (`pack_pyramid_taps`), not per call."""

    levels: tuple       # per level 1..: (iy (2, h) int32, wy (2, h) f32, ix (2, w), wx (2, w))
    itaps: torch.Tensor  # per level 1..: its iy then its ix, flattened, int32
    ftaps: torch.Tensor  # per level 1..: its wy then its wx, flattened, float32
    sizes: tuple        # (h, w) of levels 0..
    dims: object        # the same sizes as a ctypes int array, for the launcher


def pack_pyramid_taps(levels, size0):
    """`PyramidTaps` from the per-level `(iy, wy, ix, wx)` list of an image of
    size0 = (h, w) (`extractor.pyramid_taps`), on the taps' device."""
    levels = tuple(tuple(t) for t in levels)
    sizes = (tuple(int(v) for v in size0),) + tuple(
        (iy.shape[1], ix.shape[1]) for iy, _, ix, _ in levels)
    itaps = torch.cat([t.reshape(-1) for iy, _, ix, _ in levels for t in (iy, ix)])
    ftaps = torch.cat([t.reshape(-1) for _, wy, _, wx in levels for t in (wy, wx)])
    dims = (ctypes.c_int * (2 * len(sizes)))(*[v for hw in sizes for v in hw])
    return PyramidTaps(levels, itaps, ftaps, sizes, dims)


def pyramid_plain(img, taps):
    """(H, W) float32 -> list of n_levels images (level 0 = img itself),
    each level resized from the one before with its `(iy, wy, ix, wx)` taps
    (`image._resize_taps`). taps: that per-level list, or `PyramidTaps`."""
    pyr = [img]
    for iy, wy, ix, wx in (taps.levels if isinstance(taps, PyramidTaps) else taps):
        pyr.append(image_ops.resize_taps(pyr[-1], iy, wy, ix, wx))
    return pyr


def pyramid(img, taps):
    """Kernel wrapper of `pyramid_plain`: one launch for every level
    (`csrc/pyramid.cu`). The levels are views into one allocation of
    sum(h*w) float32. taps: a `PyramidTaps` (a per-level list is packed
    here, per call)."""
    if _on_cpu(img):
        return pyramid_plain(img, taps)
    if not isinstance(taps, PyramidTaps):
        taps = pack_pyramid_taps(taps, img.shape)
    dev = img.device
    n = len(taps.sizes) - 1
    if not 1 <= n <= _MAX_LEVELS:
        raise ValueError(f"pyramid: {n} levels to build (1 to {_MAX_LEVELS})")
    n_px = [h * w for h, w in taps.sizes[1:]]
    _check(img, torch.float32, taps.sizes[0], dev, "pyramid img")
    _check(taps.itaps, torch.int32, (2 * sum(map(sum, taps.sizes[1:])),), dev, "pyramid itaps")
    _check(taps.ftaps, torch.float32, taps.itaps.shape, dev, "pyramid ftaps")
    counters = _counters("pyramid", dev, sum(h for h, _ in taps.sizes[1:]) + 2)  # a flag a row
    out = torch.empty((sum(n_px),), dtype=torch.float32, device=dev)
    _launch("pyramid", "orb_pyramid", dev, n, taps.dims, _p(img), _p(out), _p(taps.itaps),
            _p(taps.ftaps), _p(counters))
    return [img] + [lv.view(hw) for lv, hw in zip(out.split(n_px), taps.sizes[1:])]


# ---------------------------------------------------------------------------
# K2: dense stage (FAST score + masked 3x3 NMS + thresholds + 9x9 blur)
# ---------------------------------------------------------------------------

def dense_stage_plain(img, ini_th: float, min_th: float,
                      min_bx: int, max_bx: int, min_by: int, max_by: int,
                      taps=None):
    """(H, W) float32 -> (score_nms, hi, blur), each (H, W) float32:
    `score_nms` is the FAST score where the pixel is a low-threshold corner
    inside the detection region that survives 3x3 NMS of the masked score
    (ties kept), else -inf; `hi` is 1.0 where the score clears the high
    threshold inside the region, else 0.0; `blur` is the 9x9 sigma=2
    reflect-101 Gaussian. The per-cell fallback is `candidates_from_dense`."""
    h, w = img.shape
    score = fast_ops.fast_score_map(img)
    in_region = fast_ops.detection_region(h, w, min_bx, max_bx, min_by, max_by,
                                          img.device)
    lo = (score > min_th) & in_region
    keep = fast_ops.nms3x3(torch.where(lo, score, torch.zeros_like(score)))
    score_nms = torch.where(lo & keep, score, torch.full_like(score, NEG))
    hi = ((score > ini_th) & in_region).to(torch.float32)
    return score_nms, hi, image_ops.gaussian_blur(img, taps=taps)


def dense_stage_levels_plain(levels, ini_th: float, min_th: float, regions, taps=None):
    """`dense_stage_plain` on each level: levels a list of (H, W) float32
    images, regions their (min_bx, max_bx, min_by, max_by). Returns one
    (score_nms, hi, blur) per level."""
    return [dense_stage_plain(img, ini_th, min_th, *region, taps=taps)
            for img, region in zip(levels, regions)]


def dense_stage_levels(levels, ini_th: float, min_th: float, regions, taps=None):
    """Kernel wrapper of `dense_stage_levels_plain`: one launch over the
    tiles of every level (`csrc/dense_stage.cu`). The outputs are views into
    one allocation of 3 x sum(H*W) float32. taps: the (9,) float32 Gaussian
    taps on the levels' device (built here when None)."""
    if _on_cpu(levels[0]):
        return dense_stage_levels_plain(levels, ini_th, min_th, regions, taps)
    dev = levels[0].device
    if len(levels) != len(regions) or not 1 <= len(levels) <= _DENSE_MAX_LEVELS:
        raise ValueError(f"dense_stage_levels: {len(levels)} levels and {len(regions)} "
                         f"regions (1 to {_DENSE_MAX_LEVELS} levels)")
    if taps is None:
        taps = torch.as_tensor(image_ops._gaussian_kernel_1d(9, 2.0), device=dev)
    _check(taps, torch.float32, (9,), dev, "dense_stage taps")
    sizes = [tuple(img.shape) for img in levels]
    for lvl, (img, (h, w)) in enumerate(zip(levels, sizes)):
        if img.dim() != 2 or h <= _DENSE_PAD or w <= _DENSE_PAD:
            raise ValueError(f"dense_stage: level {lvl} of shape {tuple(img.shape)} is too "
                             f"small for the {_DENSE_PAD}-px reflect halo")
        _check(img, torch.float32, (h, w), dev, f"dense_stage level {lvl}")
    n_px = [h * w for h, w in sizes]
    buf = torch.empty((3, sum(n_px)), dtype=torch.float32, device=dev)
    outs = [tuple(part.view(h, w) for part in buf[:, off:off + n].unbind(0))
            for off, n, (h, w) in zip(itertools.accumulate([0] + n_px), n_px, sizes)]
    ptrs = (ctypes.c_uint64 * (4 * len(levels)))(*[
        t.data_ptr() for img, out in zip(levels, outs) for t in (img, *out)])
    dims = (ctypes.c_int * (6 * len(levels)))(*[
        int(v) for (h, w), region in zip(sizes, regions) for v in (h, w, *region)])
    _launch("dense_stage", "orb_dense_stage_levels", dev, len(levels), ptrs, dims, _p(taps),
            float(ini_th), float(min_th))
    return outs


def dense_stage(img, ini_th: float, min_th: float,
                min_bx: int, max_bx: int, min_by: int, max_by: int, taps=None):
    """Kernel wrapper of `dense_stage_plain`: `dense_stage_levels` on one
    level."""
    return dense_stage_levels([img], ini_th, min_th, [(min_bx, max_bx, min_by, max_by)],
                              taps)[0]


def candidates_from_dense(score_nms, hi, min_bx: int, max_bx: int,
                          min_by: int, max_by: int, cell: int = 30):
    """The reference's per-cell dual-threshold fallback on the dense stage's
    outputs (`src/ORBextractor.cc:1092-1138`): cells that contain a
    high-threshold corner keep only those; others fall back to
    low-threshold corners. Returns the (H, W) masked score for
    `select.select_uniform` (-inf elsewhere)."""
    hi_b = hi > 0.5
    use_lo = fast_ops.cell_fallback(hi_b, min_bx, max_bx, min_by, max_by, cell)
    return torch.where(hi_b | use_lo, score_nms, torch.full_like(score_nms, NEG))


# ---------------------------------------------------------------------------
# K3: steered BRIEF (rotate the pattern, sample, compare pairs, pack bits)
# ---------------------------------------------------------------------------

def rotate_pattern(ca, sa, points):
    """(N, 512) int32 (dx, dy): the pattern points (2, 512) rotated by the
    angles whose cosine and sine are ca, sa (N,), rounded half-to-even
    (cvRound in `computeOrbDescriptor`, `src/ORBextractor.cc:170`): every
    product, then the difference or sum, each rounded to float32."""
    px, py = points[0][None, :], points[1][None, :]
    ca, sa = ca[:, None], sa[:, None]
    dx = torch.round(px * ca - py * sa).to(torch.int32)
    dy = torch.round(px * sa + py * ca).to(torch.int32)
    return dx, dy


def brief_plain(blur, ys, xs, dx, dy):
    """One level: (N, 8) int32 descriptor words: bit b of word w is
    blur[ys+dy[p], xs+dx[p]] < blur[ys+dy[p+256], xs+dx[p+256]] with
    p = w*32+b, coordinates clamped into the image. ys/xs (N,) int32;
    dx/dy (N, 512) int32. The words are the int32 view of the reference's
    uint32 words."""
    H, W = blur.shape
    gy = torch.clamp(ys[:, None].long() + dy.long(), 0, H - 1)
    gx = torch.clamp(xs[:, None].long() + dx.long(), 0, W - 1)
    vals = blur.reshape(-1)[gy * W + gx]                        # (N, 512)
    bits = (vals[:, :BRIEF_PAIRS] < vals[:, BRIEF_PAIRS:]).reshape(-1, 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=blur.device)
    words = (bits.to(torch.int64) << shifts).sum(dim=-1)       # [0, 2^32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def brief_levels_plain(blurs, ys, xs, ca, sa, points, counts):
    """Steered BRIEF over the levels of a frame: blurs the (h, w) blurred
    levels; ys, xs (N,) int32 and ca, sa (N,) float32 (the cosine and sine
    of each keypoint's angle) for counts[l] keypoints of each level l, one
    level after another; points the (2, 512) pattern. Returns (N, 8) int32:
    `rotate_pattern` and `brief_plain` on each level."""
    out, k = [], 0
    for blur, c in zip(blurs, counts):
        dx, dy = rotate_pattern(ca[k:k + c], sa[k:k + c], points)
        out.append(brief_plain(blur, ys[k:k + c], xs[k:k + c], dx, dy))
        k += c
    return torch.cat(out) if out else torch.zeros((0, 8), dtype=torch.int32, device=ys.device)


def brief_levels(blurs, ys, xs, ca, sa, points, counts):
    """Kernel wrapper of `brief_levels_plain`: one launch over the
    keypoints of every level (`csrc/brief.cu`), which rotates the pattern
    itself; no offset table is made."""
    if _on_cpu(ys):
        return brief_levels_plain(blurs, ys, xs, ca, sa, points, counts)
    dev, n = ys.device, ys.shape[0]
    counts = [int(c) for c in counts]
    if len(blurs) != len(counts) or not 1 <= len(blurs) <= _MAX_LEVELS \
            or min(counts) < 0 or sum(counts) != n:
        raise ValueError(f"brief_levels: {len(blurs)} levels, keypoint counts {counts} for "
                         f"{n} keypoints (1 to {_MAX_LEVELS} levels)")
    for t, dtype, shape, name in ((ys, torch.int32, (n,), "ys"), (xs, torch.int32, (n,), "xs"),
                                  (ca, torch.float32, (n,), "ca"),
                                  (sa, torch.float32, (n,), "sa"),
                                  (points, torch.float32, (2, 2 * BRIEF_PAIRS), "points")):
        _check(t, dtype, shape, dev, f"brief_levels {name}")
    for lvl, blur in enumerate(blurs):
        if blur.dim() != 2:
            raise ValueError(f"brief_levels: level {lvl} of shape {tuple(blur.shape)}")
        _check(blur, torch.float32, blur.shape, dev, f"brief_levels blur {lvl}")
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    ptrs = (ctypes.c_uint64 * len(blurs))(*[b.data_ptr() for b in blurs])
    dims = (ctypes.c_int * (3 * len(blurs)))(*[
        v for b, c in zip(blurs, counts) for v in (b.shape[0], b.shape[1], c)])
    _launch("brief", "orb_brief_levels", dev, len(blurs), ptrs, dims, _p(ys), _p(xs), _p(ca),
            _p(sa), _p(points), _p(out))
    return out
