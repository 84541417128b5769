"""The frame front end's three CUDA kernels, their plain-PyTorch twins and
their wrappers (port of `orb_slam2_tpu/ops/pallas_extract.py`).

| wrapper       | kernel (csrc/)    | replaces (TPU kernel)                          | twin                |
|---------------|-------------------|------------------------------------------------|---------------------|
| `pyramid`     | `pyramid.cu`      | `pallas_extract.pyramid_pallas`                | `pyramid_plain`     |
| `dense_stage_levels` | `dense_stage.cu` | `pallas_extract.dense_stage_pallas` | `dense_stage_levels_plain` |
| `dense_stage` (one level) | `dense_stage.cu` | the same          | `dense_stage_plain` |
| `brief`       | `brief.cu`        | `pallas_extract.brief_sample_pallas` + packing | `brief_plain`       |

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

import torch

from . import fast as fast_ops
from . import image as image_ops
from .launch import check as _check, launch as _launch, on_cpu as _on_cpu, ptr as _p

NEG = float("-inf")
BRIEF_PAIRS = 256
_DENSE_PAD = 5     # the dense kernel's reflect-101 halo (blur 4, FAST 3, NMS +1)
_DENSE_MAX_LEVELS = 16


# ---------------------------------------------------------------------------
# K1: pyramid (cascaded bilinear resize, one launch per level)
# ---------------------------------------------------------------------------

def pyramid_plain(img, taps):
    """(H, W) float32 -> list of n_levels images (level 0 = img itself),
    each level resized from the one before with its `(iy, wy, ix, wx)` taps
    (`image._resize_taps`)."""
    pyr = [img]
    for iy, wy, ix, wx in taps:
        pyr.append(image_ops.resize_taps(pyr[-1], iy, wy, ix, wx))
    return pyr


def pyramid(img, taps):
    """Kernel wrapper of `pyramid_plain`."""
    if _on_cpu(img):
        return pyramid_plain(img, taps)
    pyr = [img]
    for iy, wy, ix, wx in taps:
        src = pyr[-1]
        sh, sw = src.shape
        h, w = iy.shape[1], ix.shape[1]
        _check(src, torch.float32, (sh, sw), img.device, "pyramid src")
        _check(iy, torch.int32, (2, h), img.device, "pyramid iy")
        _check(wy, torch.float32, (2, h), img.device, "pyramid wy")
        _check(ix, torch.int32, (2, w), img.device, "pyramid ix")
        _check(wx, torch.float32, (2, w), img.device, "pyramid wx")
        out = torch.empty((h, w), dtype=torch.float32, device=img.device)
        _launch("pyramid", "orb_resize_level", img.device, _p(src), sh, sw,
                _p(out), h, w, _p(iy), _p(wy), _p(ix), _p(wx))
        pyr.append(out)
    return pyr


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
# K3: steered BRIEF (sample 512 rotated points, compare pairs, pack bits)
# ---------------------------------------------------------------------------

def brief_plain(blur, ys, xs, dx, dy):
    """(N, 8) int32 descriptor words: bit b of word w is
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


def brief(blur, ys, xs, dx, dy):
    """Kernel wrapper of `brief_plain`."""
    if _on_cpu(blur):
        return brief_plain(blur, ys, xs, dx, dy)
    H, W = blur.shape
    n = ys.shape[0]
    _check(blur, torch.float32, (H, W), blur.device, "brief blur")
    for t, shape, name in ((ys, (n,), "ys"), (xs, (n,), "xs"),
                           (dx, (n, 2 * BRIEF_PAIRS), "dx"),
                           (dy, (n, 2 * BRIEF_PAIRS), "dy")):
        _check(t, torch.int32, shape, blur.device, f"brief {name}")
    out = torch.empty((n, 8), dtype=torch.int32, device=blur.device)
    if n == 0:
        return out
    _launch("brief", "orb_brief", blur.device, _p(blur), H, W, _p(ys), _p(xs), _p(dx),
            _p(dy), n, _p(out))
    return out
