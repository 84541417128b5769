"""ORB feature extraction (port of `orb_slam2_tpu/ops/extractor.py`).

`ORBextractor::operator()` (`src/ORBextractor.cc:1543-1658`): 8-level
pyramid -> dense FAST score maps with dual-threshold cell fallback ->
uniform-grid budget selection -> intensity-centroid orientation -> 9x9
sigma=2 blur -> steered BRIEF. The output is a fixed-capacity `Keypoints`
record: every dynamic count of the reference becomes a validity mask, and
nothing waits on the device. Per frame the hot path launches each of its
kernels once over all levels: the pyramid (`cuda_extract.pyramid`), the
dense stage (`cuda_extract.dense_stage_levels`) and steered BRIEF
(`cuda_extract.brief_levels`, after every level's selection and angles).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..utils.config import SlamConfig, device_cache
from . import cuda_extract
from . import image as image_ops
from . import orient_brief
from . import select as select_ops

EDGE_THRESHOLD = 19  # src/ORBextractor.cc:81


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set for one image (capacity = sum of per-level
    budgets, padded to config.max_keypoints)."""

    xy: torch.Tensor       # (N, 2) float32 — level-0 (raw image) pixel coords
    level: torch.Tensor    # (N,) int32 — pyramid octave
    angle: torch.Tensor    # (N,) float32 — degrees [0, 360)
    response: torch.Tensor # (N,) float32 — FAST score
    desc: torch.Tensor     # (N, 8) int32 — packed 256-bit rBRIEF (uint32 bits)
    valid: torch.Tensor    # (N,) bool

    @property
    def n(self):
        return self.valid.to(torch.int32).sum()


def pyramid_sizes(height: int, width: int, n_levels: int, scale_factor: float):
    """Per-level (h, w) with cvRound of the ORIGINAL size each level
    (src/ORBextractor.cc:1664-1684)."""
    sizes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        # cvRound = half-to-even
        sizes.append((int(np.round(height * inv + 0.0)), int(np.round(width * inv))))
    return sizes


def pyramid_taps(sizes, device="cuda"):
    """Per level 1.. the (iy, wy, ix, wx) resize taps from the level before
    (`image._resize_taps`), as tensors on `device`."""
    taps = []
    for (ph, pw), (h, w) in zip(sizes[:-1], sizes[1:]):
        iy, wy = image_ops._resize_taps(ph, h)
        ix, wx = image_ops._resize_taps(pw, w)
        taps.append(tuple(torch.as_tensor(a, device=device) for a in (iy, wy, ix, wx)))
    return taps


def build_pyramid(img, cfg: SlamConfig, taps=None):
    """(H, W) float32 -> list of per-level images (cascaded bilinear
    resize, one kernel launch on the card). taps: `pyramid_taps`'s list or
    a `cuda_extract.PyramidTaps` (built here when None)."""
    if taps is None:
        sizes = pyramid_sizes(img.shape[0], img.shape[1], cfg.n_levels,
                              cfg.scale_factor)
        taps = pyramid_taps(sizes, img.device)
    return cuda_extract.pyramid(img, taps)


def level_region(h: int, w: int):
    """(min_bx, max_bx, min_by, max_by) of an h x w level: the borders of
    the reference's `ComputeKeyPointsOctTree`."""
    min_b = EDGE_THRESHOLD - 3
    return min_b, w - EDGE_THRESHOLD + 3, min_b, h - EDGE_THRESHOLD + 3


def detect_level(img, dense, budget: int, per_cell: int = 1, ic_weights=None):
    """One pyramid level and its dense stage's (score_nms, hi, blur) ->
    (ys, xs, resp, valid, angle, ys_safe, xs_safe), all (budget,): the
    selected keypoints, their orientation, and their coordinates with the
    padded slots moved to a safe interior pixel (what BRIEF samples around).
    ic_weights: the constant table of `ORBExtractor` on img's device (built
    per call when None)."""
    min_b, max_bx, _, max_by = level_region(*img.shape)
    score_nms, hi, _ = dense
    cand_score = cuda_extract.candidates_from_dense(
        score_nms, hi, min_b, max_bx, min_b, max_by)
    ys, xs, resp, valid = select_ops.select_uniform(
        cand_score, budget, min_b, max_bx, min_b, max_by, per_cell=per_cell)

    # clamp padded slots to a safe interior pixel so gathers stay in bounds
    ys_safe = torch.where(valid, ys, torch.full_like(ys, EDGE_THRESHOLD))
    xs_safe = torch.where(valid, xs, torch.full_like(xs, EDGE_THRESHOLD))

    angle = orient_brief.ic_angles(img, ys_safe, xs_safe, weights=ic_weights)
    return ys, xs, resp, valid, angle, ys_safe, xs_safe


class ORBExtractor(nn.Module):
    """Full ORB extraction for (height, width) images under one config. The
    constant tables (BRIEF pattern points, IC-angle moment weights, Gaussian
    taps, per-level resize taps) are buffers: built once, moved with
    `.to(device)`."""

    def __init__(self, cfg: SlamConfig, height: int = None, width: int = None):
        super().__init__()
        self.cfg = cfg
        self.height = cfg.height if height is None else height
        self.width = cfg.width if width is None else width
        self.budgets = cfg.features_per_level()
        n_total = sum(self.budgets)
        if cfg.max_keypoints < n_total:
            raise ValueError(f"max_keypoints {cfg.max_keypoints} < total budget {n_total}")
        self.per_cell = 2 if cfg.select_top2 else 1
        sizes = pyramid_sizes(self.height, self.width, cfg.n_levels, cfg.scale_factor)
        self.register_buffer("brief_points", torch.as_tensor(orient_brief.brief_points()))
        self.register_buffer("ic_weights", torch.as_tensor(orient_brief.ic_weights()))
        self.register_buffer("gauss", torch.as_tensor(image_ops._gaussian_kernel_1d(9, 2.0)))
        taps = cuda_extract.pack_pyramid_taps(pyramid_taps(sizes, "cpu"), sizes[0])
        for lvl, level in enumerate(taps.levels, start=1):
            for name, t in zip(("iy", "wy", "ix", "wx"), level):
                self.register_buffer(f"resize{lvl}_{name}", t)
        self.register_buffer("resize_itaps", taps.itaps)
        self.register_buffer("resize_ftaps", taps.ftaps)
        self._sizes, self._dims, self._taps = taps.sizes, taps.dims, None

    def _apply(self, fn, *args, **kwargs):
        self._taps = None                 # the buffers move: pack them anew
        return super()._apply(fn, *args, **kwargs)

    def pyramid_taps(self) -> cuda_extract.PyramidTaps:
        """The resize taps on the module's device, per level and packed."""
        if self._taps is None:
            levels = tuple(tuple(getattr(self, f"resize{lvl}_{n}") for n in ("iy", "wy", "ix", "wx"))
                           for lvl in range(1, self.cfg.n_levels))
            self._taps = cuda_extract.PyramidTaps(levels, self.resize_itaps, self.resize_ftaps,
                                                  self._sizes, self._dims)
        return self._taps

    def forward(self, img) -> Keypoints:
        """img: (H, W) float32 grayscale in [0, 255]."""
        return self.forward_with_pyramid(img)[0]

    def forward_with_pyramid(self, img):
        """`forward`, and the image's pyramid (the list of levels K1 built),
        for the stereo matcher's SAD, so no second pyramid is built."""
        if tuple(img.shape) != (self.height, self.width):
            raise ValueError(f"ORBExtractor for {self.height}x{self.width} images "
                             f"got {tuple(img.shape)}")
        cfg = self.cfg
        dev = img.device
        pyr = build_pyramid(img, cfg, taps=self.pyramid_taps())
        dense = cuda_extract.dense_stage_levels(
            pyr, cfg.ini_th_fast, cfg.min_th_fast,
            [level_region(*lv.shape) for lv in pyr], taps=self.gauss)
        xy_all, lvl_all, ang_all, resp_all, valid_all, ys_all, xs_all = ([] for _ in range(7))
        for lvl, (budget, s) in enumerate(zip(self.budgets, cfg.scale_factors)):
            ys, xs, resp, valid, angle, ys_safe, xs_safe = detect_level(
                pyr[lvl], dense[lvl], budget, per_cell=self.per_cell,
                ic_weights=self.ic_weights)
            xy_all.append(torch.stack([xs.to(torch.float32) * s,
                                       ys.to(torch.float32) * s], dim=-1))
            lvl_all.append(torch.full((budget,), lvl, dtype=torch.int32, device=dev))
            ang_all.append(angle)
            resp_all.append(resp)
            valid_all.append(valid)
            ys_all.append(ys_safe)
            xs_all.append(xs_safe)

        n_kp = sum(self.budgets)
        pad = cfg.max_keypoints - n_kp
        xy = torch.cat(xy_all + [torch.zeros((pad, 2), device=dev)])
        lvl = torch.cat(lvl_all + [torch.zeros((pad,), dtype=torch.int32, device=dev)])
        ang = torch.cat(ang_all + [torch.zeros((pad,), device=dev)])
        resp = torch.cat(resp_all + [torch.zeros((pad,), device=dev)])
        valid = torch.cat(valid_all + [torch.zeros((pad,), dtype=torch.bool, device=dev)])
        resp = torch.where(valid, resp, torch.zeros_like(resp))
        # steered BRIEF for every level at once: the cosine and sine of the
        # angles once per frame, then one kernel
        ca, sa = orient_brief.angle_cos_sin(ang[:n_kp])
        desc = cuda_extract.brief_levels([blur for _, _, blur in dense], torch.cat(ys_all),
                                         torch.cat(xs_all), ca, sa, self.brief_points,
                                         self.budgets)
        desc = torch.cat([desc, torch.zeros((pad, 8), dtype=torch.int32, device=dev)])
        return Keypoints(xy=xy, level=lvl, angle=ang, response=resp, desc=desc, valid=valid), pyr


@device_cache()
def extractor_for(cfg: SlamConfig, height: int, width: int, device) -> ORBExtractor:
    """The `ORBExtractor` of (cfg, image size) on `device`, built once."""
    return ORBExtractor(cfg, height, width).to(device)


def extract(img, cfg: SlamConfig) -> Keypoints:
    """Full ORB extraction. img: (H, W) float32 grayscale in [0, 255]."""
    return extractor_for(cfg, img.shape[0], img.shape[1], img.device)(img)


def extract_with_pyramid(img, cfg: SlamConfig):
    """`extract`, and the image's pyramid (`ORBExtractor.forward_with_pyramid`)."""
    return extractor_for(cfg, img.shape[0], img.shape[1], img.device).forward_with_pyramid(img)
