"""Keypoint orientation (intensity centroid) and steered-BRIEF descriptors
(port of `orb_slam2_tpu/ops/orient_brief.py`).

`ic_angles` replaces `IC_Angle` (`src/ORBextractor.cc:94-141`) with one
batched patch gather; `steered_brief` replaces `computeOrbDescriptor`
(`src/ORBextractor.cc:153-204`): the cosine and sine of each angle are
computed here, and the pattern rotation, sampling, comparison and bit
packing run in one kernel (`cuda_extract.brief_levels`, over every level of
a frame in `ORBExtractor`). Descriptors are 8 words per keypoint held as an
int32 view of the reference's uint32 bits (bit b of word w is pattern pair
w*32+b).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import cuda_extract

HALF_PATCH = 15  # intensity-centroid patch radius (src/ORBextractor.cc:80)
BRIEF_PATTERN_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "data", "brief_pattern.npy")

_DEG2RAD = np.float32(np.pi / 180)
_RAD2DEG = np.float32(180 / np.pi)


@functools.lru_cache(maxsize=None)
def umax_table() -> np.ndarray:
    """Row extents of the radius-15 circular patch, symmetric cvRound
    construction (`src/ORBextractor.cc:550-576`)."""
    umax = np.zeros(HALF_PATCH + 1, dtype=np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        # cvRound = round-half-to-even
        umax[v] = int(np.round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


@functools.lru_cache(maxsize=None)
def _circular_mask() -> np.ndarray:
    """(31,31) mask of the IC patch, and u-extent per row from umax."""
    umax = umax_table()
    mask = np.zeros((2 * HALF_PATCH + 1, 2 * HALF_PATCH + 1), dtype=np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        d = umax[abs(v)]
        mask[v + HALF_PATCH, HALF_PATCH - d: HALF_PATCH + d + 1] = 1.0
    return mask


def ic_weights() -> np.ndarray:
    """(2, 31, 31) float32 moment weights of the masked patch: u (for m10)
    and v (for m01)."""
    mask = _circular_mask()
    us = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
    return np.stack([us[None, :] * mask, us[:, None] * mask])


@functools.lru_cache(maxsize=None)
def brief_pattern() -> np.ndarray:
    """(256, 4) int32 sampling offsets (x0,y0,x1,y1) — the fixed learned ORB
    pattern (reference `src/ORBextractor.cc:209-467`), read from the port's
    own copy of the reference's data file."""
    return np.load(BRIEF_PATTERN_PATH)


def brief_points() -> np.ndarray:
    """(2, 512) float32 pattern points: row 0 x, row 1 y; columns 0..255 are
    the first point of each pair, 256..511 the second."""
    pat = brief_pattern()
    return np.stack([np.concatenate([pat[:, 0], pat[:, 2]]),
                     np.concatenate([pat[:, 1], pat[:, 3]])]).astype(np.float32)


def ic_angles(img, ys, xs, weights=None):
    """Intensity-centroid orientation for keypoints at integer (ys, xs).

    img: (H, W) float, at least 2 HALF_PATCH + 1 px each way; ys/xs: (N,)
    int32; weights: `ic_weights()` as a tensor on img's device (built here
    when None). A patch that would cross a border is moved inside it, as
    the reference's `dynamic_slice` clamps its start: a keypoint at least
    HALF_PATCH px from every border keeps its own patch (padded slots of a
    level under ~35 px are the ones moved). Returns angles in DEGREES
    [0, 360)."""
    if weights is None:
        weights = torch.as_tensor(ic_weights(), device=img.device)
    H, W = img.shape
    r = torch.arange(2 * HALF_PATCH + 1, device=img.device)
    y0 = torch.clamp(ys.long() - HALF_PATCH, 0, H - 2 * HALF_PATCH - 1)
    x0 = torch.clamp(xs.long() - HALF_PATCH, 0, W - 2 * HALF_PATCH - 1)
    flat = ((y0[:, None, None] + r[None, :, None]) * W
            + x0[:, None, None] + r[None, None, :])
    patch = img.reshape(-1)[flat]                      # (N, 31, 31)
    m10 = (patch * weights[0]).sum(dim=(1, 2))
    m01 = (patch * weights[1]).sum(dim=(1, 2))
    ang = torch.atan2(m01, m10) * _RAD2DEG
    return torch.where(ang < 0, ang + 360.0, ang)


def angle_cos_sin(angles_deg):
    """The float32 cosine and sine of angles in degrees, as the rotation of
    the pattern uses them."""
    theta = angles_deg * _DEG2RAD
    return torch.cos(theta), torch.sin(theta)


def rotated_offsets(angles_deg, points):
    """(N, 512) int32 (dx, dy): the pattern points rotated by each angle and
    rounded half-to-even (cvRound in `computeOrbDescriptor`,
    `src/ORBextractor.cc:170`)."""
    return cuda_extract.rotate_pattern(*angle_cos_sin(angles_deg), points)


def steered_brief(img_blur, ys, xs, angles_deg, points=None):
    """256-bit steered BRIEF descriptors as (N, 8) int32 words.

    img_blur: (H, W) float (9x9 sigma=2 blurred level image); keypoints at
    integer (ys, xs) with orientation in degrees; points: `brief_points()`
    as a tensor on img_blur's device (built here when None). The one-level
    case of `cuda_extract.brief_levels`."""
    if points is None:
        points = torch.as_tensor(brief_points(), device=img_blur.device)
    ca, sa = angle_cos_sin(angles_deg)
    return cuda_extract.brief_levels([img_blur], ys, xs, ca, sa, points, [ys.shape[0]])
