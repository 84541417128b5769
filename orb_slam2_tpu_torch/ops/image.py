"""Image primitives replacing the reference's OpenCV calls (port of
`orb_slam2_tpu/ops/image.py`).

- grayscale conversion (`src/Tracking.cc:252-278`, cv::cvtColor's weights)
- 9x9 sigma=2 Gaussian blur with BORDER_REFLECT_101 (`src/ORBextractor.cc:1609-1615`)
- bilinear resize with OpenCV's pixel-center convention (`src/ORBextractor.cc:1686-1691`)

All float32. Each product and sum is a separate elementwise op in a fixed
order, so these are bit-identical on every device and to the CUDA kernels
that replace them on the hot path (`ops/cuda_extract.py`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def rgb_to_gray(img, bgr: bool = False):
    """(H,W,3) -> (H,W) float32 with OpenCV's weights 0.299 / 0.587 / 0.114
    (RGB order; bgr=True for OpenCV's channel order)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=img.device)
    if bgr:
        w = w.flip(0)
    return torch.tensordot(img.to(torch.float32), w, dims=([-1], [0]))


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel for ksize>=7 (computed, not table-based)."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, ksize: int = 9, sigma: float = 2.0, taps=None):
    """Separable Gaussian on a (H, W) float image, reflect-101 borders: the
    rows pass first, then the columns, each a left fold from tap 0 — the
    accumulation order of the reference's `image.gaussian_blur`. taps: the
    (ksize,) float32 `_gaussian_kernel_1d(ksize, sigma)` as a tensor on
    img's device, where the caller holds one."""
    k = [float(v) for v in _gaussian_kernel_1d(ksize, sigma)] if taps is None else taps
    pad = ksize // 2
    h, w = img.shape
    x = F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]
    rows = k[0] * x[0:h, :]
    for i in range(1, ksize):
        rows = rows + k[i] * x[i:i + h, :]
    out = k[0] * rows[:, 0:w]
    for i in range(1, ksize):
        out = out + k[i] * rows[:, i:i + w]
    return out


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, OpenCV pixel-center
    convention: src = (dst+0.5)*scale - 0.5, clamped."""
    scale = n_in / n_out
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(s), 0, n_in - 1)
    w1 = np.clip(s - i0, 0.0, 1.0)
    i0 = i0.astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    M = np.zeros((n_out, n_in), dtype=np.float32)
    M[np.arange(n_out), i0] += (1.0 - w1).astype(np.float32)
    M[np.arange(n_out), i1] += w1.astype(np.float32)
    return M


@functools.lru_cache(maxsize=None)
def _resize_taps(n_in: int, n_out: int):
    """The two nonzero taps of each row of `_resize_matrix(n_in, n_out)`:
    idx (2, n_out) int32 and weight (2, n_out) float32. Where both taps
    clamp onto one source pixel, tap 0 carries the matrix's merged float32
    weight (1-w1)+w1 and tap 1 weighs 0, so the 2-tap sum equals the row's
    dot product."""
    M = _resize_matrix(n_in, n_out)
    scale = n_in / n_out
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.clip(np.floor(s), 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    rows = np.arange(n_out)
    w0 = M[rows, i0]
    w1 = np.where(i1 == i0, np.float32(0), M[rows, i1]).astype(np.float32)
    return (np.stack([i0, i1]).astype(np.int32),
            np.stack([w0, w1]).astype(np.float32))


def resize_taps(img, iy, wy, ix, wx):
    """2-tap separable resize: rows first (out = Ry @ img), then columns
    (@ Rx^T), each output w0*a + w1*b with the taps of `_resize_taps`."""
    iy, ix = iy.long(), ix.long()
    tmp = wy[0][:, None] * img[iy[0], :] + wy[1][:, None] * img[iy[1], :]
    return wx[0][None, :] * tmp[:, ix[0]] + wx[1][None, :] * tmp[:, ix[1]]


def resize_bilinear(img, out_h: int, out_w: int):
    """cv::resize INTER_LINEAR on float32 (the reference's exact f32 path,
    `resize_bilinear(fast=False)`)."""
    in_h, in_w = img.shape
    iy, wy = (torch.as_tensor(a, device=img.device) for a in _resize_taps(in_h, out_h))
    ix, wx = (torch.as_tensor(a, device=img.device) for a in _resize_taps(in_w, out_w))
    return resize_taps(img, iy, wy, ix, wx)
