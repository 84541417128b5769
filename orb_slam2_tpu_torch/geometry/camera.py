"""Pinhole camera model with radial-tangential distortion (port of
`orb_slam2_tpu/geometry/camera.py`, the part the frame front end needs).

Camera parameters are float32 0-d tensors on the camera's device, so the
arithmetic is float32 as in the reference. `undistort_pixels` is
`cv::undistortPoints` as a fixed-iteration solve (reference
`src/Frame.cc:725-781`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    k3: torch.Tensor
    bf: torch.Tensor      # baseline * fx (0 for monocular)
    width: int
    height: int

    @staticmethod
    def make(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
             width=640, height=480, dtype=torch.float32, device="cuda"):
        f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return Camera(f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1), f(p2),
                      f(k3), f(bf), int(width), int(height))


def undistort_pixels(cam: Camera, uv, iters: int = 10):
    """cv::undistortPoints equivalent: distorted pixels -> undistorted pixels.

    Fixed-point iteration (compensate distortion by iterating
    x = (xd - dx(x)) / radial(x)), batched over the leading axes of uv."""
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xy = xx * yy
        dx = 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * xx * xx)
        dy = cam.p1 * (r2 + 2.0 * yy * yy) + 2.0 * cam.p2 * xy
        inv = 1.0 / torch.clamp(radial, min=1e-8)
        x = torch.stack([(xd[..., 0] - dx) * inv, (xd[..., 1] - dy) * inv], dim=-1)
    return torch.stack([x[..., 0] * cam.fx + cam.cx, x[..., 1] * cam.fy + cam.cy],
                       dim=-1)
