"""Pinhole camera model with radial-tangential distortion (port of
`orb_slam2_tpu/geometry/camera.py`).

Camera parameters are float32 0-d tensors on the camera's device, so the
arithmetic is float32 as in the reference. `undistort_pixels` is
`cv::undistortPoints` as a fixed-iteration solve (reference
`src/Frame.cc:725-781`); projection uses the stereo model u_r = u - bf/z
(`src/Frame.cc:1185-1200`). Every function is batched over the leading
axes of its point tensor.
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

    @property
    def baseline(self):
        return self.bf / self.fx

    @property
    def has_distortion(self):
        return any(bool(c != 0) for c in (self.k1, self.k2, self.p1, self.p2, self.k3))


def distort_normalized(cam: Camera, xn):
    """Apply distortion to normalized coords xn=(...,2) -> distorted normalized."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy = x * y
    dx = 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x * x)
    dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * xy
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


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


def _inv_z(z):
    return 1.0 / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)


def project(cam: Camera, pc):
    """Camera-frame 3D points (...,3) -> undistorted pixel coords (...,2).
    Matching and BA work on undistorted keypoints, so no distortion is
    applied (`Frame::isInFrustum`, `src/Frame.cc:490-580`)."""
    inv_z = _inv_z(pc[..., 2])
    return torch.stack([pc[..., 0] * inv_z * cam.fx + cam.cx,
                        pc[..., 1] * inv_z * cam.fy + cam.cy], dim=-1)


def project_stereo(cam: Camera, pc):
    """(...,3) -> (...,3) of (uL, vL, uR) with uR = uL - bf/z."""
    uv = project(cam, pc)
    ur = uv[..., 0] - cam.bf * _inv_z(pc[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(cam: Camera, uv, depth):
    """Undistorted pixels + depth -> camera-frame 3D (`Frame::UnprojectStereo`,
    `src/Frame.cc:1185-1222`)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def image_bounds(cam: Camera):
    """Undistorted image bounds (minX, maxX, minY, maxY) from the four warped
    corners (`Frame::ComputeImageBounds`, `src/Frame.cc:783-829`)."""
    corners = torch.tensor([[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height],
                            [cam.width, cam.height]], dtype=torch.float32, device=cam.fx.device)
    und = undistort_pixels(cam, corners)
    return (torch.minimum(und[0, 0], und[2, 0]), torch.maximum(und[1, 0], und[3, 0]),
            torch.minimum(und[0, 1], und[1, 1]), torch.maximum(und[2, 1], und[3, 1]))
