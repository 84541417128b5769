"""Stereo undistort + rectify maps for the EuRoC front end (port of
`orb_slam2_tpu/geometry/rectify.py`, NumPy copied whole).

Replicates what the reference gets from OpenCV in
`Examples/Stereo/stereo_euroc.cc:121-176`: the settings YAML carries
per-camera `LEFT.{K,D,R,P}` / `RIGHT.{K,D,R,P}` calibration nodes,
`cv::initUndistortRectifyMap` turns them into dense lookup maps once at
startup, and `cv::remap` (bilinear) rectifies every incoming frame before ORB
extraction. Host-side preprocessing (pure NumPy): runs once per frame on
uint8 images before upload, exactly where the reference runs it.
"""
from __future__ import annotations

import numpy as np


def init_undistort_rectify_map(K, D, R, P, width: int, height: int):
    """cv::initUndistortRectifyMap equivalent (CV_32FC1 output flavor).

    For every rectified pixel (u, v): back-project through the new projection
    P, rotate back through R^-1 into the original camera, re-apply the
    (k1, k2, p1, p2[, k3]) distortion, and project with the original K. The
    result is the source-image coordinate each rectified pixel samples.

    K: (3,3) original intrinsics; D: (N,) distortion (N in 4, 5, 8);
    R: (3,3) rectifying rotation; P: (3,3) or (3,4) new projection.
    Returns (map_x, map_y) float32 arrays of shape (height, width).
    """
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).ravel()
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    A_new = P[:3, :3]
    iR = np.linalg.inv(A_new @ R)

    k1 = D[0] if D.size > 0 else 0.0
    k2 = D[1] if D.size > 1 else 0.0
    p1 = D[2] if D.size > 2 else 0.0
    p2 = D[3] if D.size > 3 else 0.0
    k3 = D[4] if D.size > 4 else 0.0
    k4 = D[5] if D.size > 5 else 0.0    # rational model (N=8)
    k5 = D[6] if D.size > 6 else 0.0
    k6 = D[7] if D.size > 7 else 0.0

    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    W = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x = X / W
    y = Y / W

    r2 = x * x + y * y
    radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / \
        (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6)))
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy

    map_x = (K[0, 0] * xd + K[0, 1] * yd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img, map_x, map_y, fill: float = 0.0):
    """cv::remap(..., INTER_LINEAR, BORDER_CONSTANT) equivalent.

    img: (H, W) array; map_x/map_y: (h, w) source coordinates. Out-of-range
    samples produce `fill`. Returns float32 (h, w).
    """
    img = np.asarray(img, np.float32)
    H, W = img.shape
    eps = 1e-3   # fp slack: an identity map lands at -1e-7 on the border
    inside = (map_x >= -eps) & (map_x <= W - 1 + eps) & \
        (map_y >= -eps) & (map_y <= H - 1 + eps)
    map_x = np.clip(map_x, 0, W - 1)
    map_y = np.clip(map_y, 0, H - 1)
    x0c = np.clip(np.floor(map_x).astype(np.int64), 0, W - 2)
    y0c = np.clip(np.floor(map_y).astype(np.int64), 0, H - 2)
    fx = map_x - x0c
    fy = map_y - y0c
    v00 = img[y0c, x0c]
    v01 = img[y0c, x0c + 1]
    v10 = img[y0c + 1, x0c]
    v11 = img[y0c + 1, x0c + 1]
    out = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
           + (v10 * (1 - fx) + v11 * fx) * fy)
    return np.where(inside, out, np.float32(fill)).astype(np.float32)


class StereoRectifier:
    """Per-frame stereo rectification from reference EuRoC settings YAML.

    Mirrors `stereo_euroc.cc`: reads LEFT./RIGHT. {K, D, R, P, width, height}
    nodes, builds both map pairs once, and rectifies each (left, right) pair.
    """

    def __init__(self, maps_left, maps_right):
        self.maps_left = maps_left
        self.maps_right = maps_right

    @staticmethod
    def from_settings(path: str) -> "StereoRectifier":
        from ..utils.config import load_opencv_yaml, opencv_matrix

        data = load_opencv_yaml(path)
        maps = []
        for side in ("LEFT", "RIGHT"):
            for key in ("K", "D", "R", "P"):
                if f"{side}.{key}" not in data:
                    raise KeyError(
                        f"settings YAML missing {side}.{key} "
                        "(rectification calibration block)")
            K = opencv_matrix(data[f"{side}.K"])
            D = opencv_matrix(data[f"{side}.D"])
            R = opencv_matrix(data[f"{side}.R"])
            P = opencv_matrix(data[f"{side}.P"])
            w = int(data[f"{side}.width"])
            h = int(data[f"{side}.height"])
            maps.append(init_undistort_rectify_map(K, D, R, P, w, h))
        return StereoRectifier(maps[0], maps[1])

    @staticmethod
    def available(path: str) -> bool:
        from ..utils.config import load_opencv_yaml

        data = load_opencv_yaml(path)
        return "LEFT.K" in data and "RIGHT.K" in data

    def __call__(self, left, right):
        # uint8 output: rectified frames keep the 4x-cheaper device upload
        # (remap of [0,255] inputs stays in range; fill=0)
        l = remap_bilinear(left, *self.maps_left)
        r = remap_bilinear(right, *self.maps_right)
        return (np.clip(l + 0.5, 0, 255).astype(np.uint8),
                np.clip(r + 0.5, 0, 255).astype(np.uint8))
