"""Augmented-reality utilities: dominant-plane detection from tracked map
points and virtual-object overlay.

The headless analogue of the reference's ROS AR demo
(`Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc`): `DetectPlane` (:393-491)
RANSACs a plane out of the currently tracked map points, `Plane::Recompute`
(:511-603) least-squares refits it and builds the plane frame Tpw, and the
render loop draws a virtual cube sitting on the plane into the live image.
Host-side NumPy (visualization path, not on the tracking metric path); the
port's own copy of `orb_slam2_tpu/ar.py`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Plane(NamedTuple):
    Tpw: np.ndarray        # (4,4) plane-to-world: origin on plane, y-axis = normal
    normal: np.ndarray     # (3,) unit normal, oriented AWAY from the camera
                           # ((camera - origin) . normal <= 0, matching the
                           # reference's flip in Plane::Recompute) — objects
                           # rise toward the camera along -normal
    origin: np.ndarray     # (3,) inlier centroid
    inliers: np.ndarray    # (N,) bool mask over the input points


def _exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def detect_plane(points, Tcw, min_obs_mask=None, iterations: int = 50,
                 min_points: int = 50, seed: int = 0) -> Optional[Plane]:
    """`ViewerAR::DetectPlane` (`ViewerAR.cc:393-491`) + `Plane::Recompute`
    (`:511-603`): RANSAC 3-point plane fits over the tracked map points
    (reference keeps points with >5 observations), scored by the
    20th-percentile absolute plane distance; inliers at 1.4x the best score;
    least-squares refit; normal flipped to face the camera; plane frame Tpw
    aligns +y with the normal. Returns None below `min_points` candidates.

    points: (N,3) world positions of currently tracked points;
    Tcw: (4,4) current camera pose; min_obs_mask: optional (N,) bool filter.
    """
    points = np.asarray(points, np.float64)
    if min_obs_mask is not None:
        keep = np.asarray(min_obs_mask, bool)
    else:
        keep = np.ones(len(points), bool)
    idx_all = np.nonzero(keep)[0]
    P = points[idx_all]
    N = len(P)
    if N < min_points:
        return None

    rng = np.random.default_rng(seed)
    # sample without replacement (the reference pops drawn indices)
    samples = np.argsort(rng.random((iterations, N)), axis=1)[:, :3]
    p0, p1, p2 = P[samples[:, 0]], P[samples[:, 1]], P[samples[:, 2]]
    n = np.cross(p1 - p0, p2 - p0)                    # (it,3)
    d = -np.sum(n * p0, axis=-1)                      # (it,)
    degenerate = np.linalg.norm(n, axis=-1) < 1e-12   # collinear sample
    abcd = np.concatenate([n, d[:, None]], axis=-1)
    norm4 = np.linalg.norm(abcd, axis=-1, keepdims=True)
    abcd = abcd / np.maximum(norm4, 1e-12)
    # |a x + b y + c z + d| with the reference's 4-vector normalization
    dist = np.abs(P @ abcd[:, :3].T + abcd[None, :, 3])       # (N,it)
    nth = max(int(0.2 * N), min(20, N - 1))
    scores = np.sort(dist, axis=0)[nth]                       # (it,)
    scores = np.where(degenerate, np.inf, scores)
    best = int(np.argmin(scores))
    # floor the threshold: exactly-coplanar (noise-free) points give 0 here
    th = max(1.4 * scores[best], 1e-7)
    inl = dist[:, best] < th
    if inl.sum() < 3:
        return None

    # Recompute: LS plane over inliers
    Q = P[inl]
    o = Q.mean(axis=0)
    A = np.concatenate([Q, np.ones((len(Q), 1))], axis=-1)
    _, _, Vt = np.linalg.svd(A, full_matrices=True)
    a, b, c, _ = Vt[-1]
    # orient the normal: flip if it points along camera-center -> origin
    R = np.asarray(Tcw, np.float64)[:3, :3]
    t = np.asarray(Tcw, np.float64)[:3, 3]
    Oc = -R.T @ t
    XC = Oc - o
    if XC @ np.array([a, b, c]) > 0:
        a, b, c = -a, -b, -c
    nrm = np.array([a, b, c]) / np.linalg.norm([a, b, c])

    up = np.array([0.0, 1.0, 0.0])
    v = np.cross(up, nrm)
    sa = np.linalg.norm(v)
    ca = up @ nrm
    ang = np.arctan2(sa, ca)
    Tpw = np.eye(4)
    if sa > 1e-9:
        Tpw[:3, :3] = _exp_so3(v * ang / sa)
    Tpw[:3, 3] = o

    full_inl = np.zeros(len(points), bool)
    full_inl[idx_all[inl]] = True
    return Plane(Tpw=Tpw, normal=nrm, origin=o, inliers=full_inl)


_CUBE_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0),
               (4, 5), (5, 7), (7, 6), (6, 4),
               (0, 4), (1, 5), (2, 6), (3, 7)]


def cube_corners(size: float):
    """8 corners of a cube of side `size` resting ON the plane (the reference
    renders glutSolidCube translated -size/2 along the plane normal,
    `ViewerAR.cc:330-340`)."""
    s = size / 2.0
    corners = []
    for y in (0.0, -size):          # plane frame: -y is "up" toward the camera
        for x in (-s, s):
            for z in (-s, s):
                corners.append([x, y, z])
    return np.array(corners)


def project_points(Xw, Tcw, fx, fy, cx, cy):
    Xw = np.asarray(Xw, np.float64)
    T = np.asarray(Tcw, np.float64)
    pc = Xw @ T[:3, :3].T + T[:3, 3]
    z = np.maximum(pc[:, 2], 1e-9)
    return np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1), pc[:, 2]


def draw_segment(img, p0, p1, value=255.0):
    """Rasterize one line segment into a (H,W) or (H,W,3) image in place."""
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.linspace(p0[0], p1[0], n)
    ys = np.linspace(p0[1], p1[1], n)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xi = xs[ok].astype(np.int64)
    yi = ys[ok].astype(np.int64)
    img[yi, xi] = value
    return img


def draw_cube(img, plane: Plane, Tcw, size, fx, fy, cx, cy, value=255.0):
    """Overlay the wireframe of a cube of side `size` standing on the
    detected plane (reference's AR insertion, `ViewerAR.cc:160-210,300-345`)."""
    corners_p = cube_corners(size)
    Tpw = plane.Tpw
    corners_w = corners_p @ Tpw[:3, :3].T + Tpw[:3, 3]
    uv, z = project_points(corners_w, Tcw, fx, fy, cx, cy)
    out = np.array(img, copy=True)
    for i, j in _CUBE_EDGES:
        if z[i] > 0 and z[j] > 0:
            draw_segment(out, uv[i], uv[j], value)
    return out
