"""Synthetic world for the port's tests and `chip_smoke.py`: a textured
ground plane with raised plates, rendered with exact ground-truth poses and
depth, and camera trajectories (the part of `orb_slam2_tpu/utils/synthetic.py`
the port's tests and smoke need). The NumPy code is the reference's own, so
renders from the same seed are identical in both packages. Host-side, NumPy
only.
"""
from __future__ import annotations

import numpy as np


def make_texture(rng, size=2048):
    """Multi-scale blob texture with diverse corner contrasts (keypoint
    selection needs a non-degenerate response landscape)."""
    tex = rng.uniform(20, 60, size=(size, size)).astype(np.float32)
    for blob_size, count in [(48, 300), (24, 900), (12, 2500), (6, 5000)]:
        ys = rng.integers(0, size - blob_size, count)
        xs = rng.integers(0, size - blob_size, count)
        amps = rng.uniform(30, 195, count) * rng.choice([-1, 1], count)
        for y, x, a in zip(ys, xs, amps):
            tex[y:y + blob_size, x:x + blob_size] += a
    return np.clip(tex, 0, 255).astype(np.float32)


class PlaneWorld:
    def __init__(self, fx, fy, cx, cy, width, height, z0=5.0,
                 tex_size=2048, tex_scale=60.0, seed=42):
        """tex_scale: texture pixels per world unit."""
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.w, self.h = width, height
        self.z0 = z0
        self.tex = make_texture(np.random.default_rng(seed), tex_size)
        self.tex_scale = tex_scale
        self.tex_size = tex_size

    def render(self, T_wc):
        """T_wc: camera-to-world (4,4). Returns (H,W) float32 gray image."""
        img, _ = self._render(T_wc)
        return img

    def render_with_depth(self, T_wc):
        return self._render(T_wc)

    def _render(self, T_wc):
        R = T_wc[:3, :3]
        c = T_wc[:3, 3]
        us, vs = np.meshgrid(np.arange(self.w), np.arange(self.h))
        d_cam = np.stack([(us - self.cx) / self.fx,
                          (vs - self.cy) / self.fy,
                          np.ones_like(us, dtype=np.float64)], axis=-1)
        d_world = d_cam @ R.T
        dz = d_world[..., 2]
        dz = np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        t = (self.z0 - c[2]) / dz
        hit = c[None, None, :] + t[..., None] * d_world
        depth = t * d_cam[..., 2] * 0 + t  # ray parameter; depth = t * |unit?|
        # camera-frame z of the hit point:
        p_cam = (hit - c) @ R  # world->cam rotation is R^T; (hit-c)@R == R^T p
        zc = p_cam[..., 2]

        tx = hit[..., 0] * self.tex_scale + self.tex_size / 2
        ty = hit[..., 1] * self.tex_scale + self.tex_size / 2
        img = self._sample(tx, ty)
        img = np.where((t > 0), img, 0.0)
        zc = np.where(t > 0, zc, 0.0)
        return img.astype(np.float32), zc.astype(np.float32)

    def _sample(self, tx, ty):
        # TILE the texture (wrap-around bilinear) instead of clamping:
        # clamping made the ground featureless (constant stripes) beyond
        # |world| > (tex_size/2)/tex_scale ~= 17 m, which silently killed
        # tracking on any long-range trajectory (the 20 m-radius forward
        # drive). The 34 m tiling period is mild perceptual aliasing that
        # the plate relief + per-plate texture offsets decorrelate.
        tx = np.mod(tx, self.tex_size)
        ty = np.mod(ty, self.tex_size)
        x0 = np.floor(tx).astype(np.int64)
        y0 = np.floor(ty).astype(np.int64)
        fx = tx - x0
        fy = ty - y0
        x1 = (x0 + 1) % self.tex_size
        y1 = (y0 + 1) % self.tex_size
        t = self.tex
        return ((t[y0, x0] * (1 - fx) + t[y0, x1] * fx) * (1 - fy) +
                (t[y1, x0] * (1 - fx) + t[y1, x1] * fx) * fy)


class PlateWorld(PlaneWorld):
    """Ground plane + raised rectangular plates: true 3D relief.

    The single infinite plane of PlaneWorld is a degenerate SLAM scene —
    planar PnP/Sim3 have a two-fold pose ambiguity and near-flat cost
    valleys, so loop-closure Sim3 estimates wander meters along them (the
    reference's solvers share the failure mode on flat scenes). Raised
    plates (top faces parallel to the ground at random heights) break the
    degeneracy while keeping rendering exact: per pixel, the nearest
    positive-t plane hit among ground + plate tops, with true depth."""

    def __init__(self, fx, fy, cx, cy, width, height, z0=5.0,
                 tex_size=2048, tex_scale=60.0, seed=42,
                 n_plates=200, relief=(0.3, 1.5), plate_size=(0.5, 2.0),
                 extent=14.0):
        super().__init__(fx, fy, cx, cy, width, height, z0=z0,
                         tex_size=tex_size, tex_scale=tex_scale, seed=seed)
        rng = np.random.default_rng(seed + 1)
        cxy = rng.uniform(-extent, extent, (n_plates, 2))
        wh = rng.uniform(plate_size[0], plate_size[1], (n_plates, 2))
        self.px0 = cxy[:, 0] - wh[:, 0] / 2
        self.px1 = cxy[:, 0] + wh[:, 0] / 2
        self.py0 = cxy[:, 1] - wh[:, 1] / 2
        self.py1 = cxy[:, 1] + wh[:, 1] / 2
        self.pz = z0 - rng.uniform(relief[0], relief[1], n_plates)
        # texture offset per plate decorrelates its appearance from the
        # ground directly beneath it
        self.toff = rng.uniform(0, tex_size, (n_plates, 2))

    def _render(self, T_wc):
        R = T_wc[:3, :3]
        c = T_wc[:3, 3]
        us, vs = np.meshgrid(np.arange(self.w), np.arange(self.h))
        d_cam = np.stack([(us - self.cx) / self.fx,
                          (vs - self.cy) / self.fy,
                          np.ones_like(us, dtype=np.float64)], axis=-1)
        d_world = d_cam @ R.T
        dz = d_world[..., 2]
        dz = np.where(np.abs(dz) < 1e-9, 1e-9, dz)

        # nearest positive-t surface, incrementally over ground + plates
        # (one (H,W) pass per plate keeps memory flat)
        dx, dy = d_world[..., 0], d_world[..., 1]

        def hit_plane(zp):
            t = (zp - c[2]) / dz
            return t, c[0] + t * dx, c[1] + t * dy

        t, x, y = hit_plane(self.z0)
        ok = t > 0
        best_t = np.where(ok, t, np.inf)
        best_x, best_y = x, y
        best_z = np.full_like(t, self.z0)
        best_ox = np.zeros_like(t)
        best_oy = np.zeros_like(t)
        # frustum cull: a plate sits between the camera and the ground, so
        # every plate hit's x-y lies inside the ground-hit bbox expanded to
        # include the camera footprint — skip plates that can't intersect it
        # (renders ~10-20 of n_plates per frame instead of all of them)
        gx = x[ok] if ok.any() else np.array([c[0]])
        gy = y[ok] if ok.any() else np.array([c[1]])
        x_lo = min(gx.min(), c[0]) - 0.1
        x_hi = max(gx.max(), c[0]) + 0.1
        y_lo = min(gy.min(), c[1]) - 0.1
        y_hi = max(gy.max(), c[1]) + 0.1
        visible = np.nonzero((self.px1 >= x_lo) & (self.px0 <= x_hi) &
                             (self.py1 >= y_lo) & (self.py0 <= y_hi))[0]
        for b in visible:
            t, x, y = hit_plane(self.pz[b])
            ok = (t > 0) & (t < best_t) & \
                (x >= self.px0[b]) & (x <= self.px1[b]) & \
                (y >= self.py0[b]) & (y <= self.py1[b])
            best_t = np.where(ok, t, best_t)
            best_x = np.where(ok, x, best_x)
            best_y = np.where(ok, y, best_y)
            best_z = np.where(ok, self.pz[b], best_z)
            best_ox = np.where(ok, self.toff[b, 0], best_ox)
            best_oy = np.where(ok, self.toff[b, 1], best_oy)

        valid = np.isfinite(best_t)
        tx = best_x * self.tex_scale + self.tex_size / 2 + best_ox
        ty = best_y * self.tex_scale + self.tex_size / 2 + best_oy
        img = self._sample(tx % (self.tex_size - 2), ty % (self.tex_size - 2))
        img = np.where(valid, img, 0.0)

        hit = np.stack([best_x, best_y, best_z], axis=-1)
        p_cam = (hit - c) @ R
        zc = np.where(valid, p_cam[..., 2], 0.0)
        # emulate a real depth camera: occlusion-edge pixels are invalid
        # (Kinect returns 0 there; TUM treats 0 as no-depth). Keypoints that
        # land on a plate boundary then fall back to mono instead of picking
        # up a grossly wrong surface depth.
        zmin = zc.copy()
        zmax = zc.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                n = np.roll(np.roll(zc, dy, 0), dx, 1)
                zmin = np.minimum(zmin, n)
                zmax = np.maximum(zmax, n)
        edge = (zmax - zmin) > 0.02 * np.maximum(zc, 1e-6)
        zc = np.where(edge, 0.0, zc)
        return img.astype(np.float32), zc.astype(np.float32)


def loop_trajectory(n_frames, radius=3.0, overshoot=0.3, spiral=0.0):
    """Closed circular survey over the plane: the camera translates around a
    circle of `radius` in the x-y plane (optical axis fixed toward the
    plane), returning to the starting view after one revolution and
    continuing `overshoot` of a second lap — the revisit region that lets
    place recognition fire on several consecutive keyframes (the loop-closing
    consistency gate needs >= 3). Views midway around the circle see disjoint
    texture, so the revisit is only reachable through BoW retrieval.

    spiral > 0 grows the radius by that fraction per revolution: the lap-2
    overshoot then surveys fresh adjacent ground instead of exactly
    retracing lap 1 (exploration continues after the closure — the aerial
    spiral-survey pattern)."""
    total = 2.0 * np.pi * (1.0 + overshoot)
    poses = []
    for i in range(n_frames):
        a = total * i / n_frames
        r = radius * (1.0 + spiral * a / (2.0 * np.pi))
        T = np.eye(4)
        T[:3, 3] = [r * np.cos(a) - radius, r * np.sin(a), 0.0]
        poses.append(T)
    return poses


def lateral_trajectory(n_frames, step=0.02, yaw_rate=0.0):
    """Camera-to-world poses translating along +x, optional yaw."""
    poses = []
    for i in range(n_frames):
        yaw = yaw_rate * i
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                      [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [step * i, 0.002 * i, 0.001 * np.sin(i * 0.3)]
        poses.append(T)
    return poses


def figure_eight_trajectory(n_frames, radius=3.0, dwell=0.08):
    """Two tangent circles traversed in sequence (a figure eight through the
    origin): lap A around (-r, 0), then lap B around (+r, 0), velocity-
    continuous at the crossover. Each lap overshoots by `dwell` of a turn so
    place recognition sees several consecutive revisit keyframes: two
    distinct loop closures, one per lap."""
    per = n_frames // 2
    total = 2 * np.pi * (1.0 + dwell)
    poses = []
    for i in range(n_frames):
        if i < per:
            a = total * i / per
            x = -radius + radius * np.cos(a)
            y = radius * np.sin(a)
        else:
            a = total * (i - per) / (n_frames - per)
            x = radius - radius * np.cos(a)
            y = radius * np.sin(a)
        T = np.eye(4)
        T[:3, 3] = [x, y, 0.0]
        poses.append(T)
    return poses


class ImperfectCamera:
    """Photometric imperfections over any world: per-frame exposure gain (a
    slow sinusoid, like auto-exposure hunting), additive Gaussian pixel
    noise and mild vignetting. The noise comes from one generator drawn in
    call order, so frames must be rendered in sequence to repeat a run."""

    def __init__(self, world, noise_sigma=4.0, exposure_amp=0.25,
                 exposure_period=180.0, vignette=0.25, seed=7):
        self.world = world
        self.noise_sigma = noise_sigma
        self.exposure_amp = exposure_amp
        self.exposure_period = exposure_period
        self.rng = np.random.default_rng(seed)
        h, w = world.h, world.w
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        r2 = (((xs - w / 2) / (w / 2)) ** 2 + ((ys - h / 2) / (h / 2)) ** 2)
        self.vig = (1.0 - vignette * r2 / 2).astype(np.float32)

    def degrade(self, img, frame_idx: int):
        """A clean render through the camera: gain, vignetting, noise."""
        gain = 1.0 + self.exposure_amp * np.sin(
            2 * np.pi * frame_idx / self.exposure_period)
        img = img * gain * self.vig
        img = img + self.rng.normal(0.0, self.noise_sigma, img.shape)
        return np.clip(img, 0, 255).astype(np.float32)

    def render_with_depth(self, T_wc, frame_idx: int):
        img, depth = self.world.render_with_depth(T_wc)
        return self.degrade(img, frame_idx), depth
