"""Synthetic worlds for the port's tests and `chip_smoke.py`: a textured
ground plane with raised plates and a street-canyon circuit (`BlockWorld`,
rendered as a rectified stereo pair too), with exact ground-truth poses and
depth, and camera trajectories (a port of `orb_slam2_tpu/utils/synthetic.py`).
The NumPy code is the reference's own, so renders from the same seed are
identical in both packages. Host-side, NumPy only; `ate_rmse` is the
trajectory module's, on (timestamp, T_wc) lists.
"""
from __future__ import annotations

import numpy as np

from .trajectory import ate_rmse  # noqa: F401  (the example scripts import it from here)


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


def survey_trajectory(n_frames, extent=10.0, rows=6, row_overlap_frames=8):
    """Lawn-mower survey raster over the world: long straight rows with
    lateral row changes and no rotation (optical axis fixed toward the
    plane, like an aerial mapping run). Covers a large area with no early
    revisit, so accumulated drift is measurable; adjacent rows overlap so
    local mapping keeps stitching."""
    row_len = 2 * extent
    per_row = max(n_frames // rows, 2)
    row_gap = 2 * extent / (rows + 1) * 0.35
    poses = []
    for i in range(n_frames):
        r = min(i // per_row, rows - 1)
        j = i - r * per_row
        frac = j / max(per_row - 1, 1)
        x = -extent + frac * row_len
        if r % 2 == 1:
            x = -x
        y = -extent * 0.35 + r * row_gap
        T = np.eye(4)
        T[:3, 3] = [x, y, 0.02 * np.sin(i * 0.21)]
        poses.append(T)
    return poses


def forward_trajectory(n_frames, speed=0.12, curve_period=400.0,
                       curve_amp=0.8, close_loop=False):
    """KITTI-00-flavoured forward motion over the plane world: a long
    meandering path at constant speed with smooth heading changes, the
    camera rotating about its optical axis to face the direction of travel
    (in-image rotation, as car yaw gives on KITTI). With close_loop the
    heading curvature closes one big circle over ~90 % of the frames, so the
    path returns near its start at the end."""
    poses = []
    x, y = 0.0, 0.0
    heading = 0.0
    for i in range(n_frames):
        if close_loop:
            dh = 2.0 * np.pi / (0.9 * n_frames) + \
                0.002 * np.sin(2 * np.pi * i / 97.0)
        else:
            dh = (curve_amp / curve_period) * np.sin(
                2 * np.pi * i / curve_period)
        heading += dh
        x += speed * np.cos(heading)
        y += speed * np.sin(heading)
        ch, sh = np.cos(heading), np.sin(heading)
        T = np.eye(4)
        T[:3, :3] = np.array([[ch, -sh, 0.0], [sh, ch, 0.0], [0.0, 0.0, 1.0]])
        T[:3, 3] = [x, y, 0.02 * np.sin(i * 0.13)]
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


class BlockWorld:
    """Forward-facing street-canyon circuit — the KITTI regime (VERDICT r3
    missing #4): optical axis along the direction of travel, epipole inside
    the image, depth-stratified structure (near walls flanking the street,
    ground plane below, far wall ahead at tens of meters with low-parallax
    points), 90-degree vehicle turns.

    Geometry is a set of axis-aligned textured rectangles, so rendering stays
    exact ray-plane intersection + bilinear texture sampling like the other
    worlds: a rectangular street circuit of side `block` with rounded
    corners; each street is flanked by segmented building facades (random
    heights, per-panel texture offsets — building fronts), and the ground is
    a single plane. World axes: x/z horizontal, y DOWN (+y below the
    camera), matching the camera convention (x right, y down, z forward) so
    an identity pose drives along +z.

    Use with `city_block_trajectory`, which follows the same circuit. The
    reference's analogous scenes are the KITTI odometry sequences its
    stereo/mono examples run on (`Examples/Stereo/stereo_kitti.cc`).
    """

    def __init__(self, fx, fy, cx, cy, width, height, block=28.0,
                 street_half_width=3.5, cam_height=1.5, wall_height=5.0,
                 panel_len=4.0, tex_size=2048, tex_scale=100.0, seed=3,
                 depth_range=12.0, recess_depth=0.7):
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.w, self.h = width, height
        self.block = block
        self.street_half_width = street_half_width
        self.cam_height = cam_height
        self.depth_range = depth_range
        self.tex = make_texture(np.random.default_rng(seed), tex_size)
        self.tex_scale = tex_scale
        self.tex_size = tex_size
        rng = np.random.default_rng(seed + 1)

        # Panels: (axis, offset, normal_sign, u0, u1, v0, v1, tex_off_u, tex_off_v)
        # axis 0: plane x = offset, in-plane coords (u=z, v=y)
        # axis 2: plane z = offset, in-plane coords (u=x, v=y)
        # axis 1: plane y = offset (ground), coords (u=x, v=z)
        panels = []
        g = cam_height                      # ground plane y = +cam_height
        half = block / 2.0
        W = street_half_width
        for side_off, sgn in ((half + W, -1.0), (half - W, +1.0)):
            # outer facades span the whole outer box; inner facades span only
            # the inner block (otherwise they would cut across the streets)
            lo, hi = -side_off, side_off
            # per circuit side: outer facade at |coord| = half+W facing
            # inward (normal -coord_sign), inner facade at |coord| = half-W
            # facing outward (normal +coord_sign) — both toward the street
            # ring that lies between them
            for coord_sign in (+1.0, -1.0):
                base_off = side_off * coord_sign
                nrm = sgn * coord_sign      # toward the street centerline
                for axis in (0, 2):
                    u_axis = 2 if axis == 0 else 0
                    u = lo
                    recessed = False
                    prev_off = base_off
                    while u < hi:
                        ulen = min(panel_len * rng.uniform(0.7, 1.5), hi - u)
                        htop = wall_height * rng.uniform(0.5, 1.0)
                        # SERRATED facades: alternate panels recess away
                        # from the street (doorways/pillars) — the frontal
                        # connector strips face along the street, giving the
                        # matcher viewpoint-stable surfaces (a perfectly
                        # flat canyon is all grazing-angle texture, which
                        # rBRIEF matches poorly under forward motion)
                        jog = recess_depth * rng.uniform(0.5, 1.0)
                        off = base_off - (nrm * jog if recessed else 0.0)
                        panels.append((axis, off, nrm, u, u + ulen,
                                       g - htop, g,
                                       rng.uniform(0, tex_size),
                                       rng.uniform(0, tex_size)))
                        if abs(off - prev_off) > 1e-6:
                            # frontal connector between the two wall depths
                            # (a doorway jamb): plane u = const spanning the
                            # jog, one panel per face — the occluded face is
                            # hidden by the nearest-hit test
                            o_lo = min(off, prev_off)
                            o_hi = max(off, prev_off)
                            panels.append((u_axis, u, -1.0, o_lo, o_hi,
                                           g - min(htop, wall_height * 0.6),
                                           g,
                                           rng.uniform(0, tex_size),
                                           rng.uniform(0, tex_size)))
                            panels.append((u_axis, u, +1.0, o_lo, o_hi,
                                           g - min(htop, wall_height * 0.6),
                                           g,
                                           rng.uniform(0, tex_size),
                                           rng.uniform(0, tex_size)))
                        prev_off = off
                        recessed = not recessed
                        u += ulen
        self.panels = panels

    def render(self, T_wc):
        return self._render(T_wc)[0]

    def render_with_depth(self, T_wc):
        return self._render(T_wc)

    def render_stereo(self, T_wc, baseline):
        """(left, right, left_depth): right camera displaced +baseline along
        the camera x axis — synthetic rectified stereo."""
        left, depth = self._render(T_wc)
        T_r = np.array(T_wc, dtype=np.float64).copy()
        T_r[:3, 3] = T_r[:3, 3] + T_r[:3, :3] @ np.array([baseline, 0.0, 0.0])
        right = self._render(T_r, want_depth=False)[0]
        return left, right, depth

    def _render(self, T_wc, want_depth=True):
        R = np.asarray(T_wc)[:3, :3]
        c = np.asarray(T_wc)[:3, 3]
        us, vs = np.meshgrid(np.arange(self.w), np.arange(self.h))
        d_cam = np.stack([(us - self.cx) / self.fx,
                          (vs - self.cy) / self.fy,
                          np.ones_like(us, dtype=np.float64)], axis=-1)
        d = d_cam @ R.T                                      # world ray dirs
        best_t = np.full((self.h, self.w), np.inf)
        best_u = np.zeros_like(best_t)
        best_v = np.zeros_like(best_t)
        best_ou = np.zeros_like(best_t)
        best_ov = np.zeros_like(best_t)

        def add_plane(axis, off, u_axis, v_axis, u0, u1, v0, v1, ou, ov):
            nonlocal best_t, best_u, best_v, best_ou, best_ov
            dz = d[..., axis]
            dz = np.where(np.abs(dz) < 1e-12, 1e-12, dz)
            t = (off - c[axis]) / dz
            pu = c[u_axis] + t * d[..., u_axis]
            pv = c[v_axis] + t * d[..., v_axis]
            ok = (t > 1e-6) & (t < best_t) & \
                (pu >= u0) & (pu <= u1) & (pv >= v0) & (pv <= v1)
            best_t = np.where(ok, t, best_t)
            best_u = np.where(ok, pu, best_u)
            best_v = np.where(ok, pv, best_v)
            best_ou = np.where(ok, ou, best_ou)
            best_ov = np.where(ok, ov, best_ov)

        # ground: y = cam_height plane over the whole circuit footprint
        ext = self.block / 2 + self.street_half_width + 1.0
        add_plane(1, self.cam_height, 0, 2, -ext, ext, -ext, ext, 0.0, 0.0)

        fwd = R[:, 2]                       # camera optical axis in world
        for (axis, off, nrm, u0, u1, v0, v1, ou, ov) in self.panels:
            # cull: camera on the front side of the panel, panel not
            # entirely behind the camera
            front = (c[axis] - off) * nrm
            if front <= 0.05:               # behind / inside the facade
                continue
            u_axis = 2 if axis == 0 else 0
            # panel center vs camera: skip if it lies behind the image plane
            center = np.zeros(3)
            center[axis] = off
            center[u_axis] = 0.5 * (u0 + u1)
            center[1] = 0.5 * (v0 + v1)
            to_c = center - c
            dist = np.linalg.norm(to_c)
            span = 0.5 * (u1 - u0)
            if dist > span and np.dot(to_c, fwd) < -span:
                continue
            add_plane(axis, off, u_axis, 1, u0, u1, v0, v1, ou, ov)

        valid = np.isfinite(best_t)
        tx = best_u * self.tex_scale + best_ou
        ty = best_v * self.tex_scale + best_ov
        img = self._sample(tx, ty)
        # flat mid-gray sky: a BLACK sky turned every roofline into
        # maximum-contrast silhouette corners — view-dependent non-landmarks
        # that hogged the per-cell selection budget and matched erratically
        img = np.where(valid, img, 60.0).astype(np.float32)
        if not want_depth:
            return img, None
        # camera-frame z of the hit point = t * (unit-z of the ray in cam
        # frame) — d_cam has z component 1 by construction
        zc = np.where(valid, best_t, 0.0)
        # emulate a real depth camera (same as PlateWorld): occlusion-edge
        # pixels invalid, plus a max range (Kinect ~ depth_range meters; far
        # facades are tracked monocularly / by stereo, like TUM far points)
        zmin = zc.copy()
        zmax = zc.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                n = np.roll(np.roll(zc, dy, 0), dx, 1)
                zmin = np.minimum(zmin, n)
                zmax = np.maximum(zmax, n)
        edge = (zmax - zmin) > 0.02 * np.maximum(zc, 1e-6)
        zc = np.where(edge | (zc > self.depth_range), 0.0, zc)
        return img, zc.astype(np.float32)

    _sample = PlaneWorld._sample


def city_block_trajectory(n_frames, block=28.0, corner_radius=3.0,
                          speed=0.08, overshoot=0.15, jitter=0.01,
                          start_legs=0.0):
    """Drive the BlockWorld circuit: counterclockwise rectangular lap with
    quarter-circle corners, camera facing the direction of travel (yaw about
    the vertical y axis), constant speed, one lap + `overshoot` of a second
    so place recognition sees consecutive revisit keyframes. `jitter` adds a
    small lateral sinusoid (no perfectly-degenerate straight-line motion).
    `start_legs` offsets the start position along the circuit (in legs)."""
    half = block / 2.0
    L = block - 2 * corner_radius           # straight length per side
    arc = 0.5 * np.pi * corner_radius
    per = 4 * (L + arc)                     # perimeter
    poses = []
    for i in range(n_frames):
        s = (i * speed + start_legs * (L + arc)) % per
        leg = int(s // (L + arc))
        r = s - leg * (L + arc)
        # leg 0: +x along z=-half; leg 1: +z along x=+half;
        # leg 2: -x along z=+half; leg 3: -z along x=-half
        if r <= L:
            f = r - L / 2.0                 # position along the straight
            heading = leg * np.pi / 2.0
            base = {0: (f, -half), 1: (half, f), 2: (-f, half),
                    3: (-half, -f)}[leg]
            x, z = base
        else:
            a = (r - L) / corner_radius     # corner angle 0..pi/2
            heading = leg * np.pi / 2.0 + a
            # quarter circle anchored at the leg's END point, rotated into
            # the leg's frame (forward = lx, turn-side lateral = lz)
            end = {0: (L / 2.0, -half), 1: (half, L / 2.0),
                   2: (-L / 2.0, half), 3: (-half, -L / 2.0)}[leg]
            lx = corner_radius * np.sin(a)
            lz = corner_radius * (1 - np.cos(a))
            ca, sa = np.cos(leg * np.pi / 2.0), np.sin(leg * np.pi / 2.0)
            x = end[0] + ca * lx - sa * lz
            z = end[1] + sa * lx + ca * lz
        # rotate camera z (forward) onto the drive direction; heading 0
        # drives +x, so camera forward (sin hdg, 0, cos hdg) needs
        # hdg = heading - pi/2
        hdg = heading - np.pi / 2.0
        ch, sh = np.cos(hdg), np.sin(hdg)
        Rwc = np.array([[ch, 0.0, -sh],
                        [0.0, 1.0, 0.0],
                        [sh, 0.0, ch]])
        T = np.eye(4)
        T[:3, :3] = Rwc
        lat = jitter * np.sin(i * 0.17)     # along camera right = (ch, 0, sh)
        T[:3, 3] = [x + ch * lat, 0.0, z + sh * lat]
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

    def render_stereo(self, T_wc, baseline, frame_idx: int):
        """Stereo pair through the imperfect optics: identical exposure gain
        (one shutter), independent pixel noise per eye, left drawn first."""
        left, right, depth = self.world.render_stereo(T_wc, baseline)
        return self.degrade(left, frame_idx), self.degrade(right, frame_idx), depth
