"""Camera trajectories for the benchmark's synthetic maps: copies of
`city_block_trajectory` and `loop_trajectory` from
`orb_slam2_tpu_torch/utils/synthetic.py`, kept here so that the yardstick
does not move when the program's copy does. Each returns a list of (4, 4)
float64 camera-to-world poses (NumPy).
"""
from __future__ import annotations

import numpy as np


def loop_trajectory(n_frames, radius=3.0, overshoot=0.3, spiral=0.0):
    """Closed circular survey: the camera translates around a circle of
    `radius` in the x-y plane (optical axis fixed along +z), returning to
    the starting view after one revolution and continuing `overshoot` of a
    second lap, the revisit region that a loop closure joins to the start.
    spiral > 0 grows the radius by that fraction per revolution."""
    total = 2.0 * np.pi * (1.0 + overshoot)
    poses = []
    for i in range(n_frames):
        a = total * i / n_frames
        r = radius * (1.0 + spiral * a / (2.0 * np.pi))
        T = np.eye(4)
        T[:3, 3] = [r * np.cos(a) - radius, r * np.sin(a), 0.0]
        poses.append(T)
    return poses


def city_block_trajectory(n_frames, block=28.0, corner_radius=3.0,
                          speed=0.08, overshoot=0.15, jitter=0.01,
                          start_legs=0.0):
    """Drive a rectangular circuit counterclockwise with quarter-circle
    corners, the camera facing the direction of travel (yaw about the
    vertical y axis), at `speed` per frame; past one lap the drive goes on
    over the start, the revisit a loop closure joins. `jitter` adds a small
    lateral sinusoid, `start_legs` offsets the start along the circuit (in
    legs). `overshoot` is kept for the original's signature: the length is
    n_frames * speed."""
    del overshoot
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
            # quarter circle anchored at the leg's end point, rotated into
            # the leg's frame (forward = lx, turn-side lateral = lz)
            end = {0: (L / 2.0, -half), 1: (half, L / 2.0),
                   2: (-L / 2.0, half), 3: (-half, -L / 2.0)}[leg]
            lx = corner_radius * np.sin(a)
            lz = corner_radius * (1 - np.cos(a))
            ca, sa = np.cos(leg * np.pi / 2.0), np.sin(leg * np.pi / 2.0)
            x = end[0] + ca * lx - sa * lz
            z = end[1] + sa * lx + ca * lz
        # camera forward (sin hdg, 0, cos hdg) along the drive direction
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


TRAJECTORIES = {"city_block": city_block_trajectory, "loop": loop_trajectory}
