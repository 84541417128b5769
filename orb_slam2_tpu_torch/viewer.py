"""Offline map / trajectory visualization (port of `orb_slam2_tpu/viewer.py`).

Replaces the Pangolin GUI stack (Viewer / FrameDrawer / MapDrawer,
`src/Viewer.cc:95-214`, `src/MapDrawer.cc`) with a headless matplotlib
renderer: map points, keyframe centres, the covisibility graph and the
frame trajectory drawn to a PNG. The reference's viewer is off the metric
path (SURVEY section 2.2). matplotlib is imported when a function draws;
the map is read from its device with one host copy per field drawn.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_map(m, trajectory=None, path="map.png", max_points=20000,
             show_covisibility=True, title=None):
    """m: MapState; trajectory: optional list of (ts, T_wc)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")

    pts = _host(m.pt_pos)[_host(m.pt_valid)]
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(len(pts), max_points, False)]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.5, c="k", alpha=0.4,
                   label=f"{len(pts)} map points")

    poses = _host(m.kf_pose)
    centers = [(k, -poses[k][:3, :3].T @ poses[k][:3, 3])
               for k in np.nonzero(_host(m.kf_valid))[0]]
    if centers:
        cs = np.array([c for _, c in centers])
        ax.scatter(cs[:, 0], cs[:, 2], -cs[:, 1], s=20, c="tab:blue",
                   marker="s", label=f"{len(cs)} keyframes")

    if show_covisibility and centers:
        covis = _host(m.covis)
        idx = dict(centers)
        drawn = 0
        for k, c in centers:
            for j in np.nonzero(covis[k] >= 15)[0]:
                if j > k and j in idx and drawn < 500:
                    c2 = idx[j]
                    ax.plot([c[0], c2[0]], [c[2], c2[2]], [-c[1], -c2[1]],
                            "g-", lw=0.3, alpha=0.5)
                    drawn += 1

    if trajectory:
        tr = np.array([T[:3, 3] for _, T in trajectory])
        ax.plot(tr[:, 0], tr[:, 2], -tr[:, 1], "r-", lw=1.0, label="trajectory")

    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    ax.legend(loc="upper right", fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def draw_frame(img, frame_data, matched_mask=None, path="frame.png", status=None):
    """FrameDrawer equivalent (`FrameDrawer::DrawFrame` + `DrawTextInfo`,
    `src/FrameDrawer.cc:33-208`): keypoints over the image (green = matched
    to map points, blue = unmatched), with the reference's status banner
    (tracking state, KFs, MPs, matches) when `status` (e.g.
    SlamSystem.get_map_stats()) is given."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(_host(img), cmap="gray", vmin=0, vmax=255)
    xy = _host(frame_data.xy)
    valid = _host(frame_data.valid)
    n_match = 0
    if matched_mask is not None:
        matched = _host(matched_mask) & valid
        n_match = int(matched.sum())
        ax.plot(xy[valid & ~matched, 0], xy[valid & ~matched, 1], "b.", ms=2)
        ax.plot(xy[matched, 0], xy[matched, 1], "g.", ms=3)
        ax.set_title(f"{n_match} matches / {int(valid.sum())} keypoints")
    else:
        ax.plot(xy[valid, 0], xy[valid, 1], "g.", ms=2)
    if status is not None:
        banner = (f"{status.get('state', '?')} | KFs: {status.get('n_keyframes', 0)} "
                  f"MPs: {status.get('n_map_points', 0)} "
                  f"Matches: {n_match or status.get('last_inliers', 0)} "
                  f"Loops: {status.get('n_loops_closed', 0)}")
        ax.text(0.01, 0.02, banner, transform=ax.transAxes, color="yellow",
                fontsize=9, family="monospace",
                bbox=dict(facecolor="black", alpha=0.6, pad=2))
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


class LiveViewer:
    """The reference's Viewer thread (`src/Viewer.cc:95-214`) without the GL
    stack: a daemon thread renders the map view and the current-frame
    overlay at ~`fps` while tracking runs. Headless, it writes
    map_live.png / frame_live.png into `out_dir`, each replaced atomically
    so a file watcher can follow; with a display and an interactive
    matplotlib backend it shows windows.

    The tracker (or the example script) calls `update(img)` after each tracked frame
    (FrameDrawer::Update, `src/Tracking.cc:463,652`); `request_finish()` +
    `join()` end it (Viewer::RequestFinish). `follow_camera` puts the
    latest camera centre in the map view's title.
    """

    def __init__(self, system, out_dir=".", fps=2.0, follow_camera=True,
                 show_covisibility=True, interactive=None):
        import threading
        self.s = system
        self.out_dir = out_dir
        self.period = 1.0 / max(fps, 1e-3)
        self.follow_camera = follow_camera
        self.show_covisibility = show_covisibility
        self._img = None
        self._frame = None
        self._matched = None
        self._pending = []
        self._lock = threading.Lock()
        self._finish = threading.Event()
        self.n_renders = 0
        if interactive is None:
            interactive = bool(os.environ.get("DISPLAY"))
        self.interactive = interactive
        self._thread = threading.Thread(target=self._run, daemon=True, name="viewer")
        self._thread.start()

    def update(self, img=None):
        """Take the current frame for the overlay (references only: the
        system replaces its records, it does not write them in place)."""
        with self._lock:
            if img is not None:
                self._img = _host(img)
            self._frame = self.s.last_frame
            lm = getattr(self.s, "last_matched_pt", None)
            self._matched = None if lm is None else lm >= 0

    def request_finish(self):
        self._finish.set()

    def join(self, timeout=10.0):
        self._finish.set()
        self._thread.join(timeout)

    def _run(self):
        import time as _time
        while not self._finish.wait(self.period):
            try:
                self._render_once()
            except Exception:       # rendering must never kill tracking
                _time.sleep(self.period)

    def _render_once(self):
        with self._lock:
            img, frame, matched = self._img, self._frame, self._matched
        s = self.s
        if img is not None and frame is not None:
            draw_frame(img, frame, matched_mask=matched,
                       path=self._atomic(os.path.join(self.out_dir, "frame_live.png")),
                       status=s.get_map_stats())
        m = s.m
        if m is not None and int(m.n_keyframes) > 0:
            title = None
            if self.follow_camera and s.last_Tcw is not None:
                T = np.asarray(s.last_Tcw)
                c = -T[:3, :3].T @ T[:3, 3]
                title = f"cam ({c[0]:.2f}, {c[1]:.2f}, {c[2]:.2f})"
            plot_map(m, trajectory=s.get_trajectory(),
                     path=self._atomic(os.path.join(self.out_dir, "map_live.png")),
                     show_covisibility=self.show_covisibility, title=title)
        self.n_renders += 1
        self._promote()

    def _atomic(self, path):
        # render to a temporary name; _promote moves it in place
        tmp = path + ".tmp.png"
        self._pending.append((tmp, path))
        return tmp

    def _promote(self):
        for tmp, path in self._pending:
            if os.path.exists(tmp):
                os.replace(tmp, path)
        self._pending = []
