"""Frozen configuration for the whole engine (port of
`orb_slam2_tpu/utils/config.py`).

`SlamConfig.from_yaml` accepts the reference's own settings files unchanged
(including the OpenCV `%YAML:1.0` header). There is no kernel switch: each
kernel wrapper dispatches on the device of its input tensor
(`ops/cuda_extract.py`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
import threading
from typing import Optional

SENSOR_MONOCULAR = 0
SENSOR_STEREO = 1
SENSOR_RGBD = 2


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


_TABLES_LOCK = threading.RLock()


def device_cache(maxsize: int = 16):
    """`functools.lru_cache` for a function that builds constant tensors on
    the `torch.device` it is given, safe where two host threads issue work
    on two CUDA streams (the tracking / mapping split): one thread builds
    at a time, and the stream that built a CUDA table is synchronized
    before the table is handed out, so a launch on another stream never
    reads it before it is written."""
    def wrap(fn):
        @functools.lru_cache(maxsize=maxsize)
        def build(*args):
            out = fn(*args)
            import torch
            for a in args:
                if isinstance(a, torch.device) and a.type == "cuda":
                    torch.cuda.current_stream(a).synchronize()
            return out

        @functools.wraps(fn)
        def get(*args):
            with _TABLES_LOCK:
                return build(*args)
        get.cache_clear = build.cache_clear
        return get
    return wrap


@device_cache(maxsize=64)
def device_table(values: tuple, device):
    """A float32 tensor of `values` on `device`, made once per device: a
    fresh host-to-device copy on every call would wait for the stream."""
    import torch
    return torch.tensor(values, dtype=torch.float32, device=device)


def reciprocal_f32(v: float) -> float:
    """1/v rounded to float32, as a Python float. The reference's XLA
    programs divide by a compile-time constant as a multiplication by its
    float32 reciprocal; `x * reciprocal_f32(c)` reproduces that rounding
    where `x / c` would differ in the last bit."""
    import numpy as np
    return float(np.float32(1.0) / np.float32(v))


def load_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV cv::FileStorage-flavor YAML (the reference settings
    format): strips the `%YAML:1.0` header and `!!opencv-matrix` tags; matrix
    nodes come through as {rows, cols, dt, data} dicts."""
    import yaml

    # errors="replace": some reference configs carry non-UTF-8 comment bytes
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    text = re.sub(r"^%YAML:[\d.]+", "", text.strip())
    text = text.replace("!!opencv-matrix", "")
    # OpenCV's parser allows "key:value" without a space; PyYAML does not
    text = re.sub(r"^(\s*[\w.]+):(\S)", r"\1: \2", text, flags=re.M)
    return yaml.safe_load(text) or {}


def opencv_matrix(node):
    """Convert a parsed opencv-matrix node ({rows, cols, data}) to ndarray."""
    import numpy as np

    if isinstance(node, dict):
        return np.asarray(node["data"], np.float64).reshape(
            int(node["rows"]), int(node["cols"]))
    return np.asarray(node, np.float64)


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    # Camera (reference YAML `Camera.*`)
    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    bf: float = 0.0                 # stereo baseline * fx
    rgb_order: int = 1              # Camera.RGB
    width: int = 640
    height: int = 480
    depth_map_factor: float = 1.0   # DepthMapFactor (RGBD)
    th_depth: float = 35.0          # ThDepth: close/far stereo point threshold (in baselines)

    # ORB extractor (reference YAML `ORBextractor.*`)
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7

    # Sensor
    sensor: int = SENSOR_MONOCULAR

    # Keep best + second-best keypoint per selection cell (off = the
    # reference's 1-per-leaf; on is not ported yet and raises)
    select_top2: bool = False

    # ---- Fixed-capacity shapes (everything is padded to these and masked)
    max_keypoints: Optional[int] = None      # default: next_pow2(1.25 n_features)
    max_keyframes: int = 512
    max_map_points: int = 1 << 16
    max_local_keyframes: int = 80            # local-map KF cap (src/Tracking.cc:1959)
    max_local_points: int = 1 << 13          # local map point buffer
    max_obs_per_point: int = 32              # point -> observing KFs capacity

    # Local BA problem caps (static shapes of the Schur solver)
    ba_local_cams: int = 32
    ba_fixed_cams: int = 32
    ba_max_points: int = 1 << 12
    ba_max_obs: int = 12

    # Matching thresholds (src/ORBmatcher.cc:56-58)
    th_high: int = 100
    th_low: int = 50
    histo_length: int = 30

    # Solver schedules
    pose_opt_rounds: int = 4
    pose_opt_iters: int = 10
    local_ba_iters: int = 10
    global_ba_iters: int = 10
    # Local BA LM schedule: iters_a robust iterations, chi2
    # reclassification, iters_b more (src/Optimizer.cc:880-916)
    ba_iters_a: int = 5
    ba_iters_b: int = 10

    # Periodic global BA every N keyframes (0 = off)
    gba_every_n_kf: int = 0

    # Loop-closure GBA scheduling: 0 = synchronous inside the correction,
    # N > 0 = N chunks of iterations, one per later keyframe insertion
    gba_async_chunks: int = 4
    gba_total_iters: int = 10                # src/LoopClosing.cc:884 (nIts)

    # Frames after a keyframe during which the mapper counts as busy
    # (src/Tracking.cc:1546-1567): -1 = ceil(mapping_wall_s * fps),
    # 0 = always idle, N > 0 = explicit count
    mapper_busy_frames: int = -1
    # Wall seconds of one mapping iteration, read only by the -1 policy
    mapping_wall_s: float = 0.2

    # Loop closing / place recognition
    covis_consistency_th: int = 3            # src/LoopClosing.cc:91
    loop_kf_gap: int = 10                    # src/LoopClosing.cc:152
    min_covis_weight: int = 15               # src/KeyFrame.cc:465
    essential_graph_min_feat: int = 100      # src/Optimizer.cc:1103

    def __post_init__(self):
        if self.max_keypoints is None:
            object.__setattr__(self, "max_keypoints",
                               _next_pow2(int(self.n_features * 1.25)))

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.bf else 0.0

    @property
    def mapper_busy_frames_effective(self) -> int:
        """Resolve the mapper_busy_frames=-1 policy (see field docs)."""
        if self.mapper_busy_frames >= 0:
            return self.mapper_busy_frames
        return int(math.ceil(self.mapping_wall_s * self.fps))

    @property
    def scale_factors(self):
        return [self.scale_factor ** i for i in range(self.n_levels)]

    @property
    def level_sigma2(self):
        return [s * s for s in self.scale_factors]

    def features_per_level(self):
        """Per-pyramid-level feature budget via the geometric split used by the
        reference (`src/ORBextractor.cc:516-531`): level 0 gets the most."""
        factor = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - factor) / (1 - factor ** self.n_levels)
        budgets = []
        total = 0
        for _ in range(self.n_levels - 1):
            b = int(round(n_desired))
            budgets.append(b)
            total += b
            n_desired *= factor
        budgets.append(max(self.n_features - total, 0))
        return budgets

    @staticmethod
    def from_yaml(path: str, sensor: int = SENSOR_MONOCULAR, **overrides) -> "SlamConfig":
        """Load a reference-format settings YAML (OpenCV FileStorage flavor)."""
        data = load_opencv_yaml(path)

        def g(key, default):
            return data.get(key, default)

        kw = dict(
            fx=float(g("Camera.fx", 517.3)),
            fy=float(g("Camera.fy", 516.5)),
            cx=float(g("Camera.cx", 318.6)),
            cy=float(g("Camera.cy", 255.3)),
            k1=float(g("Camera.k1", 0.0)),
            k2=float(g("Camera.k2", 0.0)),
            p1=float(g("Camera.p1", 0.0)),
            p2=float(g("Camera.p2", 0.0)),
            k3=float(g("Camera.k3", 0.0)),
            fps=float(g("Camera.fps", 30.0)) or 30.0,
            bf=float(g("Camera.bf", 0.0)),
            rgb_order=int(g("Camera.RGB", 1)),
            width=int(g("Camera.width", 640)),
            height=int(g("Camera.height", 480)),
            th_depth=float(g("ThDepth", 35.0)),
            n_features=int(g("ORBextractor.nFeatures", 1000)),
            scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
            n_levels=int(g("ORBextractor.nLevels", 8)),
            ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
            min_th_fast=int(g("ORBextractor.minThFAST", 7)),
            sensor=sensor,
        )
        # the YAML gives sensor units per metre; the field is the multiplier
        # from sensor units to metres, its inverse (`Tracking.cc`'s
        # `mDepthMapFactor = 1.0f/mDepthMapFactor`). The JAX package keeps
        # the value as read, so a TUM depth of 5000 reads as 25,000 km there.
        dmf = float(g("DepthMapFactor", 1.0))
        kw["depth_map_factor"] = 1.0 if abs(dmf) < 1e-5 else 1.0 / dmf
        kw.update(overrides)
        return SlamConfig(**kw)

    def camera(self, device="cuda"):
        from ..geometry.camera import Camera

        return Camera.make(self.fx, self.fy, self.cx, self.cy, self.k1, self.k2,
                           self.p1, self.p2, self.k3, self.bf, self.width,
                           self.height, device=device)
