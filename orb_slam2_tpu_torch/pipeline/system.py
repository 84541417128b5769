"""The system facade, the tracking state machine and the keyframe events
(port of `orb_slam2_tpu/pipeline/system.py`).

`System` / `Tracking` / `LocalMapping` (`src/System.cc:18-147`,
`src/Tracking.cc:431-767`, `src/LocalMapping.cc:71-159`): the reference's
three threads and their queues become a staged schedule. Every tracked
frame runs the tracking step (`tracking_step.py`); a keyframe runs the whole
mapping pass on the new map at once (`mapping_ops.keyframe_pass`). The heavy
work is on the device; this class sequences it and keeps the small host
state: the tracking state, the motion model, the trajectory, the keyframe
decision.

Two ways to run a sequence: synchronous (`pipeline_depth=0`, the default:
each frame's pose is read back before the next is dispatched), or the
pipelined stream (`pipeline_depth=d > 0`: frame i is dispatched with its
state chained on the device and frame i - d is retired; a keyframe a frame
spawns reaches tracking d frames later, the relaxation the reference makes
by running LocalMapping in its own thread). On a CUDA device the retire
payload goes back by a non-blocking copy into pinned host memory behind a
CUDA event, which the retire waits on.

The tracking / mapping split (`mapping_device` with the stream): a
keyframe's mapping pass (`mapping_ops.keyframe_pass`) runs on one worker
thread while tracking goes on against the map as it was, and the next
retire adopts its map (the reference's LocalMapping thread,
`src/LocalMapping.cc:71-159`; the JAX package puts the pass on a second
chip). On one GPU the worker issues the pass on a CUDA stream of its own:
the pass is thousands of small operations issued from Python, so it
overlaps tracking only if another host thread issues it. The worker's
stream waits on an event recorded after the snapshot, the tracking stream
waits on the pass's done event before it reads the adopted map, and the
pending record holds the snapshot until then, so the caching allocator
reuses none of its blocks early; the adopted tensors are recorded on the
tracking stream. On another device the snapshot goes there and the map
comes back by copies. On the CPU the worker thread runs the twins.

`gba_mesh` (a `torch.distributed` device mesh, `parallel/distributed.py`)
shards the essential graph and every global BA of loop closing over its
ranks: every rank runs the same system on the same frames (README).

Ported: RGB-D, stereo and monocular tracking and initialization (the
monocular two-view bootstrap in `_initialize_monocular`), the natural
keyframe policy, relocalization from LOST (`_relocalize`), loop closing
with the global BA spread over later keyframes (`loop_closing.py`) and the
periodic global BA, the sharded solvers, the tracking / mapping split,
localization mode, reset, trajectory export, and the frame drawer
(`draw_current_frame`, through `viewer.py`).
"""
from __future__ import annotations

import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..bow import database as bow_db
from ..bow import vocabulary as bow_voc
from ..geometry import se3
from ..mapstate import map as mapstate
from ..ops import matching
from ..solvers import initializer, pnp, pose_opt, schur_ba
from ..utils.config import SlamConfig, SENSOR_MONOCULAR
from . import loop_closing, mapping_ops, tracking_ops, tracking_step
from .frame import FrameData, make_frame_monocular, make_frame_rgbd, make_frame_stereo

NOT_INITIALIZED = 0
OK = 1
LOST = 2

INVALID = -1
N_SCALARS = 11          # tracking_step.TrackStepResult.scalars


class _Pending:
    """What the pipelined stream returns while a frame's result is still
    in flight (truthy: the frame was dispatched, not lost)."""
    def __repr__(self):
        return "<pose pending>"

    def __bool__(self):
        return True


PENDING = _Pending()


def _unpack(pk: np.ndarray):
    """Split the step's (43,) retire payload into (scalars int (11,), Tcw
    (4,4), T_rel (4,4))."""
    n = N_SCALARS
    return pk[:n].astype(np.int64), pk[n:n + 16].reshape(4, 4), pk[n + 16:n + 32].reshape(4, 4)


def _tensors(x):
    """The tensors of a tensor or a (nested) tuple."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


def _to_device(x, dev):
    """A tensor or a (nested, named) tuple of them on dev, by non-blocking
    copies to a GPU (the split's snapshot and its adopted map)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=dev.type == "cuda")
    if isinstance(x, tuple):
        vals = [_to_device(v, dev) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def last_points(cfg: SlamConfig, m: mapstate.MapState, f: FrameData, Tcw, matched_pt):
    """The next motion-model step's 3D points after a keyframe or a reset of
    the chain (UpdateLastFrame, `src/Tracking.cc:1228-1330`): the frame's
    bound map points still alive (a mapping pass may have culled or fused
    them away), plus, for a depth sensor, the close-depth points of the
    unbound keypoints. Tcw (4,4) on the map's device. Returns (pos (N,3),
    valid (N,))."""
    P = m.capacity_pt
    idx = torch.clamp(matched_pt, 0, P - 1).long()
    has = (matched_pt >= 0) & m.pt_valid[idx]
    if cfg.sensor == SENSOR_MONOCULAR:
        return m.pt_pos[idx], has
    pw = se3.apply(se3.inverse(Tcw), mapping_ops.unproject(cfg, f))
    temporal = (f.depth > 0) & (f.depth < cfg.th_depth * cfg.baseline) & ~has & f.valid
    return torch.where(temporal[:, None], pw, m.pt_pos[idx]), has | temporal


@dataclass
class TrajectoryEntry:
    timestamp: float
    T_rel: np.ndarray      # Tcw * inv(T_ref_kf) at track time
    ref_kf: int
    lost: bool


class SlamSystem:
    """Construct once, call `track_rgbd`, `track_stereo` or
    `track_monocular` (the config's sensor) per frame, then `flush()` and
    `get_trajectory()`. `device` holds the map and runs the kernels ("cuda",
    the default) or their plain twins ("cpu"). Loop closing is on by
    default, as in the reference."""

    def __init__(self, cfg: SlamConfig, vocabulary=None, enable_loop_closing=True,
                 gba_mesh=None, pipeline_depth: int = 0, mapping_device=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # the sharded global BA and essential graph (module docstring)
        self.gba_mesh = gba_mesh
        # the tracking / mapping split (module docstring): one worker thread,
        # at most one pass in flight, on a stream of its own on a GPU
        self.mapping_device = None if mapping_device is None else torch.device(mapping_device)
        self._pending_mapping = None
        self._mapper = self._map_stream = None
        if self.mapping_device is not None:
            self._mapper = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mapping")
            weakref.finalize(self, self._mapper.shutdown, False)
            if self.mapping_device.type == "cuda":
                self._map_stream = torch.cuda.Stream(self.mapping_device)
        self.n_mapping_dispatched = 0    # split passes dispatched / adopted
        self.n_mapping_adopted = 0
        # pipeline_depth > 0: the pipelined stream (module docstring)
        self.pipeline_depth = int(pipeline_depth)
        self._pending = deque()   # in flight: (timestamp, frame_id, res, payload)
        self._chain = None        # the device-resident inputs of the next step
        self.cam = cfg.camera(self.device)
        self.m = self._empty_map()
        # place recognition: the vocabulary injected (a converted ORBvoc.txt,
        # synth_vocabulary) or trained on the fly from the first frames'
        # descriptors (the reference loads ORBvoc.txt up front,
        # src/System.cc:58-77)
        self.voc = vocabulary
        self.db = self._empty_db() if vocabulary is not None else None
        self._voc_train_desc = []
        self.enable_loop_closing = enable_loop_closing
        self.loop_state = loop_closing.LoopState()
        self.n_loops_closed = 0
        # each closure: keyframe sequence number, keyframe and candidate
        # ids and their frames
        self.loop_closures: List[dict] = []
        self._kfs_since_gba = 0       # keyframes since the last global BA
        self._gba_chunks_left = 0     # amortized global-BA chunks still to run
        self.localization_only = False
        self.state = NOT_INITIALIZED
        self.velocity: Optional[np.ndarray] = None
        self.last_Tcw: Optional[np.ndarray] = None
        self.last_frame: Optional[FrameData] = None
        self.last_pts = None          # (N,3) 3D points of the last frame's features
        self.last_pts_valid = None
        self.last_matched_pt = None   # (N,) map point ids of the last frame
        self.ref_kf = 0
        self.frame_id = 0
        self.last_kf_frame_id = 0
        self.last_reloc_frame_id = -(1 << 30)
        self.init_frame: Optional[FrameData] = None   # monocular: the initial frame
        self.init_ts = 0.0
        self._n_kf_host = None        # host mirror of n_keyframes (lazy)
        self._kf_seq_host = 0         # keyframes inserted
        # stream: frames dispatched before the last keyframe insertion skip
        # the keyframe decision (their statistics predate the map update;
        # the reference skips NeedNewKeyFrame while the mapper is busy,
        # src/Tracking.cc:1561-1567)
        self._kf_blackout_fid = -1
        self.trajectory: List[TrajectoryEntry] = []
        self.n_inliers = 0
        self.metrics: List[dict] = []
        self.stage_ms: dict = {}      # wall ms of the last keyframe's stages

    def _empty_map(self):
        cfg = self.cfg
        return mapstate.empty(cfg.max_keyframes, cfg.max_map_points, cfg.max_keypoints,
                              device=self.device)

    def _empty_db(self):
        return bow_db.BowDatabase.empty(self.cfg.max_keyframes, self.cfg.max_keypoints,
                                        device=self.device)

    def _upload(self, a):
        """An image (numpy array or tensor) on the system's device; float64
        becomes float32 on the host, and a host array goes to a CUDA device
        by a non-blocking copy from pinned memory, so it does not wait for
        the stream."""
        t = torch.as_tensor(a)
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _tensor(self, a):
        """A small host array (a pose) on the device as float32."""
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(self.device)

    # ------------------------------------------------------------------
    # public entry points (System::TrackMonocular/Stereo/RGBD)
    # ------------------------------------------------------------------

    def track_monocular(self, img, timestamp: float):
        """One monocular frame: gray image (H,W) uint8 or float. Before the
        map is initialized the extraction budget doubles (the reference's
        mpIniORBextractor, src/Tracking.cc:188-190,398), and such a frame
        leaves the stream. Returns Tcw (4,4) as a numpy array, None when the
        frame was not tracked, or PENDING while it is in flight in the
        stream."""
        if self.state == OK:
            images = (self._upload(img),)
            if self.pipeline_depth > 0:
                return self._track_stream(images, timestamp, "mono")
            return self._track(None, timestamp, images=images, sensor="mono")
        self._flush_pipeline()
        f = make_frame_monocular(self._upload(img), self.cfg,
                                 init=self.state == NOT_INITIALIZED)
        return self._track(f, timestamp)

    def track_stereo(self, img_left, img_right, timestamp: float):
        """One rectified stereo pair: gray images (H,W) uint8 or float.
        Returns Tcw (4,4) as a numpy array, None when the frame was not
        tracked, or PENDING while it is in flight in the stream."""
        if self.state == OK:
            images = (self._upload(img_left), self._upload(img_right))
            if self.pipeline_depth > 0:
                return self._track_stream(images, timestamp, "stereo")
            return self._track(None, timestamp, images=images, sensor="stereo")
        self._flush_pipeline()
        f = make_frame_stereo(self._upload(img_left), self._upload(img_right), self.cfg)
        return self._track(f, timestamp)

    def track_rgbd(self, img, depth, timestamp: float):
        """One RGB-D frame: gray image (H,W) uint8 or float, depth (H,W) in
        the sensor's units (cfg.depth_map_factor). Returns Tcw (4,4) as a
        numpy array, None when the frame was not tracked, or PENDING while
        it is in flight in the stream."""
        if self.state == OK:
            images = (self._upload(img), self._upload(depth))
            if self.pipeline_depth > 0:
                return self._track_stream(images, timestamp, "rgbd")
            return self._track(None, timestamp, images=images, sensor="rgbd")
        self._flush_pipeline()
        f = make_frame_rgbd(self._upload(img), self._upload(depth), self.cfg)
        return self._track(f, timestamp)

    def _track(self, f: Optional[FrameData], timestamp: float, images=None, sensor=None):
        if self.state == NOT_INITIALIZED:
            Tcw = self._initialize(f, timestamp)
        else:
            Tcw = self._track_frame(f, timestamp, images=images, sensor=sensor)
        self.frame_id += 1
        return Tcw

    def _initialize(self, f: FrameData, timestamp: float):
        if self.cfg.sensor == SENSOR_MONOCULAR:
            return self._initialize_monocular(f, timestamp)
        return self._initialize_depth(f, timestamp)

    def _initialize_depth(self, f: FrameData, timestamp: float):
        """StereoInitialization (`src/Tracking.cc:774-860`): more than 500
        features (scaled to the configured budget), then keyframe 0 with a
        map point for every depth measurement."""
        if int(f.n) <= min(500, self.cfg.n_features // 2):
            return None
        Tcw = torch.eye(4, device=self.device)
        matched = torch.full((self.cfg.max_keypoints,), INVALID, dtype=torch.int32,
                             device=self.device)
        self.m, kf_id = mapping_ops.insert_keyframe(self.cfg, self.m, f, Tcw, matched,
                                                    self.frame_id, timestamp, all_depth=True)
        self.ref_kf = int(kf_id)
        self.last_kf_frame_id = self.frame_id
        self._kf_seq_host += 1
        self._n_kf_host = None
        self.state = OK
        self._set_last(f, Tcw, self.m.kf_obs[self.ref_kf])
        self.velocity = None
        self._on_keyframe_inserted(self.ref_kf, f)
        eye = np.eye(4, dtype=np.float32)
        self._record(timestamp, eye, self.ref_kf, False)
        return eye

    def _initialize_monocular(self, f: FrameData, timestamp: float):
        """MonocularInitialization (`src/Tracking.cc:864-944`): a frame with
        more than 100 features becomes the initial frame; the next one is
        matched against it (SearchForInitialization on K4's window form),
        and at 100 matches or more the two-view initializer runs (its
        RANSAC sets drawn from a CPU generator seeded with the frame id).
        Too few matches drop the initial frame; a failed initialization
        keeps it."""
        cfg = self.cfg
        n = int(f.n)
        if self.init_frame is None or n <= 100:
            self.init_frame = f if n > 100 else None
            self.init_ts = timestamp
            return None
        ref = self.init_frame
        mm = matching.search_for_initialization(ref.xy, ref.level, ref.desc, ref.valid, ref.angle,
                                                f.xy, f.level, f.desc, f.valid, f.angle)
        if int(mm.valid.sum()) < 100:
            self.init_frame = None
            return None
        p2 = f.xy[torch.clamp(mm.idx, 0, f.xy.shape[0] - 1).long()]
        res = initializer.initialize(ref.xy, p2, mm.valid, float(cfg.fx), float(cfg.fy),
                                     float(cfg.cx), float(cfg.cy),
                                     generator=torch.Generator().manual_seed(self.frame_id))
        if not bool(res.success):
            return None
        m, kf0, kf1 = self._initial_map(ref, f, mm, res, timestamp)

        # the scene's scale: keyframe 0's median depth becomes 1
        obs0 = m.kf_obs[kf0]
        on = obs0 >= 0
        z = torch.where(on, m.pt_pos[torch.clamp(obs0, 0, m.capacity_pt - 1).long(), 2],
                        float("inf"))
        nv = int(on.sum())
        if nv < 50:
            return None
        med = float(torch.sort(z).values[nv // 2])
        if med <= 0:
            return None
        inv_med = 1.0 / med
        T1 = mapstate.take(m.kf_pose, kf1).clone()
        T1[:3, 3] *= inv_med
        m = m._replace(kf_pose=m.kf_pose.index_copy(0, kf1.view(1), T1[None]),
                       pt_pos=torch.where(m.pt_valid[:, None], m.pt_pos * inv_med, m.pt_pos))

        self.m = m
        self.state = OK
        self.ref_kf = int(kf1)
        self.last_kf_frame_id = self.frame_id
        self._kf_seq_host += 2
        self._n_kf_host = None
        Tcw = mapstate.take(m.kf_pose, kf1)
        self._set_last(f, Tcw, m.kf_obs[self.ref_kf])
        self.velocity = None
        self._on_keyframe_inserted(int(kf0), ref)
        self._on_keyframe_inserted(self.ref_kf, f)
        eye = np.eye(4, dtype=np.float32)
        self._record(self.init_ts, eye, int(kf0), False)
        self._record(timestamp, eye, self.ref_kf, False)
        return self.last_Tcw

    def _initial_map(self, ref: FrameData, f: FrameData, mm, res, timestamp: float):
        """CreateInitialMapMonocular (`src/Tracking.cc:944-1127`): the two
        keyframes (the initial one at the reference's frame id, the frame
        before this one), a point for every good triangulation bound in
        both, their descriptors and normals, and the full BA of the two
        views. Returns (map, kf0, kf1)."""
        cfg, dev = self.cfg, self.device
        N = cfg.max_keypoints
        unbound = torch.full((N,), INVALID, dtype=torch.int32, device=dev)
        m, kf0 = mapstate.add_keyframe(self.m, torch.eye(4, device=dev), ref.xy, ref.level,
                                       ref.angle, ref.desc, ref.ur, ref.depth, ref.valid, unbound,
                                       self.frame_id - 1, self.init_ts)
        m, kf1 = mapstate.add_keyframe(m, se3.make(res.R21, res.t21), f.xy, f.level, f.angle,
                                       f.desc, f.ur, f.depth, f.valid, unbound, self.frame_id,
                                       timestamp)
        slots = mapstate.allocate_points(m, res.good)
        m = mapstate.add_points(m, slots, res.points, ref.desc, kf0,
                                torch.zeros((), dtype=torch.int32, device=dev))
        okc = res.good & (slots >= 0)
        m = mapstate.bind_observations(m, kf0, torch.arange(N, dtype=torch.int32, device=dev),
                                       slots, okc)
        m = mapstate.bind_observations(m, kf1, mm.idx, slots, okc & mm.valid)
        m = mapstate.update_connections(m, kf1)
        P = m.capacity_pt
        pmask = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                                  torch.where(okc, slots, torch.full_like(slots, P)),
                                  torch.ones((), dtype=torch.bool, device=dev))
        m = mapstate.update_point_descriptors(m, pmask)
        m = mapstate.update_point_normals(m, pmask, cfg.scale_factors)
        m = mapstate.refresh_obs_table(m)
        return self._two_view_ba(m, kf0, kf1), kf0, kf1

    def _two_view_ba(self, m: mapstate.MapState, kf0, kf1):
        """The full BA of the two initial keyframes (the reference's global
        BA, 20 iterations): keyframe 0 fixed, every point with its two
        observations, 10 + 10 LM iterations through K9 at C = 2."""
        K, N, P = m.capacity_kf, m.n_feat, m.capacity_pt
        obs_kf, obs_ft, obs_on = mapstate.point_observations(m, max_obs=4)
        sel = torch.argsort((~m.pt_valid).to(torch.uint8), stable=True)[:self.cfg.max_keypoints]
        sel_ok = m.pt_valid[sel]
        okf, oft, oon = obs_kf[sel][:, :2], obs_ft[sel][:, :2], obs_on[sel][:, :2]
        slot = torch.where(okf == kf0, 0, torch.where(okf == kf1, 1, INVALID))
        slot = torch.where(oon, slot, INVALID).to(torch.int32)
        kfc = torch.clamp(okf, 0, K - 1).long()
        ftc = torch.clamp(oft, 0, N - 1).long()
        poses = torch.stack([mapstate.take(m.kf_pose, kf0), mapstate.take(m.kf_pose, kf1)])
        prob = schur_ba.BAProblem(
            poses=poses, cam_valid=torch.ones((2,), dtype=torch.bool, device=poses.device),
            cam_fixed=torch.tensor([True, False], device=poses.device),
            points=m.pt_pos[sel], pt_valid=sel_ok, obs_cam=slot,
            obs_uvr=torch.cat([m.kf_xy[kfc, ftc], m.kf_ur[kfc, ftc][..., None]], dim=-1),
            obs_level=m.kf_level[kfc, ftc])
        res = schur_ba.solve_ba(self.cam, prob, self.cfg.level_sigma2, iters_a=10, iters_b=10)
        return m._replace(
            kf_pose=m.kf_pose.index_copy(0, kf1.view(1), res.poses[1:]),
            pt_pos=mapstate.put_drop(m.pt_pos, torch.where(sel_ok, sel, torch.full_like(sel, P)),
                                     res.points))

    # ------------------------------------------------------------------
    # Per-frame tracking
    # ------------------------------------------------------------------

    def _set_last(self, f: FrameData, Tcw, matched_pt):
        """The last-frame state for the next motion-model step
        (UpdateLastFrame); Tcw a host array or a device tensor."""
        T = Tcw if isinstance(Tcw, torch.Tensor) else self._tensor(Tcw)
        self.last_frame = f
        self.last_Tcw = T.cpu().numpy()
        self.last_matched_pt = matched_pt
        self.last_pts, self.last_pts_valid = last_points(self.cfg, self.m, f, T, matched_pt)

    def _adopt_reloc(self, f, T_r, m_r, reloc_kf, timestamp):
        """Re-enter tracking from a relocalized pose; the frame is tracked,
        so its true relative pose is recorded (the reference marks only
        genuinely lost frames with mbLost, src/Tracking.cc:714-751)."""
        self.last_Tcw = T_r.cpu().numpy()
        self.velocity = None
        self.last_matched_pt = m_r
        self.last_frame = f
        self.last_pts = self.m.pt_pos[torch.clamp(m_r, 0, self.m.capacity_pt - 1).long()]
        self.last_pts_valid = m_r >= 0
        self.state = OK
        self.ref_kf = reloc_kf
        self.last_reloc_frame_id = self.frame_id
        T_ref = self.m.kf_pose[reloc_kf].cpu().numpy()
        self._record(timestamp, self.last_Tcw @ np.linalg.inv(T_ref), reloc_kf, False)
        return self.last_Tcw

    def _track_frame(self, f: Optional[FrameData], timestamp: float, images=None, sensor=None):
        """A frame after initialization: relocalization of the frame f when
        LOST, else the tracking step on the images."""
        cfg = self.cfg
        if self.state == LOST:
            T_r, m_r, reloc_kf, ok = self._relocalize(f)
            if not ok:
                self._record(timestamp, np.eye(4), self.ref_kf, True)
                self.metrics.append(dict(frame=self.frame_id, state="LOST", inliers=0))
                return None
            return self._adopt_reloc(f, T_r, m_r, reloc_kf, timestamp)

        has_vel = self.velocity is not None
        vel = self._tensor(self.velocity if has_vel else np.eye(4))
        # the inlier floor is 50 for one second after a relocalization
        # (src/Tracking.cc:1471-1477)
        recently_reloc = self.frame_id < self.last_reloc_frame_id + int(cfg.fps)
        min_inl = 50 if recently_reloc else 30
        # the steady-state path: extraction and tracking in one step
        res = tracking_step.full_tracking_step_from_images(
            cfg, self.m, images, self.last_frame, self.last_pts, self.last_pts_valid,
            self.last_matched_pt, self._tensor(self.last_Tcw), vel, has_vel, self.ref_kf,
            min_inl, sensor)
        f = res.frame
        self.m = res.m
        sc, Tcw, T_rel = _unpack(res.packed.cpu().numpy())
        ok = bool(sc[0])
        n_local_inl = int(sc[3])
        self.ref_kf = int(sc[8])
        self.n_inliers = n_local_inl

        if not ok and self.localization_only and bool(sc[9]) and int(sc[2]) >= 10:
            # mbVO: the map matches collapsed but visual odometry holds (the
            # temporal points carry the pose): keep the VO pose and try to
            # relocalize on the spot (src/Tracking.cc:533-560, 1018-1090)
            T_r, m_r, reloc_kf, r_ok = self._relocalize(f)
            if r_ok:
                self.metrics.append(dict(frame=self.frame_id, state="OK", inliers=n_local_inl,
                                         vo=False, relocalized=True))
                return self._adopt_reloc(f, T_r, m_r, reloc_kf, timestamp)
            self.state = OK
            if self.last_Tcw is not None:
                self.velocity = Tcw @ np.linalg.inv(self.last_Tcw)
            self.last_frame = f
            self.last_Tcw = Tcw
            self.last_matched_pt = res.matched_pt
            self.last_pts = res.next_pts
            self.last_pts_valid = res.next_pts_valid
            self._record(timestamp, T_rel, self.ref_kf, False)
            self.metrics.append(dict(frame=self.frame_id, state="OK", inliers=n_local_inl,
                                     vo=True))
            return Tcw

        if not ok:
            if not self.localization_only and self._nkf_cache() <= 5:
                # lost right after initialization: scrap the thin map and
                # start over (src/Tracking.cc:726-735)
                self.reset()
                self._record(timestamp, np.eye(4), 0, True)
                self.metrics.append(dict(frame=self.frame_id, state="RESET",
                                         inliers=n_local_inl))
                return None
            self.state = LOST
            self._record(timestamp, np.eye(4), self.ref_kf, True)
            self.metrics.append(dict(frame=self.frame_id, state="LOST", inliers=n_local_inl))
            return None

        self.state = OK
        if self.last_Tcw is not None:
            self.velocity = Tcw @ np.linalg.inv(self.last_Tcw)
        if self.voc is None:
            # collect training descriptors from every tracked frame until the
            # on-the-fly vocabulary can be built
            self._ensure_vocabulary(f)

        matched_pt = res.matched_pt
        need_kf = not self.localization_only and self._need_kf_from_scalars(sc)
        if need_kf:
            Tcw, matched_pt = self._handle_keyframe(f, Tcw, matched_pt, self.frame_id,
                                                    timestamp)
            self._set_last(f, Tcw, matched_pt)
            T_ref = self.m.kf_pose[self.ref_kf].cpu().numpy()
            T_rel = Tcw @ np.linalg.inv(T_ref)
        else:
            # the next frame's state straight from the step
            self.last_frame = f
            self.last_Tcw = Tcw
            self.last_matched_pt = matched_pt
            self.last_pts = res.next_pts
            self.last_pts_valid = res.next_pts_valid

        self._record(timestamp, T_rel, self.ref_kf, False)
        entry = dict(frame=self.frame_id, state="OK", inliers=n_local_inl, kf=bool(need_kf),
                     n_kf=self._nkf_cache() if need_kf else None,
                     # motion-model matches, their pose inliers, the reference
                     # keyframe's tracked matches, whether the fallback ran
                     n_mm=int(sc[1]), mm_inl=int(sc[2]), ref_matches=int(sc[4]),
                     fallback=bool(sc[7]))
        if need_kf:
            entry["stage_ms"] = self.stage_ms
        self.metrics.append(entry)
        return Tcw

    # ------------------------------------------------------------------
    # The pipelined stream (pipeline_depth > 0): dispatch frame i with its
    # state chained on the device, retire frame i - depth (its payload, the
    # keyframe decision, the trajectory)
    # ------------------------------------------------------------------

    def _payload(self, packed):
        """Start the retire payload's trip to the host: on a CUDA device a
        non-blocking copy into pinned memory and an event after it."""
        if self.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _payload_host(payload):
        host, done = payload
        if done is not None:
            done.synchronize()
        return host.numpy()

    def _track_stream(self, images, timestamp: float, sensor: str):
        cfg = self.cfg
        if self._chain is None:
            # (re)build the chain from the host state (after initialization,
            # a keyframe, a relocalization or a mode switch)
            has_vel = self.velocity is not None
            self._chain = dict(
                last=self.last_frame, pts=self.last_pts, ptsv=self.last_pts_valid,
                mpt=self.last_matched_pt, Tcw=self._tensor(self.last_Tcw),
                vel=self._tensor(self.velocity if has_vel else np.eye(4)), has_vel=has_vel,
                ref=self.ref_kf)
        ch = self._chain
        recently_reloc = self.frame_id < self.last_reloc_frame_id + int(cfg.fps)
        min_inl = 50 if recently_reloc else 30
        res = tracking_step.full_tracking_step_from_images(
            cfg, self.m, images, ch["last"], ch["pts"], ch["ptsv"], ch["mpt"], ch["Tcw"],
            ch["vel"], ch["has_vel"], ch["ref"], min_inl, sensor)
        self.m = res.m
        payload = self._payload(res.packed)
        self._chain = dict(last=res.frame, pts=res.next_pts, ptsv=res.next_pts_valid,
                           mpt=res.matched_pt, Tcw=res.Tcw, vel=res.next_vel, has_vel=True,
                           ref=res.ref_kf)
        self._pending.append((timestamp, self.frame_id, res, payload))
        self.frame_id += 1
        if len(self._pending) > self.pipeline_depth:
            return self._retire_one()
        return PENDING

    def _retire_one(self):
        """Finish the oldest frame in flight: read its payload, run the host
        tail of the state machine (keyframe decision, trajectory). Returns
        its pose, or None if it was lost. In the split, it first adopts the
        mapping pass dispatched at the keyframe before."""
        if self._pending_mapping is not None:
            pend, (Tcw_kf, matched_kf) = self._adopt_pending()
            if pend["corrected"]:
                # a correction or a global BA moved the poses: the chain is
                # stale, so drain it and restart from the keyframe
                self._drain_pipeline(record_lost=False)
                self._set_last(pend["f"], Tcw_kf, matched_kf)
                self._chain = None
                self._kf_blackout_fid = self.frame_id
                if not self._pending:
                    # the drain recorded every frame in flight
                    return Tcw_kf
        timestamp, fid, res, payload = self._pending.popleft()
        sc, Tcw, T_rel = _unpack(self._payload_host(payload))
        ok = bool(sc[0])
        n_local = int(sc[3])
        self.ref_kf = int(sc[8])
        self.n_inliers = n_local
        f = res.frame

        if not ok:
            if self.localization_only and bool(sc[9]) and int(sc[2]) >= 10:
                # mbVO: keep the VO pose and keep streaming
                self.state = OK
                self.last_Tcw = Tcw
                self._record(timestamp, T_rel, self.ref_kf, False)
                self.metrics.append(dict(frame=fid, state="OK", inliers=n_local, vo=True))
                return Tcw
            # genuinely lost: the frames dispatched after this one chained
            # from a bad pose; drain them as lost and leave the stream
            self._drain_pipeline(record_lost=True)
            self._chain = None
            if not self.localization_only and self._nkf_cache() <= 5:
                self.reset()
                self._record(timestamp, np.eye(4), 0, True)
                self.metrics.append(dict(frame=fid, state="RESET", inliers=n_local))
                return None
            self.state = LOST
            self._record(timestamp, np.eye(4), self.ref_kf, True)
            self.metrics.append(dict(frame=fid, state="LOST", inliers=n_local))
            return None

        self.state = OK
        if self.last_Tcw is not None:
            self.velocity = Tcw @ np.linalg.inv(self.last_Tcw)
        self.last_Tcw = Tcw
        if self.voc is None:
            self._ensure_vocabulary(f)

        need_kf = (not self.localization_only and fid >= self._kf_blackout_fid and
                   self._need_kf_from_scalars(sc, fid=fid))
        self._record(timestamp, T_rel, self.ref_kf, False)
        if need_kf:
            # drain the short queue and insert the keyframe from the newest
            # tracked frame (CreateNewKeyFrame snapshots the current frame,
            # src/Tracking.cc:1638), then rebuild the chain from the
            # keyframe's bindings after mapping (the reference's handoff
            # through mCurrentFrame.mvpMapPoints, src/Tracking.cc:1702-1712)
            newest = self._drain_pipeline(record_lost=False)
            ts2, fid2, res2, Tcw2 = newest if newest is not None else (timestamp, fid, res, Tcw)
            if self._mapper is not None:
                # the split: the pass runs beside the next frames, which
                # track against the map as it is; the next retire adopts it.
                # Those frames lack the pass's new points and may ask for
                # another keyframe, as in the JAX split (on fig8-rgbd it
                # inserts 40 keyframes where its stream inserts 19,
                # scripts/chip_smoke_reference.py --split-only)
                self._pending_mapping = self._dispatch_mapping(res2.frame, Tcw2,
                                                               res2.matched_pt, fid2, ts2)
                Tcw_kf, matched_kf = Tcw2, res2.matched_pt
            else:
                Tcw_kf, matched_kf = self._handle_keyframe(res2.frame, Tcw2, res2.matched_pt,
                                                           fid2, ts2)
            self._set_last(res2.frame, Tcw_kf, matched_kf)
            self._chain = None
            # no keyframe decisions for frames dispatched before this insertion
            self._kf_blackout_fid = self.frame_id
            self.metrics.append(dict(frame=fid2, state="OK", kf=True, inliers=n_local,
                                     ref_matches=int(sc[4]), close_tracked=int(sc[5]),
                                     close_untracked=int(sc[6]), n_kf=self._nkf_cache(),
                                     stage_ms=self.stage_ms))
        else:
            self.metrics.append(dict(frame=fid, state="OK", inliers=n_local))
        return Tcw

    def _drain_pipeline(self, record_lost: bool):
        """Empty the queue in flight with no keyframe decisions: record the
        frames as lost (the chain upstream broke) or their poses as they
        are. Returns the newest tracked (timestamp, frame_id, res, Tcw) or
        None."""
        newest = None
        while self._pending:
            ts2, fid2, r2, payload = self._pending.popleft()
            sc2, Tcw2, T_rel2 = _unpack(self._payload_host(payload))
            ok2 = bool(sc2[0]) and not record_lost
            if ok2:
                if self.last_Tcw is not None:
                    # keep the motion model current for the chain's rebuild
                    self.velocity = Tcw2 @ np.linalg.inv(self.last_Tcw)
                self.last_Tcw = Tcw2
                self._record(ts2, T_rel2, int(sc2[8]), False)
                newest = (ts2, fid2, r2, Tcw2)
            else:
                self._record(ts2, np.eye(4), self.ref_kf, True)
            self.metrics.append(dict(frame=fid2, state="OK" if ok2 else "LOST",
                                     inliers=int(sc2[3])))
        return newest

    def _flush_pipeline(self):
        """Retire everything in flight (sequence end, state transitions)."""
        while self._pending:
            self._retire_one()
        self._chain = None

    def flush(self):
        """Drain the pipelined stream and run the global-BA chunks still
        pending: call at the end of a sequence before reading the
        trajectory (System::Shutdown waits for a running global BA before
        SaveTrajectory, src/System.cc:349-360)."""
        self._flush_pipeline()
        if self._pending_mapping is not None:
            self._adopt_pending()
        while self._gba_chunks_left > 0:
            self._gba_chunk()

    def _gba_chunk(self):
        """One of cfg.gba_async_chunks chunks of the loop's global BA,
        ceil(gba_total_iters / gba_async_chunks) LM iterations."""
        cfg = self.cfg
        self.m = loop_closing.run_global_ba(
            cfg, self.m, mesh=self.gba_mesh,
            n_iters=max(1, -(-cfg.gba_total_iters // cfg.gba_async_chunks)))
        self._gba_chunks_left -= 1

    # ------------------------------------------------------------------
    # Keyframe events
    # ------------------------------------------------------------------

    def _handle_keyframe(self, f: FrameData, Tcw, matched_pt, fid: int, timestamp: float):
        """Insert a keyframe from frame f at pose Tcw (host) and run the
        per-keyframe pipeline: the mapping pass, loop closing, the amortized
        or periodic global BA. Returns (Tcw, the keyframe's bindings), Tcw
        the keyframe's corrected pose when a correction or a global BA moved
        it. One host transfer per event (the summary and the loop
        candidates), plus one when a keyframe was culled and the reads of
        compute_sim3 when a candidate passes the consistency gate."""
        return self._finish_keyframe(self._dispatch_mapping(f, Tcw, matched_pt, fid, timestamp))

    def _dispatch_mapping(self, f: FrameData, Tcw, matched_pt, fid: int, timestamp: float):
        """Enqueue the keyframe's whole mapping pass (on the split's worker
        when there is one); returns the event's record."""
        t_kf0 = time.time()
        snap = (self.m, f, self._tensor(Tcw), matched_pt, fid, timestamp)
        pend = dict(f=f, fid=fid, timestamp=timestamp, t_kf0=t_kf0, Tcw=np.asarray(Tcw))
        if self._mapper is None:
            pend["m"], pend["culled"], pend["summary"] = mapping_ops.keyframe_pass(self.cfg,
                                                                                   *snap)
        else:
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            # the record holds the snapshot until adoption: its blocks stay
            # out of the allocator while the worker's stream may read them
            pend["snap"] = snap
            pend["future"] = self._mapper.submit(self._mapping_pass, snap, ready)
            self.n_mapping_dispatched += 1
        self.last_kf_frame_id = fid
        self._kf_seq_host += 1
        pend["kf_seq"] = self._kf_seq_host
        return pend

    def _mapping_pass(self, snap, ready):
        """The split's worker: the mapping pass on mapping_device (on a GPU,
        on the worker's stream, after the snapshot's event). Returns
        (m, culled, summary) and the pass's done event (None off a GPU)."""
        dev = self.mapping_device
        if self._map_stream is None:
            return mapping_ops.keyframe_pass(self.cfg, *_to_device(snap, dev)), None
        with torch.cuda.device(dev), torch.cuda.stream(self._map_stream):
            if ready is not None:
                self._map_stream.wait_event(ready)
            out = mapping_ops.keyframe_pass(self.cfg, *_to_device(snap, dev))
            done = torch.cuda.Event()
            done.record(self._map_stream)
        return out, done

    def _adopt_pending(self):
        """Finish the keyframe of the split's pass in flight, timed as
        stage_ms["mapping_adopt_wall"]. Returns (its record, (Tcw, the
        keyframe's bindings))."""
        t0 = time.time()
        pend, self._pending_mapping = self._pending_mapping, None
        out = self._finish_keyframe(pend)
        self.stage_ms["mapping_adopt_wall"] = (time.time() - t0) * 1e3
        return pend, out

    def _wait_for_pass(self, pend):
        """The split's pass, finished, on the tracking device: the tracking
        stream waits for it, and each of its tensors is recorded on that
        stream, so the allocator keeps a block until the tracking stream's
        work on it is done."""
        out, done = pend.pop("future").result()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            if self.mapping_device == self.device:
                for t in _tensors(out):
                    t.record_stream(stream)
        del pend["snap"]
        return _to_device(out, self.device)

    def _finish_keyframe(self, pend):
        """Adopt a mapping pass: the keyframe's BoW row, loop detection,
        the one host transfer, the trajectory rehomed off culled keyframes,
        the candidates through compute_sim3 and correct_loop, a global-BA
        chunk. In the split, the map the pass made supersedes the one the
        frames tracked since the dispatch updated (their point counters),
        as the reference's two threads race on a point's counters."""
        cfg = self.cfg
        if "future" in pend:
            pend["m"], pend["culled"], pend["summary"] = self._wait_for_pass(pend)
            self.n_mapping_adopted += 1
        f, culled, summary = pend["f"], pend["culled"], pend["summary"]
        kf_seq = pend["kf_seq"]
        self.m = pend["m"]
        loops_before = self.n_loops_closed
        self._ensure_vocabulary(f)
        cands = None
        if self.voc is not None:
            vec = self._bow_vec(f.desc, f.valid)
            self.db = self.db.add(summary[0], vec)
            if self.enable_loop_closing and \
                    kf_seq - self.loop_state.last_loop_kf_seq >= cfg.loop_kf_gap:
                cands = loop_closing.detect_loop_dispatch(cfg, self.m, self.db, vec, summary[0],
                                                          self.loop_state)
        # the one per-keyframe host transfer: the summary and the candidates
        n_sum = summary.shape[0]
        packed = summary if cands is None else torch.cat([summary, cands])
        packed_h = packed.cpu().numpy()
        summary_h, cands_h = packed_h[:n_sum], packed_h[n_sum:]
        kf_id = int(summary_h[0])
        self._n_kf_host = int(summary_h[1])
        self.ref_kf = kf_id
        if int(summary_h[3]):                     # a keyframe was culled (rare)
            culled_h = culled.cpu().numpy()
            if self.db is not None:
                self.db = self.db.erase(culled)
            self._rehome_trajectory(culled_h)
        matched_pt = self.m.kf_obs[kf_id]
        t_loop0 = time.time()
        cands_ok = [] if cands is None else loop_closing.bow_gate(cfg, self.m, kf_id, cands_h)
        for cand in cands_ok:
            # every consistent candidate in turn until one passes ComputeSim3
            # (mvpEnoughConsistentCandidates, src/LoopClosing.cc:331-466)
            ok, Scm, _ = loop_closing.compute_sim3(cfg, self.m, kf_id, cand)
            if not ok:
                continue
            amortize = cfg.gba_async_chunks > 0
            self.m = loop_closing.correct_loop(cfg, self.m, kf_id, cand, Scm,
                                               mesh=self.gba_mesh, run_gba=not amortize)
            # the global BA spread over the next keyframes; chunks pending from
            # an older loop are dropped (mbStopGBA, src/LoopClosing.cc:559-572)
            self._gba_chunks_left = cfg.gba_async_chunks if amortize else 0
            self.loop_state.last_loop_kf_seq = kf_seq
            self.n_loops_closed += 1
            fid = self.m.kf_frame_id.cpu().numpy()
            self.loop_closures.append(dict(kf_seq=kf_seq, kf=kf_id, cand=cand,
                                           kf_frame=int(fid[kf_id]),
                                           cand_frame=int(fid[cand])))
            self._kfs_since_gba = 0
            break
        self.stage_ms = {"mapping": (t_loop0 - pend["t_kf0"]) * 1e3,
                         "loop": (time.time() - t_loop0) * 1e3}
        gba_chunk_ran = False
        if self.n_loops_closed == loops_before and self._gba_chunks_left > 0:
            self._gba_chunk()     # one amortized chunk per later keyframe
            gba_chunk_ran = True
        corrected = (self._maybe_periodic_gba() or gba_chunk_ran or
                     self.n_loops_closed != loops_before)
        pend["corrected"] = corrected
        if corrected:
            # the correction or the global BA moved the keyframes (this one
            # too): tracking continues from its pose, and the motion model,
            # computed against the old poses, is dropped
            self.velocity = None
            return self.m.kf_pose[kf_id].cpu().numpy(), matched_pt
        return pend["Tcw"], matched_pt

    def _maybe_periodic_gba(self) -> bool:
        """The opt-in periodic global BA (cfg.gba_every_n_kf > 0) that bounds
        scale drift on loop-free sequences; the reference runs it only on a
        closure (src/LoopClosing.cc:873-1017). A closure restarts the
        count."""
        if self.cfg.gba_every_n_kf <= 0:
            return False
        self._kfs_since_gba += 1
        if self._kfs_since_gba < self.cfg.gba_every_n_kf:
            return False
        self._kfs_since_gba = 0
        self.m = loop_closing.run_global_ba(self.cfg, self.m, mesh=self.gba_mesh)
        return True

    def _need_kf_from_scalars(self, sc, fid=None) -> bool:
        """NeedNewKeyFrame (`src/Tracking.cc:1499-1623`) from the step's
        scalars; fid is the frame they belong to (behind self.frame_id by
        the pipeline depth in the stream)."""
        cfg = self.cfg
        if fid is None:
            fid = self.frame_id
        n_kf = self._nkf_cache()
        if n_kf >= cfg.max_keyframes - 2:
            return False
        if fid < self.last_reloc_frame_id + int(cfg.fps) and n_kf > int(cfg.fps):
            # no new keyframes for one second after a relocalization
            # (src/Tracking.cc:1513-1515)
            return False
        n_inliers, ref_matches = int(sc[3]), int(sc[4])
        close_tracked, close_untracked = int(sc[5]), int(sc[6])
        frames_since = fid - self.last_kf_frame_id
        th_ratio = 0.4 if n_kf < 2 else 0.75 if cfg.sensor != SENSOR_MONOCULAR else 0.9
        need_close = (cfg.sensor != SENSOR_MONOCULAR and
                      close_tracked < 100 and close_untracked > 70)
        # bLocalMappingIdle (src/Tracking.cc:1537,1546-1567): the mapper
        # counts as busy for mapper_busy_frames_effective frames after an
        # insertion, one mapping iteration's wall time at the camera rate,
        # once the map has 10 keyframes (a young map's iteration is far
        # cheaper than a frame interval)
        busy_window = cfg.mapper_busy_frames_effective if n_kf >= 10 else 0
        idle = frames_since > busy_window
        c1a = frames_since >= int(cfg.fps)
        c1c = cfg.sensor != SENSOR_MONOCULAR and (n_inliers < ref_matches * 0.25 or need_close)
        c2 = (n_inliers < ref_matches * th_ratio or need_close) and n_inliers > 15
        if not ((c1a or idle or c1c) and c2):
            return False
        # mapper busy (src/Tracking.cc:1592-1623): stereo / RGB-D insert
        # anyway (each pass runs to completion here, so the queue is empty);
        # monocular never does
        return idle or cfg.sensor != SENSOR_MONOCULAR

    def _nkf_cache(self) -> int:
        # the host's keyframe count, refreshed from each event's summary and
        # at initialization: no device read per frame
        if self._n_kf_host is None:
            self._n_kf_host = int(self.m.n_keyframes)
        return self._n_kf_host

    # ------------------------------------------------------------------
    # Mode switches, reset, accessors (System::ActivateLocalizationMode,
    # Reset, GetTrackingState, src/System.cc:150-344, 621-639)
    # ------------------------------------------------------------------

    def activate_localization_mode(self):
        """Tracking only: no keyframes, no mapping (src/System.cc:164-194)."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def reset(self):
        """System::Reset (`src/Tracking.cc:2265-2313`): clear the map, the
        database and the trajectory and return to NOT_INITIALIZED."""
        self.m = self._empty_map()
        if self.voc is not None:
            self.db = self._empty_db()
        self.loop_state.reset()
        self._kfs_since_gba = 0
        self._gba_chunks_left = 0
        self.state = NOT_INITIALIZED
        self.velocity = None
        self.init_frame = None
        self.last_frame = None
        self.ref_kf = 0
        self.last_kf_frame_id = self.frame_id
        self.last_reloc_frame_id = -(1 << 30)
        self.trajectory = []
        self._kf_seq_host = 0
        self._kf_blackout_fid = -1
        self._n_kf_host = None
        self._pending.clear()      # results in flight belong to the old map
        self._chain = None
        if self._pending_mapping is not None:
            # the pass belongs to the old map; wait for it before its
            # snapshot goes back to the allocator
            self._wait_for_pass(self._pending_mapping)
            self._pending_mapping = None

    def get_tracking_state(self):
        return self.state

    def get_map_stats(self):
        return dict(n_keyframes=int(self.m.n_keyframes), n_map_points=int(self.m.n_points),
                    n_loops_closed=self.n_loops_closed,
                    state={NOT_INITIALIZED: "NOT_INITIALIZED", OK: "OK", LOST: "LOST"}[self.state],
                    last_inliers=self.n_inliers, frame_id=self.frame_id)

    def get_tracked_map_points(self):
        """The map point matched by each keypoint of the last frame (-1
        unmatched), System::GetTrackedMapPoints."""
        return None if self.last_matched_pt is None else self.last_matched_pt.cpu().numpy()

    def get_tracked_keypoints_un(self):
        """The last frame's undistorted keypoints and their validity,
        System::GetTrackedKeyPointsUn (`src/System.cc:634-639`)."""
        if self.last_frame is None:
            return None
        return self.last_frame.xy.cpu().numpy(), self.last_frame.valid.cpu().numpy()

    def draw_current_frame(self, img, path="frame.png"):
        """FrameDrawer::DrawFrame: the last tracked frame's keypoints over
        `img` with the status banner (`src/FrameDrawer.cc:33-208`), written
        to `path` (the headless form of the live viewer's panel). None
        before the first frame."""
        from .. import viewer
        if self.last_frame is None:
            return None
        matched = None if self.last_matched_pt is None else self.last_matched_pt >= 0
        return viewer.draw_frame(img, self.last_frame, matched_mask=matched, path=path,
                                 status=self.get_map_stats())

    # ------------------------------------------------------------------
    # Place recognition and relocalization
    # ------------------------------------------------------------------

    def _ensure_vocabulary(self, f: FrameData):
        if self.voc is not None:
            return
        self._voc_train_desc.append(f.desc.cpu().numpy()[f.valid.cpu().numpy()])
        if sum(len(x) for x in self._voc_train_desc) < 1500:
            return
        self.voc = bow_voc.build_vocabulary(np.concatenate(self._voc_train_desc), k=10, depth=3,
                                            device=self.device)
        self.db = self._empty_db()
        # the keyframes inserted before the vocabulary existed
        for k in np.nonzero(self.m.kf_valid.cpu().numpy())[0]:
            self.db = self.db.add(int(k), self._bow_vec(self.m.kf_desc[int(k)],
                                                        self.m.kf_feat_valid[int(k)]))
        self._voc_train_desc = []

    def _bow_vec(self, desc, valid):
        """The sorted sparse BoW row (words, weights) of a frame."""
        word, weight, _ = bow_voc.transform(self.voc, desc, valid)
        return bow_voc.bow_sparse(word, weight)

    def _on_keyframe_inserted(self, kf_id: int, f: FrameData):
        """Initialization's keyframe into the vocabulary's training set and
        the database."""
        self._ensure_vocabulary(f)
        if self.voc is not None:
            self.db = self.db.add(kf_id, self._bow_vec(f.desc, f.valid))

    def _relocalize(self, f: FrameData):
        """Tracking::Relocalization (`src/Tracking.cc:2039-2262`): BoW
        candidates, descriptor matching against each candidate keyframe's
        points (K4's node form), EPnP RANSAC, pose optimization (K6), and
        below 50 inliers the rescue rounds: a wide projection search of the
        candidate's points (th 10, ORBdist 100) and, at 30-50 inliers, a
        narrow one (th 3, ORBdist 64), re-optimizing after each (K4's window
        form and K6, :2172-2241). Returns (Tcw, matched_pt, kf, ok)."""
        if self.voc is None or self.db is None:
            return None, None, None, False
        cfg, m = self.cfg, self.m
        cand_mask, _, scores = bow_db.detect_reloc_candidates(self.db,
                                                              self._bow_vec(f.desc, f.valid),
                                                              m.covis)
        cand_mask = (cand_mask & m.kf_valid).cpu().numpy()
        order = [int(c) for c in np.argsort(-scores.cpu().numpy()) if cand_mask[c]]
        node_f = torch.where(f.valid, 0, -1).to(torch.int32)
        obs = torch.cat([f.xy, f.ur[:, None]], dim=-1)
        for k in order:
            f_ok = m.kf_feat_valid[k] & (m.kf_obs[k] >= 0)
            mm = matching.search_by_node(node_f, f.desc, f.valid, f.angle,
                                         torch.where(f_ok, 0, -1).to(torch.int32), m.kf_desc[k],
                                         f_ok, m.kf_angle[k], nn_ratio=0.75)
            pt = m.kf_obs[k][torch.clamp(mm.idx, 0, cfg.max_keypoints - 1).long()]
            valid = mm.valid & (pt >= 0)
            if int(valid.sum()) < 15:
                continue
            Xw = m.pt_pos[torch.clamp(pt, 0, m.capacity_pt - 1).long()]
            # fresh hypotheses per (frame, candidate): a retry after a failed
            # attempt must not redraw the same samples
            res = pnp.ransac_pnp(Xw, f.xy, f.level, valid, cfg.level_sigma2, float(cfg.fx),
                                 float(cfg.fy), float(cfg.cx), float(cfg.cy),
                                 generator=torch.Generator().manual_seed(self.frame_id * 131 + k))
            if not bool(res.ok):
                continue
            matched_pt = torch.where(res.inliers, pt, torch.full_like(pt, INVALID))
            opt = pose_opt.optimize_pose(self.cam, res.Tcw, Xw, obs, f.level, matched_pt >= 0,
                                         cfg.level_sigma2)
            n_good = int(opt.n_inliers)
            if n_good < 10:
                continue
            matched_pt = torch.where(opt.inliers, matched_pt, torch.full_like(matched_pt, INVALID))
            Tcw = opt.Tcw
            if n_good < 50:
                Tcw, matched_pt, n_inl = tracking_ops.reloc_rescue(
                    cfg, m, k, f, Tcw, matched_pt, th=10.0, orb_dist=100)
                n_good = int(n_inl)
                if 30 < n_good < 50:
                    Tcw, matched_pt, n_inl = tracking_ops.reloc_rescue(
                        cfg, m, k, f, Tcw, matched_pt, th=3.0, orb_dist=64)
                    n_good = int(n_inl)
            if n_good >= 50:
                return Tcw, matched_pt, k, True
        return None, None, None, False

    # ------------------------------------------------------------------
    # Trajectory
    # ------------------------------------------------------------------

    def _rehome_trajectory(self, culled: np.ndarray):
        """A culled keyframe's slot may be reused and its pose goes stale,
        so every trajectory entry on it is re-based now onto its nearest
        surviving spanning-tree ancestor: T_rel <- T_rel * Tcp, ref <-
        parent (the reference's mTcp chain, `KeyFrame::SetBadFlag`, walked
        by `System::SaveTrajectoryTUM`, src/System.cc:431-505 at :476)."""
        m = self.m
        poses, valid = m.kf_pose.cpu().numpy(), m.kf_valid.cpu().numpy()
        parent = m.parent.cpu().numpy()
        remap = {}          # culled kf -> (survivor kf, Tcp)
        for k in np.nonzero(culled)[0]:
            p = int(parent[k])
            while p >= 0 and not valid[p]:
                p = int(parent[p])
            if p < 0:       # no surviving ancestor: the oldest valid keyframe
                alive = np.nonzero(valid)[0]
                if len(alive) == 0:
                    continue
                fid = m.kf_frame_id.cpu().numpy()
                p = int(alive[np.argmin(fid[alive])])
            remap[int(k)] = (p, poses[k] @ np.linalg.inv(poses[p]))
        if not remap:
            return
        for e in self.trajectory:
            if e.ref_kf in remap:
                p, Tcp = remap[e.ref_kf]
                e.T_rel = e.T_rel @ Tcp
                e.ref_kf = p
        if self.ref_kf in remap:
            self.ref_kf = remap[self.ref_kf][0]

    def _record(self, ts, T_rel, ref_kf, lost):
        self.trajectory.append(TrajectoryEntry(ts, np.asarray(T_rel), ref_kf, lost))

    def get_trajectory(self) -> List[Tuple[float, np.ndarray]]:
        """The camera trajectory, Twc per tracked frame: each stored relative
        pose composed with its keyframe's (possibly optimized) pose, the
        reference's SaveTrajectoryTUM walk (`src/System.cc:416-505`)."""
        poses = self.m.kf_pose.cpu().numpy()
        return [(e.timestamp, np.linalg.inv(e.T_rel @ poses[e.ref_kf]))
                for e in self.trajectory if not e.lost]

    def keyframe_trajectory(self):
        m = self.m
        poses, valid = m.kf_pose.cpu().numpy(), m.kf_valid.cpu().numpy()
        ts, fid = m.kf_timestamp.cpu().numpy(), m.kf_frame_id.cpu().numpy()
        return [(float(ts[k]), np.linalg.inv(poses[k])) for k in np.argsort(fid) if valid[k]]
