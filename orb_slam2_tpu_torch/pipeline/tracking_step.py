"""The per-frame tracking step (port of
`orb_slam2_tpu/pipeline/tracking_step.py`).

`Tracking::Track` (`src/Tracking.cc:431-767`) for a frame after
initialization: motion-model matching (with the wide-window retry), the
reference-keyframe fallback, local-map selection and tracking, the map's
counters, the keyframe statistics and the next frame's 3D points. The
reference runs it as one jitted program with two `lax.cond`s; here they are
two Python `if`s on one value read back from the card each, the step's only
host syncs (`HOST_READS` counts them). Everything else is queued on the
card without waiting.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..mapstate import map as mapstate
from ..ops import matching
from ..solvers import pose_opt
from ..utils.config import SlamConfig, SENSOR_MONOCULAR, SENSOR_RGBD
from . import tracking_ops
from .frame import (FrameData, _camera, make_frame_monocular, make_frame_rgbd,
                    make_frame_stereo)
from .mapping_ops import unproject

INVALID = -1
HOST_READS = {"count": 0}   # values the step read back from the card


class TrackStepResult(NamedTuple):
    m: mapstate.MapState
    frame: FrameData            # the current frame
    Tcw: torch.Tensor           # (4,4)
    T_rel: torch.Tensor         # (4,4) Tcw * inv(T_ref_kf), for the trajectory
    matched_pt: torch.Tensor    # (N,) map point per keypoint
    next_pts: torch.Tensor      # (N,3) 3D points for the next motion step
    next_pts_valid: torch.Tensor
    ref_kf: torch.Tensor        # () best-sharing keyframe
    scalars: torch.Tensor       # (11,) int32: [ok, n_mm_matches, n_mm_inliers,
                                #  n_local_inliers, ref_matches, close_tracked,
                                #  close_untracked, used_fallback, ref_kf,
                                #  pose_ok (motion/reference track succeeded,
                                #  before the local-map inlier gate),
                                #  used_retry (the port's addition: the
                                #  wide-window motion search ran)]
    packed: torch.Tensor        # (43,) f32 = [scalars, Tcw.ravel, T_rel.ravel]
    next_vel: torch.Tensor      # (4,4) motion model for the next frame


def _read(t) -> int:
    """One value back from the card: a host sync, counted."""
    HOST_READS["count"] += 1
    return int(t)


def velocity_step(Tcw, T_prev):
    """The motion model for the next frame, Tcw * T_prev^-1
    (`src/Tracking.cc:680-686`), orthonormalized: chained float32 poses drift
    off SO(3) and the transpose-form inverse amplifies the drift."""
    return se3.orthonormalize(Tcw @ se3.inverse(se3.orthonormalize(T_prev)))


def _motion_model(cfg, cam, T_pred, last, last_pts, last_pts_valid,
                  last_matched_pt, cur, th, check_rotation):
    pc = se3.apply(T_pred, last_pts)
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    uv = torch.stack([cam.fx * pc[..., 0] / zc + cam.cx,
                      cam.fy * pc[..., 1] / zc + cam.cy], dim=-1)
    ur_proj = torch.where(last.ur >= 0, uv[..., 0] - cam.bf / zc, torch.full_like(z, -1.0))
    in_img = (z > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < cfg.width) & \
        (uv[..., 1] >= 0) & (uv[..., 1] < cfg.height)
    mm = matching.search_by_projection_frame(
        uv, last.level, last.desc, last_pts_valid & in_img, last.angle, ur_proj,
        cur.xy, cur.level, cur.desc, cur.valid, cur.angle, cur.ur,
        cfg.scale_factors, th, forward=False, backward=False,
        check_rotation=check_rotation)
    N = cur.xy.shape[0]
    kp_last = mapstate.put_drop(
        torch.full((N,), INVALID, dtype=torch.int32, device=z.device),
        torch.where(mm.valid, mm.idx, torch.full_like(mm.idx, N)),
        torch.arange(last_pts.shape[0], dtype=torch.int32, device=z.device))
    # map to map-point ids through the last frame's bindings
    src = torch.clamp(kp_last, 0, N - 1).long()
    has3d = kp_last >= 0
    matched = torch.where(has3d, last_matched_pt[src], torch.full_like(kp_last, INVALID))
    return matched, has3d, last_pts[src], has3d.sum(dtype=torch.int32)


def full_tracking_step(cfg: SlamConfig, m: mapstate.MapState, cur: FrameData,
                       last: FrameData, last_pts, last_pts_valid, last_matched_pt,
                       T_last, velocity, has_velocity: bool, ref_kf_in,
                       min_local_inliers: int = 30) -> TrackStepResult:
    """min_local_inliers: the local-map acceptance floor, 30 normally and 50
    within a second of a relocalization (`src/Tracking.cc:1471-1477`)."""
    return _step(cfg, m, cur, last, last_pts, last_pts_valid, last_matched_pt,
                 T_last, velocity, has_velocity, ref_kf_in, min_local_inliers)


def full_tracking_step_from_images(cfg: SlamConfig, m: mapstate.MapState, images,
                                   last: FrameData, last_pts, last_pts_valid,
                                   last_matched_pt, T_last, velocity,
                                   has_velocity: bool, ref_kf_in,
                                   min_local_inliers: int, sensor: str
                                   ) -> TrackStepResult:
    """Frame construction and the tracking step: the steady-state per-frame
    path. images: (img,) mono, (img, depth) rgbd, (left, right) stereo."""
    if sensor == "rgbd":
        cur = make_frame_rgbd(images[0], images[1], cfg)
    elif sensor == "stereo":
        cur = make_frame_stereo(images[0], images[1], cfg)
    else:
        cur = make_frame_monocular(images[0], cfg)
    return _step(cfg, m, cur, last, last_pts, last_pts_valid, last_matched_pt,
                 T_last, velocity, has_velocity, ref_kf_in, min_local_inliers)


def _ref_track(cfg, cam, m, cur, T_last, ref_kf_in, obs):
    """TrackReferenceKeyFrame: match the frame against the reference
    keyframe's bound features (K4), then optimize from the last pose (K6)."""
    N = cur.xy.shape[0]
    k = torch.clamp(ref_kf_in, 0, m.capacity_kf - 1)
    kf_obs = mapstate.take(m.kf_obs, k)
    f_ok = mapstate.take(m.kf_feat_valid, k) & (kf_obs >= 0)
    zero = torch.zeros((), dtype=torch.int32, device=kf_obs.device)
    mm = matching.search_by_node(
        torch.where(cur.valid, zero, zero - 1), cur.desc, cur.valid, cur.angle,
        torch.where(f_ok, zero, zero - 1), mapstate.take(m.kf_desc, k), f_ok,
        mapstate.take(m.kf_angle, k),
        nn_ratio=0.7)
    tgt = kf_obs[torch.clamp(mm.idx, 0, N - 1).long()]
    matched = torch.where(mm.valid & (tgt >= 0), tgt, torch.full_like(tgt, INVALID))
    has = matched >= 0
    Xw = m.pt_pos[torch.clamp(matched, 0, m.capacity_pt - 1).long()]
    res = pose_opt.optimize_pose(cam, T_last, Xw, obs, cur.level, has, cfg.level_sigma2)
    ok = (res.n_inliers >= 10) & (has.sum(dtype=torch.int32) >= 15)
    return res.Tcw, torch.where(res.inliers, matched, torch.full_like(matched, INVALID)), ok


def _step(cfg: SlamConfig, m: mapstate.MapState, cur: FrameData, last: FrameData,
          last_pts, last_pts_valid, last_matched_pt, T_last, velocity,
          has_velocity: bool, ref_kf_in, min_local_inliers) -> TrackStepResult:
    dev = cur.xy.device
    cam = _camera(cfg, dev)
    P = m.capacity_pt
    if not isinstance(ref_kf_in, torch.Tensor):   # a fill, not a host copy
        ref_kf_in = torch.full((), int(ref_kf_in), dtype=torch.int64, device=dev)
    # CheckReplacedInLastFrame (src/Tracking.cc:1135-1163): resolve the last
    # frame's bindings through the fusion forwarding, drop dead points
    lmp = torch.where(last_matched_pt >= 0,
                      m.pt_forward[torch.clamp(last_matched_pt, 0, P - 1).long()],
                      torch.full_like(last_matched_pt, INVALID))
    last_matched_pt = torch.where((lmp >= 0) & m.pt_valid[torch.clamp(lmp, 0, P - 1).long()],
                                  lmp, torch.full_like(lmp, INVALID))
    T_pred = velocity @ T_last if has_velocity else T_last
    th1 = 15.0 if cfg.sensor == SENSOR_MONOCULAR else 7.0

    # --- motion model, with the wide-window retry when matches are scarce ---
    args = (cfg, cam, T_pred, last, last_pts, last_pts_valid, last_matched_pt, cur)
    matched_mm, has_mm, Xw_mm, n_mm = _motion_model(*args, th1, True)
    retried = _read(n_mm) < 20
    if retried:
        matched_mm, has_mm, Xw_mm, n_mm = _motion_model(*args, 2.0 * th1, False)

    obs = torch.cat([cur.xy, cur.ur[:, None]], dim=-1)
    res_mm = pose_opt.optimize_pose(cam, T_pred, Xw_mm, obs, cur.level, has_mm,
                                    cfg.level_sigma2)
    mm_ok = (res_mm.n_inliers >= 10) & (n_mm >= 20)

    # --- reference-keyframe fallback (TrackReferenceKeyFrame) ---
    if _read(mm_ok):
        Tcw_1 = res_mm.Tcw
        matched_1 = torch.where(res_mm.inliers & (matched_mm >= 0), matched_mm,
                                torch.full_like(matched_mm, INVALID))
        ok_1 = mm_ok
    else:
        Tcw_1, matched_1, ok_1 = _ref_track(cfg, cam, m, cur, T_last, ref_kf_in, obs)

    # --- local map tracking: search radius th=1, 3 for RGB-D
    # (src/Tracking.cc:1804-1807) ---
    _, _, ref_kf, local_pt, pt_mask = tracking_ops.select_local_map(
        m, matched_1, max_kf=cfg.max_local_keyframes, max_pts=cfg.max_local_points)
    th_local = 3.0 if cfg.sensor == SENSOR_RGBD else 1.0
    Tcw_2, matched_2, n_local, vis_ids, _ = tracking_ops.track_local_map(
        cfg, m, Tcw_1, cur, matched_1, local_pt, pt_mask, th=th_local)
    m = tracking_ops.update_counters(m, vis_ids, matched_2, cfg)
    ok_2 = ok_1 & (n_local >= min_local_inliers)

    ref_matches, close_tracked, close_untracked = tracking_ops.keyframe_stats(
        cfg, m, ref_kf, cur, matched_2)

    # --- the next frame's 3D points (UpdateLastFrame) ---
    pos = m.pt_pos[torch.clamp(matched_2, 0, P - 1).long()]
    has_pt = matched_2 >= 0
    if cfg.sensor != SENSOR_MONOCULAR:
        pw = se3.apply(se3.inverse(Tcw_2), unproject(cfg, cur))
        close = (cur.depth > 0) & (cur.depth < cfg.th_depth * cfg.baseline)
        temporal = close & ~has_pt & cur.valid
        pos = torch.where(temporal[:, None], pw, pos)
        next_valid = has_pt | temporal
    else:
        next_valid = has_pt

    i32 = torch.int32
    scalars = torch.stack([
        ok_2.to(i32), n_mm.to(i32), res_mm.n_inliers.to(i32), n_local.to(i32),
        ref_matches.to(i32), close_tracked.to(i32), close_untracked.to(i32),
        (~mm_ok).to(i32), ref_kf.to(i32), ok_1.to(i32),
        torch.full((), int(retried), dtype=i32, device=dev)])
    T_rel = Tcw_2 @ se3.inverse(mapstate.take(m.kf_pose, ref_kf))
    packed = torch.cat([scalars.to(torch.float32), Tcw_2.reshape(-1), T_rel.reshape(-1)])
    return TrackStepResult(m=m, frame=cur, Tcw=Tcw_2, T_rel=T_rel, matched_pt=matched_2,
                           next_pts=pos, next_pts_valid=next_valid, ref_kf=ref_kf,
                           scalars=scalars, packed=packed,
                           next_vel=velocity_step(Tcw_2, T_last))
