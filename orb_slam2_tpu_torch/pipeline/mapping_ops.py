"""Keyframe insertion (port of `orb_slam2_tpu/pipeline/mapping_ops.py`,
`_bump_counts` and `insert_keyframe`).

`Tracking::CreateNewKeyFrame` (`src/Tracking.cc:1638-1739`) and the RGB-D /
stereo initialization (`StereoInitialization`, `src/Tracking.cc:774-860`).
The rest of the keyframe event (point culling, triangulation, fusion, local
BA, keyframe culling) is not ported yet.
"""
from __future__ import annotations

import torch

from ..geometry import se3
from ..mapstate import map as mapstate
from ..utils.config import SlamConfig, SENSOR_MONOCULAR, reciprocal_f32
from .frame import FrameData, _camera

INVALID = -1


def unproject(cfg: SlamConfig, cur: FrameData):
    """(N,3) camera-frame points of the keypoints from their undistorted
    coordinates and depth (z clamped to 1e-6)."""
    cam = _camera(cfg, cur.xy.device)
    z = torch.clamp(cur.depth, min=1e-6)
    x = (cur.xy[:, 0] - cam.cx) * reciprocal_f32(cfg.fx) * z
    y = (cur.xy[:, 1] - cam.cy) * reciprocal_f32(cfg.fy) * z
    return torch.stack([x, y, z], dim=-1)


def _bump_counts(m: mapstate.MapState, point_ids, mask, weight):
    """Add observation weights to the cached pt_obs_cnt (one N-sized
    scatter instead of recounting the K*N incidence)."""
    P = m.capacity_pt
    add = mapstate.add_drop(
        torch.zeros((P,), dtype=torch.int32, device=point_ids.device),
        torch.where(mask, point_ids, torch.full_like(point_ids, P)),
        torch.where(mask, weight, torch.zeros_like(weight)).to(torch.int32))
    return m._replace(pt_obs_cnt=m.pt_obs_cnt + add)


def insert_keyframe(cfg: SlamConfig, m: mapstate.MapState, cur: FrameData,
                    Tcw, matched_pt, frame_id, timestamp,
                    all_depth: bool = False, update_stats: bool = True):
    """Insert the current frame as a keyframe at pose Tcw. matched_pt (N,):
    map-point ids from tracking. For stereo and RGB-D, unmatched features
    with depth spawn new map points: every one closer than ThDepth
    baselines, and the 100 nearest if fewer (`src/Tracking.cc:1675-1739`);
    with all_depth (initialization) every depth measurement spawns one.
    update_stats refreshes the observation table and the new points'
    descriptors and normals, as standalone insertion does. Returns
    (map, kf_id) with kf_id a 0-d int64 tensor."""
    P = m.capacity_pt
    # resolve the frame's bindings through the fusion forwarding and drop
    # culled points (CheckReplacedInLastFrame at insertion time)
    fwd = torch.where(matched_pt >= 0, m.pt_forward[torch.clamp(matched_pt, 0, P - 1).long()],
                      torch.full_like(matched_pt, INVALID))
    matched_pt = torch.where((fwd >= 0) & m.pt_valid[torch.clamp(fwd, 0, P - 1).long()],
                             fwd, torch.full_like(fwd, INVALID))
    m, kf_id = mapstate.add_keyframe(
        m, Tcw, cur.xy, cur.level, cur.angle, cur.desc, cur.ur, cur.depth,
        cur.valid, matched_pt, frame_id, timestamp)

    if cfg.sensor != SENSOR_MONOCULAR:
        n = matched_pt.shape[0]
        eligible = cur.valid & (cur.depth > 0) & (matched_pt < 0)
        close = cur.depth < cfg.th_depth * cfg.baseline
        depth_key = torch.where(eligible, cur.depth, torch.full_like(cur.depth, float("inf")))
        order = torch.argsort(depth_key, stable=True)     # quantized depths tie
        rank = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=order.device))
        create = eligible if all_depth else eligible & (close | (rank < 100))

        pw = se3.apply(se3.inverse(Tcw), unproject(cfg, cur))

        slots = mapstate.allocate_points(m, create)
        m = mapstate.add_points(m, slots, pw, cur.desc, kf_id, m.next_kf - 1)
        m = mapstate.bind_observations(
            m, kf_id, torch.arange(n, device=slots.device), slots, create & (slots >= 0))

    m = mapstate.update_connections(m, kf_id)
    # keep the cached counts current: +1 mono / +2 stereo per binding
    bound = mapstate.take(m.kf_obs, kf_id)
    w = torch.where(mapstate.take(m.kf_ur, kf_id) >= 0, 2, 1)
    m = _bump_counts(m, torch.clamp(bound, 0, P - 1), bound >= 0, w)
    m = mapstate.table_append_keyframe(m, kf_id)
    if update_stats:
        mask = mapstate.put_drop(
            torch.zeros((P,), dtype=torch.bool, device=bound.device),
            torch.where(bound >= 0, bound, torch.full_like(bound, P)),
            torch.ones((), dtype=torch.bool, device=bound.device))
        obs = mapstate.point_observations(m, 16)
        m = mapstate.refresh_obs_table(m, obs=obs)
        m = mapstate.update_point_descriptors(m, mask, obs=obs)
        m = mapstate.update_point_normals(m, mask, cfg.scale_factors, obs=obs)
    return m, kf_id
