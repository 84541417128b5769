"""Building blocks of the tracking step (port of
`orb_slam2_tpu/pipeline/tracking_ops.py`): local-map selection, local-map
tracking, the map's visible/found counters and the keyframe-decision
statistics of `Tracking::Track` (`src/Tracking.cc:431-767`).

None of them reads a value back to the host; neither does the
relocalization rescue round (`reloc_rescue`).
"""
from __future__ import annotations

import math

import torch

from ..geometry import se3
from ..mapstate import map as mapstate
from ..ops import matching
from ..solvers import pose_opt
from ..utils.config import SlamConfig, reciprocal_f32
from .frame import FrameData, _camera

INVALID = -1


def select_local_map(m: mapstate.MapState, matched_pt, max_kf: int = 80,
                     max_pts: int = 8192):
    """`Tracking::UpdateLocalKeyFrames/Points` (`src/Tracking.cc:1841-1978`):
    K1 = keyframes observing the frame's matched points, K2 = their
    covisibility neighbours, max_kf in all; the local points are the union
    of their observations, max_pts at most. Returns (local_kf (max_kf,),
    local_mask, ref_kf, local_pt (max_pts,), pt_mask)."""
    P, K = m.capacity_pt, m.capacity_kf
    share = mapstate.shared_observers(m, matched_pt, matched_pt >= 0) * m.kf_valid
    ref_kf = torch.argmax(share)                               # first maximum
    k1 = share > 0
    # neighbour score: the best covisibility weight to any K1 keyframe
    neigh = torch.where(k1[:, None], m.covis, torch.zeros_like(m.covis)).max(dim=0).values
    score = torch.where(k1, share + 100000, neigh) * m.kf_valid
    w, local_kf = matching.top_k(score, min(max_kf, K))
    local_mask = w > 0

    rows = m.kf_obs[local_kf]                                  # (L,N)
    rows = torch.where(local_mask[:, None], rows, torch.full_like(rows, INVALID))
    flat = rows.reshape(-1)
    present = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=flat.device),
                                torch.where(flat >= 0, flat, torch.full_like(flat, P)),
                                torch.ones((), dtype=torch.bool, device=flat.device))
    local_pt, pt_mask = mapstate.compact_mask(present & m.pt_valid, max_pts)
    return local_kf, local_mask, ref_kf, local_pt, pt_mask


def _project(cam, Tcw, pos):
    """Camera-frame points, pixel projections (z clamped to 1e-6) and the
    clamped depth."""
    pc = se3.apply(Tcw, pos)
    z = torch.clamp(pc[..., 2], min=1e-6)
    uv = torch.stack([cam.fx * pc[..., 0] / z + cam.cx, cam.fy * pc[..., 1] / z + cam.cy],
                     dim=-1)
    return pc, uv, z


def track_local_map(cfg: SlamConfig, m: mapstate.MapState, Tcw, cur: FrameData,
                    matched_pt, local_pt, local_pt_mask, th: float = 1.0):
    """`Tracking::TrackLocalMap` (`src/Tracking.cc:1424-1498`) with
    `SearchLocalPoints` (`:1745-1831`) and `Frame::isInFrustum`
    (`src/Frame.cc:490-580`): project the local points, search the frame for
    the ones in the frustum not matched yet (K5), merge, and optimize the
    pose over all matches (K6). Returns (Tcw, matched_pt, n_inliers,
    visible_pt_ids, found_pt_ids)."""
    dev = Tcw.device
    cam = _camera(cfg, dev)
    P = m.capacity_pt
    lp = local_pt.long()
    pos = m.pt_pos[lp]
    pc, uv, zc = _project(cam, Tcw, pos)
    z = pc[..., 2]
    po = pos - se3.translation(se3.inverse(Tcw))
    dist = torch.sqrt(torch.sum(po * po, dim=-1))
    view_cos = torch.sum(po * m.pt_normal[lp], dim=-1) / torch.clamp(dist, min=1e-9)
    max_pt = m.pt_max_dist[lp]
    in_frustum = (z > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < cfg.width) & \
        (uv[..., 1] >= 0) & (uv[..., 1] < cfg.height) & \
        (dist >= 0.8 * m.pt_min_dist[lp]) & (dist <= 1.2 * max_pt) & \
        (view_cos > 0.5) & local_pt_mask

    # predicted octave from the distance (MapPoint::PredictScale)
    ratio = max_pt / torch.clamp(dist, min=1e-9)
    pred_level = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) *
                   reciprocal_f32(math.log(cfg.scale_factor))).to(torch.int32),
        0, cfg.n_levels - 1)

    # skip points the motion model already matched to this frame
    already = mapstate.put_drop(
        torch.zeros((P,), dtype=torch.bool, device=dev),
        torch.where(matched_pt >= 0, matched_pt, torch.full_like(matched_pt, P)),
        torch.ones((), dtype=torch.bool, device=dev))
    search_mask = in_frustum & ~already[lp]
    if cfg.bf > 0:
        ur_proj = uv[..., 0] - cam.bf / zc
    else:
        ur_proj = torch.full_like(z, -1.0)
    mm = matching.search_by_projection_points(
        uv, pred_level, view_cos, m.pt_desc[lp], search_mask, ur_proj,
        cur.xy, cur.level, cur.desc, cur.valid, cur.ur,
        cfg.scale_factors, th=th, nn_ratio=0.8,
        already_matched=matched_pt >= 0)

    # merge: new matches fill the keypoints not taken yet
    N = cur.xy.shape[0]
    new_matched = mapstate.put_drop(
        torch.full((N,), INVALID, dtype=torch.int32, device=dev),
        torch.where(mm.valid, mm.idx, torch.full_like(mm.idx, N)), local_pt)
    merged = torch.where(matched_pt >= 0, matched_pt, new_matched)

    has = merged >= 0
    Xw = m.pt_pos[torch.clamp(merged, 0, P - 1).long()]
    obs = torch.cat([cur.xy, cur.ur[:, None]], dim=-1)
    res = pose_opt.optimize_pose(cam, Tcw, Xw, obs, cur.level, has, cfg.level_sigma2)
    final = torch.where(res.inliers, merged, torch.full_like(merged, INVALID))
    visible_ids = torch.where(in_frustum, local_pt, torch.full_like(local_pt, INVALID))
    return res.Tcw, final, res.n_inliers, visible_ids, final


def reloc_rescue(cfg: SlamConfig, m: mapstate.MapState, kf_id, cur: FrameData, Tcw,
                 matched_pt, th: float, orb_dist: int):
    """One relocalization rescue round (`src/Tracking.cc:2172-2241`): project
    the candidate keyframe's map points at the pose estimate (the wide round
    th=10 / ORBdist=100, the narrow th=3 / ORBdist=64), search the frame's
    unmatched keypoints for them (K4's window form), merge with the matches
    already found and optimize the pose over the union (K6). Returns (Tcw',
    matched_pt', n_inliers)."""
    dev = Tcw.device
    cam = _camera(cfg, dev)
    P = m.capacity_pt
    k = torch.as_tensor(kf_id, device=dev).long()
    pt = mapstate.take(m.kf_obs, k)                  # map point per keyframe feature
    ptc = torch.clamp(pt, 0, P - 1).long()
    pos = m.pt_pos[ptc]
    # skip points already matched into the frame (sAlreadyFound)
    already = mapstate.put_drop(
        torch.zeros((P,), dtype=torch.bool, device=dev),
        torch.where(matched_pt >= 0, matched_pt, torch.full_like(matched_pt, P)),
        torch.ones((), dtype=torch.bool, device=dev))
    pc, uv, _ = _project(cam, Tcw, pos)
    z = pc[..., 2]
    pvalid = (pt >= 0) & m.pt_valid[ptc] & ~already[ptc] & (z > 0) & \
        (uv[..., 0] >= 0) & (uv[..., 0] < cfg.width) & (uv[..., 1] >= 0) & (uv[..., 1] < cfg.height)
    po = pos - se3.translation(se3.inverse(Tcw))
    dist = torch.sqrt(torch.sum(po * po, dim=-1))
    ratio = m.pt_max_dist[ptc] / torch.clamp(dist, min=1e-9)
    pred_level = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) *
                   reciprocal_f32(math.log(cfg.scale_factor))).to(torch.int32),
        0, cfg.n_levels - 1)
    mm = matching.search_by_projection_reloc(
        uv, pred_level, mapstate.take(m.kf_desc, k), pvalid, mapstate.take(m.kf_angle, k),
        cur.xy, cur.level, cur.desc, cur.valid, cur.angle, matched_pt >= 0,
        cfg.scale_factors, th=th, orb_dist=orb_dist)
    N = cur.xy.shape[0]
    new_matched = mapstate.put_drop(
        torch.full((N,), INVALID, dtype=torch.int32, device=dev),
        torch.where(mm.valid, mm.idx, torch.full_like(mm.idx, N)), pt)
    merged = torch.where(matched_pt >= 0, matched_pt, new_matched)
    has = merged >= 0
    Xw = m.pt_pos[torch.clamp(merged, 0, P - 1).long()]
    obs = torch.cat([cur.xy, cur.ur[:, None]], dim=-1)
    res = pose_opt.optimize_pose(cam, Tcw, Xw, obs, cur.level, has, cfg.level_sigma2)
    final = torch.where(res.inliers, merged, torch.full_like(merged, INVALID))
    return res.Tcw, final, res.n_inliers


def keyframe_stats(cfg: SlamConfig, m: mapstate.MapState, ref_kf, cur: FrameData,
                   matched_pt):
    """Statistics for `Tracking::NeedNewKeyFrame` (`src/Tracking.cc:1499-1623`):
    (ref_matches, n_close_tracked, n_close_untracked), each () int32."""
    min_obs = torch.where(m.n_keyframes <= 2, 2, 3)
    ref_obs = mapstate.take(m.kf_obs, ref_kf)
    cnt = m.pt_obs_cnt[torch.clamp(ref_obs, 0, m.capacity_pt - 1).long()]
    ref_matches = ((ref_obs >= 0) & (cnt >= min_obs)).sum(dtype=torch.int32)
    close = (cur.depth > 0) & (cur.depth < cfg.th_depth * cfg.baseline) & cur.valid
    tracked = (close & (matched_pt >= 0)).sum(dtype=torch.int32)
    untracked = (close & (matched_pt < 0)).sum(dtype=torch.int32)
    return ref_matches, tracked, untracked


def update_counters(m: mapstate.MapState, visible_ids, found_ids, cfg: SlamConfig):
    """mnVisible / mnFound increments (`MapPoint::IncreaseVisible/Found`)."""
    P = m.capacity_pt

    def count(ids):
        return mapstate.add_drop(torch.zeros((P,), dtype=torch.int32, device=ids.device),
                                 torch.where(ids >= 0, ids, torch.full_like(ids, P)),
                                 torch.ones((), dtype=torch.int32, device=ids.device))

    return m._replace(pt_visible=m.pt_visible + count(visible_ids),
                      pt_found=m.pt_found + count(found_ids))
