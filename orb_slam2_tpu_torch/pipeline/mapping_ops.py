"""The keyframe event (port of `orb_slam2_tpu/pipeline/mapping_ops.py`).

`Tracking::CreateNewKeyFrame` (`src/Tracking.cc:1638-1739`), the RGB-D /
stereo initialization (`StereoInitialization`, `src/Tracking.cc:774-860`)
and one iteration of `LocalMapping::Run` (`src/LocalMapping.cc:71-159`):
recent-point culling, epipolar triangulation against the covisible
neighbours (K8), two-way fusion (K5), local BA (the Schur solver, K9) and
keyframe culling, as functions of a MapState.

The reference's `lax.cond`s whose both sides are cheap at these sizes are
`torch.where`s on a device predicate (inside `mapstate`, and the post-cull
table rebuild below); two are host reads, counted in `HOST_READS`: the
fusion target list, read once per event, and whether the map holds more
than two keyframes (local BA and keyframe culling run only then).
"""
from __future__ import annotations

import math

import torch

from ..geometry import se3
from ..geometry.triangulation import triangulate as dlt
from ..mapstate import map as mapstate
from ..ops import cuda_match, matching
from ..solvers import schur_ba
from ..utils.config import (SlamConfig, SENSOR_MONOCULAR, device_cache, device_table,
                            reciprocal_f32)
from .frame import FrameData, _camera

INVALID = -1
HOST_READS = {"count": 0}   # values a keyframe event read back from the card


def _read(t):
    """Values back from the card: a host sync, counted."""
    HOST_READS["count"] += 1
    return t.tolist()


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
                    all_depth: bool = False, update_stats: bool = True,
                    table_fresh: bool = False):
    """Insert the current frame as a keyframe at pose Tcw. matched_pt (N,):
    map-point ids from tracking. For stereo and RGB-D, unmatched features
    with depth spawn new map points: every one closer than ThDepth
    baselines, and the 100 nearest if fewer (`src/Tracking.cc:1675-1739`);
    with all_depth (initialization) every depth measurement spawns one.
    update_stats refreshes the observation table and the new points'
    descriptors and normals, as standalone insertion does. table_fresh is
    the reference's promise that the cached table is current; covisibility
    is exact either way, so it changes nothing. Returns (map, kf_id) with
    kf_id a 0-d int64 tensor."""
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

    m = mapstate.update_connections(m, kf_id, use_table=table_fresh)
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


# ---------------------------------------------------------------------------
# Map point culling (LocalMapping::MapPointCulling, src/LocalMapping.cc:245-289)
# ---------------------------------------------------------------------------

def cull_map_points(cfg: SlamConfig, m: mapstate.MapState, cur_kf=None):
    """Recently created points must earn their keep: found/visible >= 0.25,
    and more than 2 (mono) / 3 (stereo) weighted observations once two
    keyframes have passed since their creation. cur_kf: the just-inserted
    keyframe, whose bindings postdate the cached table (swept directly)."""
    age = (m.next_kf - 1) - m.pt_first_kf
    recent = m.pt_valid & (age <= 2)
    ratio = m.pt_found.to(torch.float32) / torch.clamp(m.pt_visible.to(torch.float32), min=1.0)
    th_obs = 2 if cfg.sensor == SENSOR_MONOCULAR else 3
    bad = recent & ((ratio < 0.25) | ((age >= 2) & (m.pt_obs_cnt <= th_obs)))
    if cur_kf is None:
        return mapstate.erase_points(m, bad)
    return mapstate.erase_points_fast(m, bad, extra_row=cur_kf)


# ---------------------------------------------------------------------------
# Triangulation (LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:295-622)
# ---------------------------------------------------------------------------

@device_cache()
def _intrinsics(cfg: SlamConfig, device):
    """K and its inverse (float32, inverted on the CPU by LAPACK as the
    reference inverts it) on `device`."""
    K = torch.tensor([[cfg.fx, 0.0, cfg.cx], [0.0, cfg.fy, cfg.cy], [0.0, 0.0, 1.0]],
                     dtype=torch.float32)
    return K.to(device), torch.linalg.inv(K).to(device)


def _fundamental_from_poses(cfg: SlamConfig, T1w, T2w):
    """F12 = K^-T [t12]x R12 K^-1 (`ComputeF12`, `src/LocalMapping.cc:749-866`);
    T2w may carry a leading batch axis."""
    _, Kinv = _intrinsics(cfg, T1w.device)
    T12 = T1w @ se3.inverse(T2w)
    return Kinv.T @ se3.hat(se3.translation(T12)) @ se3.rotation(T12) @ Kinv


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _rank(key):
    """Each entry's position in the stable ascending order of key (B,N)."""
    order = torch.argsort(key, dim=-1, stable=True)
    pos = torch.arange(key.shape[-1], dtype=torch.int32, device=key.device).expand(key.shape)
    return torch.empty_like(pos).scatter_(-1, order, pos)


def _epi_match_batch(cfg: SlamConfig, m: mapstate.MapState, kf1, neighbor_ids):
    """Epipolar-gated Hamming match of kf1 against each covisible neighbour
    in one K8 launch (its twin on the CPU): torch computes the fundamental
    matrices, the epipoles and the neighbours' rows; the kernel gathers each
    feature's line, masks and octave terms from the map's arrays in the XLA
    path's form (`_triangulate_decide:204-220`). Returns (best, best_idx),
    (B,N) int32."""
    cam = _camera(cfg, m.kf_pose.device)
    K = m.capacity_kf
    kf2 = torch.clamp(torch.clamp(neighbor_ids, min=0), 0, K - 1).long()
    T1 = mapstate.take(m.kf_pose, kf1)
    T2b = m.kf_pose[kf2]
    F = _fundamental_from_poses(cfg, T1, T2b)                    # (B,3,3)
    e2 = se3.apply(T2b, se3.translation(se3.inverse(T1)))        # (B,3)
    ez = torch.clamp(e2[:, 2], min=1e-9)
    epipoles = torch.stack([cam.fx * e2[:, 0] / ez + cam.cx, cam.fy * e2[:, 1] / ez + cam.cy], -1)
    return cuda_match.epi_match_keyframes(m.kf_obs, m.kf_feat_valid, m.kf_xy, m.kf_desc,
                                          m.kf_level, kf1, kf2, F.contiguous(), epipoles,
                                          tuple(cfg.level_sigma2), tuple(cfg.scale_factors))


def _triangulate_decide(cfg: SlamConfig, m: mapstate.MapState, kf1, kf2, match,
                        max_new: int = 256):
    """The match / triangulate / check half of CreateNewMapPoints against
    B neighbours kf2 (B,) at once, with no map mutation. match: the K8
    result (best, best_idx), (B,N). Parallax-gated DLT or the stereo
    unprojection, then the reference's checks: cheirality, reprojection
    chi2 (5.991 sigma^2 mono, 7.8 stereo) and scale consistency
    (`src/LocalMapping.cc:399-622`); at most max_new points per neighbour,
    best matches first. Returns (create, X, i2, best), each (B,N,...)."""
    cam = _camera(cfg, m.kf_pose.device)
    N = m.n_feat
    dev = m.kf_pose.device
    kf2 = kf2.long()
    T1 = mapstate.take(m.kf_pose, kf1)
    T2 = m.kf_pose[kf2]                                          # (B,4,4)
    O1 = se3.translation(se3.inverse(T1))
    O2 = se3.translation(se3.inverse(T2))                        # (B,3)
    baseline = _norm(O2 - O1)
    if cfg.sensor == SENSOR_MONOCULAR:
        # the baseline against each neighbour's median scene depth
        # (ComputeSceneMedianDepth, q = 2)
        obs2 = m.kf_obs[kf2]                                     # (B,N)
        z2 = se3.apply(T2[:, None], m.pt_pos[torch.clamp(obs2, 0, m.capacity_pt - 1).long()])
        z2 = torch.where(obs2 >= 0, z2[..., 2], float("inf"))
        mid = torch.clamp((obs2 >= 0).sum(dim=-1) // 2, 0, N - 1)
        med = torch.gather(torch.sort(z2, dim=-1).values, 1, mid[:, None])[:, 0]
        baseline_ok = baseline / torch.clamp(med, min=1e-9) > 0.01
    else:
        baseline_ok = baseline > cfg.baseline

    un1 = (mapstate.take(m.kf_obs, kf1) < 0) & mapstate.take(m.kf_feat_valid, kf1)
    xy1 = mapstate.take(m.kf_xy, kf1)
    sigma2 = device_table(tuple(cfg.level_sigma2), dev)
    sf = device_table(tuple(cfg.scale_factors), dev)
    best, best_idx = match
    accept = (best <= matching.TH_LOW) & un1[None, :]
    accept = matching.rotation_consistency(mapstate.take(m.kf_angle, kf1), m.kf_angle[kf2],
                                           accept, best_idx)
    keep = matching.resolve_conflicts(best_idx, best, accept, N)

    i2 = torch.clamp(best_idx, 0, N - 1).long()
    p1 = xy1
    p2 = torch.gather(m.kf_xy[kf2], 1, i2[..., None].expand(-1, -1, 2))       # (B,N,2)
    Kmat, Kinv = _intrinsics(cfg, dev)
    r1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=-1) @ Kinv.T
    r2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1) @ Kinv.T
    ray1 = r1 @ se3.rotation(T1)                                  # R1w^T r1
    ray2 = r2 @ se3.rotation(T2)
    cos_par = torch.sum(ray1 * ray2, dim=-1) / torch.clamp(_norm(ray1) * _norm(ray2), min=1e-12)

    d1 = mapstate.take(m.kf_depth, kf1)
    d2 = torch.gather(m.kf_depth[kf2], 1, i2)
    half_b = cfg.baseline / 2

    def cos_stereo(d):
        return torch.where(d > 0, torch.cos(2 * torch.atan2(torch.full_like(d, half_b),
                                                             torch.clamp(d, min=1e-6))),
                           torch.full_like(d, 2.0))

    cos_stereo1, cos_stereo2 = cos_stereo(d1), cos_stereo(d2)
    cos_st = torch.minimum(cos_stereo1, cos_stereo2)

    X_dlt = dlt(Kmat @ T1[:3, :], (Kmat @ T2[:, :3, :])[:, None], p1, p2)

    def unproject_at(T, p, d):
        z = torch.clamp(d, min=1e-6)
        pc = torch.stack([(p[..., 0] - cam.cx) * reciprocal_f32(cfg.fx) * z,
                          (p[..., 1] - cam.cy) * reciprocal_f32(cfg.fy) * z, z], dim=-1)
        return se3.apply(se3.inverse(T), pc)

    X_s1 = unproject_at(T1, p1, d1)
    X_s2 = unproject_at(T2[:, None], p2, d2)
    good_par = (cos_par > 0) & (cos_par < 0.9998) & (cos_par < cos_st)
    use_s1 = ~good_par & (cos_stereo1 < cos_stereo2) & (d1 > 0)
    use_s2 = ~good_par & ~use_s1 & (d2 > 0)
    X = torch.where(good_par[..., None], X_dlt,
                    torch.where(use_s1[..., None], X_s1, X_s2))
    has_X = good_par | use_s1 | use_s2

    def reproj_ok(T, p_obs, lvl, kf_ur):
        pc = se3.apply(T, X)
        z = pc[..., 2]
        zc = torch.clamp(z, min=1e-9)
        u = cam.fx * pc[..., 0] / zc + cam.cx
        v = cam.fy * pc[..., 1] / zc + cam.cy
        du, dv = u - p_obs[..., 0], v - p_obs[..., 1]
        err = du * du + dv * dv
        s2 = sigma2[torch.clamp(lvl, 0, cfg.n_levels - 1).long()]
        dr = u - cam.bf / zc - kf_ur
        ok = torch.where(kf_ur >= 0, err + dr * dr < 7.8 * s2, err < 5.991 * s2)
        return ok & (z > 0)

    lvl1 = torch.clamp(mapstate.take(m.kf_level, kf1), 0, cfg.n_levels - 1).long()
    lvl2 = torch.clamp(torch.gather(m.kf_level[kf2], 1, i2), 0, cfg.n_levels - 1).long()
    ok1 = reproj_ok(T1, p1, lvl1, mapstate.take(m.kf_ur, kf1))
    ok2 = reproj_ok(T2[:, None], p2, lvl2, torch.gather(m.kf_ur[kf2], 1, i2))

    dist1 = _norm(X - O1)
    dist2 = _norm(X - O2[:, None, :])
    ratio_dist = dist2 / torch.clamp(dist1, min=1e-9)
    ratio_octave = sf[lvl1] / sf[lvl2]
    ratio_factor = 1.5 * cfg.scale_factor
    scale_ok = (ratio_dist * ratio_factor > ratio_octave) & \
        (ratio_dist < ratio_octave * ratio_factor)
    create = keep & has_X & ok1 & ok2 & scale_ok & baseline_ok[:, None] & \
        (dist1 > 0) & (dist2 > 0)
    # at most max_new new points per neighbour, best matches first
    create = create & (_rank(torch.where(create, best, torch.full_like(best, 1 << 20)))
                       < max_new)
    return create, X, i2.to(torch.int32), best


def _commit_new_points(cfg: SlamConfig, m: mapstate.MapState, kf1, nb_ids, create, X,
                       i2, best):
    """Allocate and write the winning triangulations in one batch (N rows,
    one per kf1 feature): bind kf1's feature and the neighbour's, set the
    normals and scale bands in closed form from the two observations, bump
    the cached counts and write the two table entries. Returns (map,
    number of new points)."""
    N, K, P = m.n_feat, m.capacity_kf, m.capacity_pt
    dev = X.device
    slots = mapstate.allocate_points(m, create)
    m = mapstate.add_points(m, slots, X, mapstate.take(m.kf_desc, kf1), kf1, m.next_kf - 1)
    okc = create & (slots >= 0)
    feats = torch.arange(N, dtype=torch.int32, device=dev)
    m = mapstate.bind_observations(m, kf1, feats, slots, okc)
    nb = torch.clamp(nb_ids, 0, K - 1).long()
    m = m._replace(kf_obs=mapstate.put2_drop(
        m.kf_obs, torch.where(okc, nb, torch.full_like(nb, K)),
        torch.where(okc, i2, torch.zeros_like(i2)), slots))
    w = torch.where(mapstate.take(m.kf_ur, kf1) >= 0, 2, 1) + \
        torch.where(m.kf_ur[nb, i2.long()] >= 0, 2, 1)
    m = _bump_counts(m, torch.clamp(slots, 0, P - 1), okc, w)
    # the new points' table rows: exactly their two creating observations
    sic = torch.where(okc, slots, torch.full_like(slots, P))
    col0, col1 = torch.zeros_like(sic), torch.ones_like(sic)
    kf1b = torch.full_like(sic, 0) + kf1.to(torch.int32)
    m = m._replace(
        obs_kf=mapstate.put2_drop(mapstate.put2_drop(m.obs_kf, sic, col0, kf1b), sic, col1,
                                  nb.to(torch.int32)),
        obs_ft=mapstate.put2_drop(mapstate.put2_drop(m.obs_ft, sic, col0, feats), sic, col1,
                                  i2.to(torch.int32)))

    centers = se3.translation(se3.inverse(m.kf_pose))
    O1 = mapstate.take(centers, kf1)
    O2 = centers[nb]
    n1, n2 = X - O1, X - O2
    n1 = n1 / torch.clamp(_norm(n1), min=1e-9)[..., None]
    n2 = n2 / torch.clamp(_norm(n2), min=1e-9)[..., None]
    sf = device_table(tuple(cfg.scale_factors), dev)
    lvl1 = torch.clamp(mapstate.take(m.kf_level, kf1), 0, cfg.n_levels - 1).long()
    max_dist = _norm(X - O1) * sf[lvl1]
    si = torch.where(okc, slots, torch.full_like(slots, P))
    m = m._replace(
        pt_normal=mapstate.put_drop(m.pt_normal, si, 0.5 * (n1 + n2)),
        pt_max_dist=mapstate.put_drop(m.pt_max_dist, si, max_dist),
        pt_min_dist=mapstate.put_drop(m.pt_min_dist, si,
                                      max_dist * reciprocal_f32(cfg.scale_factors[-1])))
    return m, okc.sum(dtype=torch.int32)


def triangulate_with_neighbor(cfg: SlamConfig, m: mapstate.MapState, kf1, kf2,
                              max_new: int = 256):
    """New map points between keyframe kf1 and one covisible keyframe kf2
    (the single-neighbour form; the mapping pass uses triangulate_batch)."""
    nb = torch.as_tensor(kf2, dtype=torch.int32, device=m.kf_pose.device).reshape(1)
    return triangulate_batch(cfg, m, kf1, nb, max_new)


def triangulate_batch(cfg: SlamConfig, m: mapstate.MapState, kf1, neighbor_ids,
                      max_new: int = 256):
    """CreateNewMapPoints against all covisible neighbours neighbor_ids
    (nn,), -1 padded: one K8 launch for the matches, the decide phase
    batched over the neighbours, and a kf1 feature proposed by several
    neighbours taken by the first in covisibility order (the reference's
    sequential loop binds with the best-sharing neighbour first,
    `src/LocalMapping.cc:300-336`); then one allocation and commit.
    Returns (map, number of new points)."""
    match = _epi_match_batch(cfg, m, kf1, neighbor_ids)
    create_b, X_b, i2_b, best_b = _triangulate_decide(
        cfg, m, kf1, torch.clamp(neighbor_ids, min=0), match, max_new)
    create_b = create_b & (neighbor_ids >= 0)[:, None]
    winner = torch.argmax(create_b.to(torch.int32), dim=0)      # the first True
    rows = torch.arange(m.n_feat, device=winner.device)
    return _commit_new_points(cfg, m, kf1, neighbor_ids[winner], create_b[winner, rows],
                              X_b[winner, rows], i2_b[winner, rows], best_b[winner, rows])


# ---------------------------------------------------------------------------
# Fusion (LocalMapping::SearchInNeighbors + ORBmatcher::Fuse,
# src/LocalMapping.cc:623-749, src/ORBmatcher.cc:1472-1740)
# ---------------------------------------------------------------------------

def _fuse_decide(cfg: SlamConfig, m: mapstate.MapState, cnt, kf_id, pt_ids, pt_sel):
    """The match / decide half of ORBmatcher::Fuse, without map mutation:
    project the points pt_ids (B,) where pt_sel into keyframe kf_id, match
    them (K5, th = 3, no ratio test) and classify each hit as a bind (the
    keypoint is unbound) or a replacement pair. cnt: (P,) observation
    counts. Returns (feat_idx, bind, src, tgt, both, src_wins), each (B,)."""
    dev = m.pt_pos.device
    cam = _camera(cfg, dev)
    P, N = m.capacity_pt, m.n_feat
    Tcw = mapstate.take(m.kf_pose, kf_id)
    src = torch.clamp(pt_ids, 0, P - 1).long()
    pos = m.pt_pos[src]
    pc = se3.apply(Tcw, pos)
    z = pc[:, 2]
    zc = torch.clamp(z, min=1e-6)
    uv = torch.stack([cam.fx * pc[:, 0] / zc + cam.cx, cam.fy * pc[:, 1] / zc + cam.cy], dim=-1)
    po = pos - se3.translation(se3.inverse(Tcw))
    dist3 = _norm(po)
    view_cos = torch.sum(po * m.pt_normal[src], dim=-1) / torch.clamp(dist3, min=1e-9)
    max_d, min_d = m.pt_max_dist[src], m.pt_min_dist[src]
    row = mapstate.take(m.kf_obs, kf_id)
    already = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                                torch.where(row >= 0, row, torch.full_like(row, P)),
                                torch.ones((), dtype=torch.bool, device=dev))
    valid = pt_sel & m.pt_valid[src] & (z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < cfg.width) & \
        (uv[:, 1] >= 0) & (uv[:, 1] < cfg.height) & (dist3 >= 0.8 * min_d) & \
        (dist3 <= 1.2 * max_d) & (view_cos > 0.5) & ~already[src]

    ratio = max_d / torch.clamp(dist3, min=1e-9)
    pred_level = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) *
                   reciprocal_f32(math.log(cfg.scale_factor))).to(torch.int32),
        0, cfg.n_levels - 1)
    if cfg.bf > 0:
        ur_proj = uv[:, 0] - cam.bf / zc
    else:
        ur_proj = torch.full_like(z, -1.0)
    mm = matching.search_by_projection_points(
        uv, pred_level, view_cos, m.pt_desc[src], valid, ur_proj,
        mapstate.take(m.kf_xy, kf_id), mapstate.take(m.kf_level, kf_id),
        mapstate.take(m.kf_desc, kf_id), mapstate.take(m.kf_feat_valid, kf_id),
        mapstate.take(m.kf_ur, kf_id), cfg.scale_factors, th=3.0, nn_ratio=1.0)
    tgt = row[torch.clamp(mm.idx, 0, N - 1).long()]
    both = mm.valid & (tgt >= 0) & (tgt != src)
    src_wins = cnt[src] > cnt[torch.clamp(tgt, 0, P - 1).long()]
    bind = mm.valid & (tgt < 0)
    return mm.idx, bind, src.to(torch.int32), tgt, both, src_wins


def _fuse_mapping_update(mapping, src, tgt, both, src_wins, P: int):
    """Fold one decide round's replacement pairs into the (P,) mapping (a
    target named by two winners keeps the last, as the reference's scatter
    on the CPU does)."""
    mapping = mapstate.put_last(mapping, torch.where(both & src_wins, tgt, torch.full_like(tgt, P)),
                                src)
    return mapstate.put_last(mapping, torch.where(both & ~src_wins, src, torch.full_like(src, P)),
                             torch.clamp(tgt, 0, P - 1))


def fuse_into_keyframe(cfg: SlamConfig, m: mapstate.MapState, kf_id, pt_ids, pt_sel):
    """Project the points pt_ids (B,) where pt_sel into keyframe kf_id and,
    for each good match, keep the better-observed point where the keypoint
    is bound (Replace) or bind the point (the standalone form, loop
    closing's SearchAndFuse: the cached table is rebuilt first)."""
    P = m.capacity_pt
    m = mapstate.refresh_obs_table(m)
    idx, bind, src, tgt, both, src_wins = _fuse_decide(cfg, m, m.pt_obs_cnt, kf_id, pt_ids,
                                                       pt_sel)
    mapping = _fuse_mapping_update(torch.arange(P, dtype=torch.int32, device=src.device),
                                   src, tgt, both, src_wins, P)
    m = mapstate.replace_points_fast(m, mapping)
    m = mapstate.bind_observations(m, kf_id, idx, src, bind)
    # a bind whose point lost a duel in this call would dangle
    row = mapstate.take(m.kf_obs, kf_id)
    row = torch.where((row >= 0) & m.pt_valid[torch.clamp(row, 0, P - 1).long()], row,
                      torch.full_like(row, INVALID))
    return m._replace(kf_obs=m.kf_obs.index_copy(0, kf_id.view(1), row[None]))


def _fusion_targets(m: mapstate.MapState, kf_id, nn: int, cap: int):
    """SearchInNeighbors' two-level neighbour set (`src/LocalMapping.cc:637-661`):
    the top-nn covisible keyframes and 5 of each one's best covisible
    keyframes, first occurrences only, kf_id excluded, at most cap. Returns
    (ids (cap,) int32, -1 padded; valid (cap,))."""
    K = m.capacity_kf
    ids1, _ = mapstate.covisible_keyframes(m, kf_id, nn)
    lvl1_ok = ids1 >= 0
    rows = m.covis[torch.clamp(ids1, 0, K - 1).long()]
    rows = torch.where(lvl1_ok[:, None], rows, torch.zeros_like(rows)) * m.kf_valid[None, :]
    w2, ids2 = torch.sort(rows, dim=1, descending=True, stable=True)    # lax.top_k order
    w2, ids2 = w2[:, :5], ids2[:, :5].to(torch.int32)
    lvl2_ok = (w2 > 0) & lvl1_ok[:, None]
    cand = torch.cat([torch.where(lvl1_ok, ids1, torch.full_like(ids1, K)),
                      torch.where(lvl2_ok, ids2, torch.full_like(ids2, K)).reshape(-1)])
    cand = torch.where(cand == kf_id, torch.full_like(cand, K), cand)
    T0 = cand.shape[0]
    idx = torch.arange(T0, dtype=torch.int32, device=cand.device)
    first = torch.full((K + 1,), T0, dtype=torch.int32, device=cand.device).scatter_reduce(
        0, cand.long(), idx, reduce="amin")
    keep = (cand < K) & (first[cand.long()] == idx)
    order = torch.argsort((~keep).to(torch.int8), stable=True)[:cap]
    return torch.where(keep[order], cand[order], torch.full_like(cand[order], INVALID)), \
        keep[order]


# ---------------------------------------------------------------------------
# Local bundle adjustment (Optimizer::LocalBundleAdjustment,
# src/Optimizer.cc:646-1067)
# ---------------------------------------------------------------------------

def local_ba(cfg: SlamConfig, m: mapstate.MapState, kf_id, n_local: int = 32,
             n_fixed: int = 32, max_pts: int = 4096, max_obs: int = 12, obs=None):
    """Build the local BA problem around kf_id and solve it: local cameras
    kf_id and its best covisible keyframes, fixed cameras the other
    observers of the local points, at most max_pts points with max_obs
    observations each (from the given point-major table when obs is
    given). Poses and points are written back; observations the solver
    classifies as outliers are erased and their points' table rows
    revalidated."""
    return _local_ba(cfg, m, kf_id, n_local, n_fixed, max_pts, max_obs, obs)[0]


def _local_ba(cfg, m, kf_id, n_local, n_fixed, max_pts, max_obs, obs):
    """local_ba, and the number of outlier observations it erased."""
    cam = _camera(cfg, m.kf_pose.device)
    K, P = m.capacity_kf, m.capacity_pt
    dev = m.kf_pose.device
    yes = torch.ones((), dtype=torch.bool, device=dev)

    w = mapstate.take(m.covis, kf_id)
    w = torch.where(m.kf_valid, w, torch.zeros_like(w)).index_fill(0, kf_id.view(1), 1 << 20)
    lw, local_kf = matching.top_k(w, n_local)
    local_is = lw > 0
    is_local = mapstate.put_drop(torch.zeros((K,), dtype=torch.bool, device=dev),
                                 torch.where(local_is, local_kf, torch.full_like(local_kf, K)),
                                 yes)
    rows = m.kf_obs[torch.clamp(local_kf, 0, K - 1)]
    rows = torch.where(local_is[:, None], rows, torch.full_like(rows, INVALID)).reshape(-1)
    present = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                                torch.where(rows >= 0, rows, torch.full_like(rows, P)), yes)
    sel_pt, sel_ok = mapstate.compact_mask(present & m.pt_valid, max_pts)
    sel = sel_pt.long()

    if obs is None:
        obs_kf, obs_ft, obs_on = mapstate.point_observations(m, max_obs=max_obs)
    else:
        obs_kf, obs_ft, obs_on = (o[:, :max_obs] for o in obs)
    okf, oft = obs_kf[sel], obs_ft[sel]                          # (Q,O)
    oon = obs_on[sel] & sel_ok[:, None]
    kfc = torch.clamp(okf, 0, K - 1).long()
    ftc = torch.clamp(oft, 0, m.n_feat - 1).long()

    # fixed cameras: the observers that are not local
    obs_is_local = is_local[kfc] & oon
    need = oon & ~obs_is_local
    fixed_need = mapstate.put_drop(torch.zeros((K,), dtype=torch.bool, device=dev),
                                   torch.where(need, okf, torch.full_like(okf, K)).reshape(-1),
                                   yes) & m.kf_valid & ~is_local
    fixed_kf = torch.argsort((~fixed_need).to(torch.int8), stable=True)[:n_fixed]
    fixed_is = fixed_need[fixed_kf]

    C = n_local + n_fixed
    slot_of = torch.full((K,), INVALID, dtype=torch.int32, device=dev)
    slot_of = mapstate.put_drop(slot_of, torch.where(local_is, local_kf, torch.full_like(local_kf, K)),
                                torch.arange(n_local, dtype=torch.int32, device=dev))
    slot_of = mapstate.put_drop(slot_of, torch.where(fixed_is, fixed_kf, torch.full_like(fixed_kf, K)),
                                torch.arange(n_local, C, dtype=torch.int32, device=dev))
    cam_ids = torch.cat([local_kf, fixed_kf])
    cam_used = torch.cat([local_is, fixed_is])
    cam_fixed = torch.cat([torch.zeros(n_local, dtype=torch.bool, device=dev),
                           torch.ones(n_fixed, dtype=torch.bool, device=dev)])
    # gauge: with no fixed observer, the oldest local keyframe is fixed; the
    # first keyframe of the map always is (the reference fixes id 0)
    fid = m.kf_frame_id[torch.clamp(cam_ids, 0, K - 1)]
    any_fixed = (cam_fixed & cam_used).any()
    oldest = torch.argmin(torch.where(cam_used & ~cam_fixed, fid, torch.full_like(fid, 1 << 30)))
    cam_fixed = cam_fixed.index_copy(0, oldest.view(1),
                                     (mapstate.take(cam_fixed, oldest) | ~any_fixed).view(1))
    cam_fixed = cam_fixed | ((fid == 0) & cam_used)

    ocam = torch.where(oon, slot_of[kfc], torch.full_like(okf, INVALID))
    obs_uvr = torch.cat([m.kf_xy[kfc, ftc], m.kf_ur[kfc, ftc][..., None]], dim=-1)
    prob = schur_ba.BAProblem(poses=m.kf_pose[torch.clamp(cam_ids, 0, K - 1)],
                              cam_valid=cam_used, cam_fixed=cam_fixed,
                              points=m.pt_pos[sel], pt_valid=sel_ok, obs_cam=ocam,
                              obs_uvr=obs_uvr, obs_level=m.kf_level[kfc, ftc])
    res = schur_ba.solve_ba(cam, prob, cfg.level_sigma2, iters_a=cfg.ba_iters_a,
                            iters_b=cfg.ba_iters_b)

    wb = cam_used & ~cam_fixed
    outlier = (ocam >= 0) & ~res.edge_inlier
    m = m._replace(
        kf_pose=mapstate.put_drop(m.kf_pose, torch.where(wb, cam_ids, torch.full_like(cam_ids, K)),
                                  res.poses),
        pt_pos=mapstate.put_drop(m.pt_pos, torch.where(sel_ok, sel, torch.full_like(sel, P)),
                                 res.points),
        kf_obs=mapstate.put2_drop(m.kf_obs,
                                  torch.where(outlier, kfc, torch.full_like(kfc, K)).reshape(-1),
                                  torch.where(outlier, ftc, torch.zeros_like(ftc)).reshape(-1),
                                  torch.full((), INVALID, dtype=torch.int32, device=dev)))
    aff = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                            torch.where(outlier.any(dim=1), sel, torch.full_like(sel, P)), yes)
    return mapstate.table_revalidate_points(m, aff), outlier.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Keyframe culling (LocalMapping::KeyFrameCulling, src/LocalMapping.cc:868-963)
# ---------------------------------------------------------------------------

def cull_keyframes(cfg: SlamConfig, m: mapstate.MapState, kf_id, max_obs: int = 12,
                   max_cand: int = 32, obs=None):
    """A covisible keyframe of kf_id is redundant when >= 90 % of its
    points (those with >= 3 observations) are seen by >= 3 other keyframes
    at the same or a finer octave. The first keyframe and the keyframes of
    a loop edge are never culled; the top max_cand covisible keyframes are
    checked. Culled keyframes lose their observations, covisibility and
    validity, and their children move to the grandparent. Returns (map,
    culled (K,) bool). Applying an empty cull changes nothing, so the
    reference's `lax.cond` needs no counterpart."""
    K, P = m.capacity_kf, m.capacity_pt
    dev = m.kf_pose.device
    if obs is None:
        obs = mapstate.point_observations(m, max_obs=max_obs)
    obs_kf, obs_ft, obs_on = (o[:, :max_obs] for o in obs)
    kfc = torch.clamp(obs_kf, 0, K - 1).long()
    ftc = torch.clamp(obs_ft, 0, m.n_feat - 1).long()
    levels = torch.where(obs_on, m.kf_level[kfc, ftc], torch.full_like(obs_kf, 1 << 10))
    cnt = mapstate.obs_table_counts(m, (obs_kf, obs_ft, obs_on))
    n_lv = len(cfg.scale_factors)
    cnt_le = torch.stack([(levels <= lv).sum(dim=1, dtype=torch.int32) for lv in range(n_lv)],
                         dim=1)                                    # (P,L)

    first_fid = torch.where(m.kf_valid, m.kf_frame_id,
                            torch.full_like(m.kf_frame_id, 1 << 30)).min()
    cw = mapstate.take(m.covis, kf_id)
    candidates = (cw > 0) & m.kf_valid & (m.kf_frame_id > first_fid) & \
        ~mapstate.loop_protected_keyframes(m)
    cw, cand_ids = matching.top_k(torch.where(candidates, cw, torch.zeros_like(cw)),
                                  min(max_cand, K))
    rows = m.kf_obs[cand_ids]                                      # (M,N)
    pt = torch.clamp(rows, 0, P - 1).long()
    mine = (rows >= 0) & (cnt[pt] >= 3)
    lv1 = torch.clamp(m.kf_level[cand_ids] + 1, 0, n_lv - 1).long()
    redundant = mine & (cnt_le[pt, lv1] - 1 >= 3)
    red_c = redundant.sum(dim=1, dtype=torch.int32)
    tot_c = mine.sum(dim=1, dtype=torch.int32)
    cull_c = (cw > 0) & (red_c.to(torch.float32) > 0.9 * tot_c.to(torch.float32)) & (tot_c > 0)
    cull = mapstate.put_drop(torch.zeros((K,), dtype=torch.bool, device=dev),
                             torch.where(cull_c, cand_ids, torch.full_like(cand_ids, K)),
                             torch.ones((), dtype=torch.bool, device=dev)) & candidates

    gone = cull[:, None] & (m.kf_obs >= 0)
    dec = mapstate.add_drop(
        torch.zeros((P,), dtype=torch.int32, device=dev),
        torch.where(gone, m.kf_obs, torch.full_like(m.kf_obs, P)).reshape(-1),
        torch.where(gone, torch.where(m.kf_ur >= 0, 2, 1), 0).to(torch.int32).reshape(-1))
    par = torch.clamp(m.parent, 0, K - 1).long()
    m = m._replace(
        kf_obs=torch.where(cull[:, None], torch.full_like(m.kf_obs, INVALID), m.kf_obs),
        covis=torch.where(cull[:, None] | cull[None, :], torch.zeros_like(m.covis), m.covis),
        kf_valid=m.kf_valid & ~cull,
        parent=torch.where(cull[par] & (m.parent >= 0), m.parent[par], m.parent),
        pt_obs_cnt=m.pt_obs_cnt - dec)
    return m, cull


# ---------------------------------------------------------------------------
# The mapping pass and the keyframe event
# ---------------------------------------------------------------------------

def _mapping_pass(cfg: SlamConfig, m: mapstate.MapState, kf_id):
    """mapping_pass, and the event's statistics (5,) int32: points
    triangulated, points replaced by fusion, BA outlier observations
    erased, keyframes culled, fusion targets (one K5 launch each, and one
    more for the targets' union)."""
    dev = m.kf_pose.device
    K, P, N = m.capacity_kf, m.capacity_pt, m.n_feat
    m = cull_map_points(cfg, m, cur_kf=kf_id)

    nn = 20 if cfg.sensor == SENSOR_MONOCULAR else 10
    ids, _ = mapstate.covisible_keyframes(m, kf_id, nn)
    m, n_new = triangulate_batch(cfg, m, kf_id, ids)

    # fusion, both directions, every decide against one snapshot: the
    # current keyframe's points into each target in turn (binds accumulate
    # in the targets' rows), then the union of the targets' points into the
    # current keyframe; the replacements fold into one (P,) mapping that is
    # applied once
    tgt_ids, _ = _fusion_targets(m, kf_id, nn, cap=3 * nn)
    cur_pts = mapstate.take(m.kf_obs, kf_id)
    cnt = m.pt_obs_cnt
    kf_obs = m.kf_obs.clone()        # written in place, row by row, below
    mapping = torch.arange(P, dtype=torch.int32, device=dev)
    for nb in _read(tgt_ids):        # the reference skips padded slots by lax.cond
        if nb < 0:
            continue
        idx, bind, src, tgt, both, src_wins = _fuse_decide(
            cfg, m._replace(kf_obs=kf_obs), cnt, nb, cur_pts, cur_pts >= 0)
        mapping = _fuse_mapping_update(mapping, src, tgt, both, src_wins, P)
        kf_obs[nb] = mapstate.put_drop(kf_obs[nb], torch.where(bind, idx, torch.full_like(idx, N)),
                                       src)
    m = m._replace(kf_obs=kf_obs)

    rows = m.kf_obs[torch.clamp(tgt_ids, 0, K - 1).long()]
    rows = torch.where((tgt_ids >= 0)[:, None], rows, torch.full_like(rows, INVALID)).reshape(-1)
    present = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                                torch.where(rows >= 0, rows, torch.full_like(rows, P)),
                                torch.ones((), dtype=torch.bool, device=dev))
    fuse_pts, fuse_ok = mapstate.compact_mask(present, cfg.max_local_points)
    idx, bind, src, tgt, both, src_wins = _fuse_decide(cfg, m, cnt, kf_id, fuse_pts, fuse_ok)
    mapping = _fuse_mapping_update(mapping, src, tgt, both, src_wins, P)
    m = mapstate.bind_observations(m, kf_id, idx, src, bind)

    # resolve replacement chains (a->b, b->c: a->c), then apply once
    mapping = mapping[mapping.long()]
    mapping = mapping[mapping.long()]
    n_replaced = ((mapping != torch.arange(P, dtype=torch.int32, device=dev)) &
                  m.pt_valid).sum(dtype=torch.int32)
    m = mapstate.replace_points_fast(m, mapping)
    # the fusion binds postdate the table replace_points_fast patched:
    # redirect the touched rows through the final mapping
    touched = torch.cat([torch.clamp(tgt_ids, 0, K - 1).long(), kf_id.view(1).long()])
    rows = m.kf_obs[touched]
    rows = torch.where(rows >= 0, mapping[torch.clamp(rows, 0, P - 1).long()],
                       torch.full_like(rows, INVALID))
    rows = torch.where(m.pt_valid[torch.clamp(rows, 0, P - 1).long()] & (rows >= 0), rows,
                       torch.full_like(rows, INVALID))
    # a repeated index (padded targets clamp to 0) writes the same row
    m = m._replace(kf_obs=m.kf_obs.index_put((touched,), rows))

    # point statistics after fusion, from one shared observation table
    bound = mapstate.take(m.kf_obs, kf_id)
    pmask = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                              torch.where(bound >= 0, bound, torch.full_like(bound, P)),
                              torch.ones((), dtype=torch.bool, device=dev))
    obs = mapstate.point_observations(m, 16)
    m = mapstate.refresh_obs_table(m, obs=obs)
    m = mapstate.update_point_descriptors(m, pmask, obs=obs)
    m = mapstate.update_point_normals(m, pmask, cfg.scale_factors, obs=obs)
    m = mapstate.update_connections(m, kf_id, use_table=True)

    culled = torch.zeros((K,), dtype=torch.bool, device=dev)
    n_outliers = torch.zeros((), dtype=torch.int32, device=dev)
    if _read(m.n_keyframes > 2):
        m, n_outliers = _local_ba(cfg, m, kf_id, cfg.ba_local_cams, cfg.ba_fixed_cams,
                                  cfg.ba_max_points, cfg.ba_max_obs, obs)
        # culling reads the pre-BA table (BA erases a handful of observations)
        m, culled = cull_keyframes(cfg, m, kf_id, obs=obs)
        # a cull orphans every table entry naming the culled keyframe: the
        # full rebuild, selected on the device only when one fired
        fresh = mapstate.refresh_obs_table(m)
        fired = culled.any()
        m = m._replace(**{f: torch.where(fired, getattr(fresh, f), getattr(m, f))
                          for f in ("obs_kf", "obs_ft", "pt_obs_cnt")})
    stats = torch.stack([n_new, n_replaced, n_outliers,
                         culled.sum(dtype=torch.int32), (tgt_ids >= 0).sum(dtype=torch.int32)])
    return m, culled, stats


def mapping_pass(cfg: SlamConfig, m: mapstate.MapState, kf_id):
    """The local-mapping work for one new keyframe kf_id (the reference's
    LocalMapping iteration, `src/LocalMapping.cc:71-159`): recent-point
    culling, triangulation against the top covisible keyframes, two-way
    fusion with the two-level neighbour set, the point statistics, and,
    once the map holds more than two keyframes, local BA and keyframe
    culling. Returns (map, culled (K,) bool)."""
    m, culled, _ = _mapping_pass(cfg, m, kf_id)
    return m, culled


def keyframe_pass(cfg: SlamConfig, m: mapstate.MapState, cur: FrameData, Tcw, matched_pt,
                  frame_id, timestamp):
    """CreateNewKeyFrame and the whole LocalMapping iteration. Returns (map,
    culled (K,) bool, summary (9,) int32): the reference's [kf_id,
    n_keyframes, next_kf, any_culled], then the event's statistics [points
    triangulated, points replaced by fusion, BA outlier observations
    erased, keyframes culled, fusion targets], so one transfer tells the
    host everything."""
    m, kf_id = insert_keyframe(cfg, m, cur, Tcw, matched_pt, frame_id, timestamp,
                               update_stats=False, table_fresh=True)
    m, culled, stats = _mapping_pass(cfg, m, kf_id)
    summary = torch.cat([torch.stack([kf_id.to(torch.int32), m.n_keyframes, m.next_kf,
                                      culled.any().to(torch.int32)]), stats])
    return m, culled, summary
