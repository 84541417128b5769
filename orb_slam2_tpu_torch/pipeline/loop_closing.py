"""Loop detection and correction (port of
`orb_slam2_tpu/pipeline/loop_closing.py`).

`LoopClosing` (`src/LoopClosing.cc`), the reference's third thread, as
functions the system calls after each keyframe insertion:

1. detect_loop:   BoW candidates and the consistency gate over 3
                  consecutive detections (`DetectLoop`, `:137-285`), with
                  ComputeSim3's first gate (>= 20 SearchByBoW matches) in
                  the same dispatch;
2. compute_sim3:  SearchByBoW (K4's node form), Sim3 RANSAC, the guided
                  SearchBySim3 (K4's window form, both directions), the
                  reprojection refinement and the >= 40 projection gate
                  (`ComputeSim3`, `:298-541`);
3. correct_loop:  the Sim3 propagated to the current keyframe's covisible
                  group, its points re-expressed, the loop's points fused
                  into the group (K5), the essential graph, global BA (K9)
                  (`CorrectLoop`, `:551-786`).

Every step runs on the map's device. compute_sim3 reads a few counts back
to the host (the reference's gates), and the essential graph's edge list
is built on the host in NumPy, as the reference builds it. Given a device
mesh (`parallel/distributed.py`), the essential graph and the global BA
are solved sharded over it (`parallel/`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry import se3, sim3
from ..geometry.sim3 import Sim3
from ..mapstate import map as mapstate
from ..ops import matching
from ..parallel import sharded_ba, sharded_pose_graph
from ..solvers import pcg_ba, pose_graph, schur_ba, sim3_solver
from ..utils import spans
from ..utils.config import SlamConfig, SENSOR_MONOCULAR
from . import mapping_ops
from .frame import _camera

INVALID = -1
MAX_LOOP_CANDIDATES = 8      # consistent candidates returned per detection
MAX_CONSISTENT_GROUPS = 16   # capacity of the tracked mvConsistentGroups
DENSE_GBA_BYTES = 200 * 1024 * 1024   # the dense-W global BA's limit; PCG above it


class LoopState:
    """The consistency groups (`mvConsistentGroups`) as device tensors:
    groups (G,K) bool membership and cons (G,) int32 consecutive-detection
    counts, so a detection costs the host no transfer beyond the candidate
    list that rides in the keyframe event's one read."""

    def __init__(self):
        self.groups = None
        self.cons = None
        self.last_loop_kf_seq = 0

    def ensure(self, K: int, device):
        if self.groups is None:
            self.groups = torch.zeros((MAX_CONSISTENT_GROUPS, K), dtype=torch.bool, device=device)
            self.cons = torch.zeros((MAX_CONSISTENT_GROUPS,), dtype=torch.int32, device=device)

    def reset(self):
        self.groups = None
        self.cons = None
        self.last_loop_kf_seq = 0


def _detect_loop_device(cfg: SlamConfig, m: mapstate.MapState, db, bow_vec, kf_id,
                        prev_groups, prev_cons):
    """The device half of `DetectLoop` (`src/LoopClosing.cc:137-285`): the
    least score among the covisible neighbours, the shared-word and
    accumulated-score candidates, and the consistency check. Returns the
    (MAX_LOOP_CANDIDATES,) int32 candidates (consistent, best accumulated
    score first, -1 padded) and the new group state. No host read:
    ComputeSim3's first gate runs on the host's copy of the candidates
    (`bow_gate`)."""
    from ..bow import database as db_mod

    K = m.capacity_kf
    dev = m.covis.device
    kf = torch.as_tensor(kf_id, device=dev).long().reshape(())
    covis_row = mapstate.take(m.covis, kf)
    neighbors = (covis_row >= cfg.min_covis_weight) & m.kf_valid
    has_neighbors = neighbors.any()
    scores_all, _ = db_mod.query_scores(db, bow_vec)
    min_score = torch.clamp(torch.where(neighbors, scores_all,
                                        torch.full_like(scores_all, float("inf"))).min(),
                            min=1e-6)
    exclude = ((covis_row > 0) | neighbors).index_fill(0, kf.view(1), True)
    cand_mask, acc = db_mod.detect_candidates(db, bow_vec, exclude, min_score, m.covis)
    cand_mask = cand_mask & has_neighbors

    # a candidate's group: itself and its covisible keyframes; consistency:
    # 1 + the most consecutive detections of a previous group it meets
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    gmask = ((m.covis > 0) | eye) & m.kf_valid[None, :]
    overlap = (gmask.to(torch.float32) @ prev_groups.T.to(torch.float32)) > 0     # (K,G)
    cons = torch.where(overlap, prev_cons[None, :] + 1, torch.zeros_like(prev_cons)[None, :])
    cons = cons.max(dim=1).values

    # the new group state: the candidates' groups, best score first (no
    # candidate clears it: mvConsistentGroups = vCurrentConsistentGroups)
    minus = torch.full_like(acc, -1.0)
    top_acc, top_ids = matching.top_k(torch.where(cand_mask, acc, minus), MAX_CONSISTENT_GROUPS)
    alive = top_acc > 0
    new_groups = gmask[top_ids] & alive[:, None]
    new_cons = torch.where(alive, cons[top_ids], torch.zeros_like(cons[top_ids]))

    consistent = cand_mask & (cons >= cfg.covis_consistency_th)
    best_acc, best_ids = matching.top_k(torch.where(consistent, acc, minus), MAX_LOOP_CANDIDATES)
    cands = torch.where(best_acc > 0, best_ids, torch.full_like(best_ids, INVALID)).to(torch.int32)
    return cands, new_groups, new_cons


def detect_loop_dispatch(cfg: SlamConfig, m: mapstate.MapState, db, bow_vec, kf_id,
                         state: LoopState):
    """Queue loop detection and update the consistency state, with no host
    sync; returns the (MAX_LOOP_CANDIDATES,) candidate tensor for the
    caller's one per-keyframe transfer, whose copy goes through
    `bow_gate`."""
    state.ensure(m.capacity_kf, m.covis.device)
    cands, state.groups, state.cons = _detect_loop_device(
        cfg, m, db, bow_vec, kf_id, state.groups, state.cons)
    return cands


def detect_loop(cfg: SlamConfig, m: mapstate.MapState, db, bow_vec, kf_id: int,
                state: LoopState, kf_seq: int):
    """The consistent loop candidates (keyframe ids, best accumulated BoW
    score first; may be empty). At least loop_kf_gap keyframes since the
    last loop (`src/LoopClosing.cc:149-158`; the early return leaves the
    groups untouched)."""
    if kf_seq - state.last_loop_kf_seq < cfg.loop_kf_gap:
        return []
    cands = detect_loop_dispatch(cfg, m, db, bow_vec, kf_id, state).cpu().numpy()
    return bow_gate(cfg, m, kf_id, cands)


def _bow_search(m: mapstate.MapState, kf: int, cand: int):
    """SearchByBoW between keyframes kf and cand with every node 0, so all
    bound feature pairs are candidates (one launch of K4's node form); the
    matched map points of both sides and the pairs whose points are both
    alive. Returns (Matches (N,), pt1 (N,), pt2 (N,), valid (N,))."""
    P, N = m.capacity_pt, m.n_feat
    f_ok1 = m.kf_feat_valid[kf] & (m.kf_obs[kf] >= 0)
    f_ok2 = m.kf_feat_valid[cand] & (m.kf_obs[cand] >= 0)
    node1 = torch.where(f_ok1, 0, INVALID).to(torch.int32)
    node2 = torch.where(f_ok2, 0, INVALID).to(torch.int32)
    mm = matching.search_by_node(node1, m.kf_desc[kf], f_ok1, m.kf_angle[kf],
                                 node2, m.kf_desc[cand], f_ok2, m.kf_angle[cand], nn_ratio=0.75)
    pt1 = m.kf_obs[kf]
    pt2 = m.kf_obs[cand][torch.clamp(mm.idx, 0, N - 1).long()]
    valid = mm.valid & (pt1 >= 0) & (pt2 >= 0) & \
        m.pt_valid[torch.clamp(pt1, 0, P - 1).long()] & m.pt_valid[torch.clamp(pt2, 0, P - 1).long()]
    return mm, pt1, pt2, valid


def bow_match_counts(cfg: SlamConfig, m: mapstate.MapState, kf_id: int, cand_ids):
    """The SearchByBoW matches of keyframe kf_id with each candidate whose
    points are both alive, one K4 node-form launch per live candidate.
    cand_ids: host ints, -1 padded; returns (B,) int32 counts, 0 for
    padding."""
    zero = torch.zeros((), dtype=torch.int32, device=m.covis.device)
    return torch.stack([_bow_search(m, kf_id, int(c))[3].sum(dtype=torch.int32) if c >= 0
                        else zero for c in cand_ids])


def bow_gate(cfg: SlamConfig, m: mapstate.MapState, kf_id: int, cands) -> list:
    """ComputeSim3's first gate (`src/LoopClosing.cc:336-356`): the live
    candidates of the host array `cands` with at least 20 SearchByBoW
    matches, in order. It searches and reads back only when a candidate is
    live (the reference's `lax.cond`), so a keyframe without one pays
    nothing."""
    live = [int(c) for c in cands if c >= 0]
    if not live:
        return []
    counts = bow_match_counts(cfg, m, kf_id, live).cpu().numpy()
    return [c for c, n in zip(live, counts) if n >= 20]


def _cam_points(m, kf, pt):
    """Map points pt (clamped) in keyframe kf's camera frame."""
    return se3.apply(m.kf_pose[kf], m.pt_pos[torch.clamp(pt, 0, m.capacity_pt - 1).long()])


def compute_sim3(cfg: SlamConfig, m: mapstate.MapState, kf_id: int, cand_id: int):
    """Match the map points of keyframes kf_id and cand_id and solve their
    Sim3 (`ComputeSim3`). Returns (ok, Scm, n_inliers), Scm mapping
    candidate-camera points into the current camera (None when not ok).
    Reads its gates' counts back to the host."""
    N, P = m.n_feat, m.capacity_pt
    fix_scale = cfg.sensor != SENSOR_MONOCULAR
    geom = (cfg.level_sigma2, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    mm, pt1, pt2, valid = _bow_search(m, kf_id, cand_id)
    if int(mm.valid.sum()) < 20:
        return False, None, None
    pc1, pc2 = _cam_points(m, kf_id, pt1), _cam_points(m, cand_id, pt2)
    idxm = torch.clamp(mm.idx, 0, N - 1).long()
    res = sim3_solver.ransac_sim3(
        pc1, pc2, m.kf_level[kf_id], m.kf_level[cand_id][idxm], valid, *geom,
        fix_scale=fix_scale, ur1=m.kf_ur[kf_id], ur2=m.kf_ur[cand_id][idxm], bf=float(cfg.bf),
        generator=torch.Generator().manual_seed(kf_id * 977 + cand_id))
    if not bool(res.ok):
        return False, None, None

    # the guided mutual re-search with the RANSAC estimate (SearchBySim3,
    # `src/LoopClosing.cc:430-440`) grows the match set
    obs1, obs2 = m.kf_obs[kf_id], m.kf_obs[cand_id]
    f_ok1 = m.kf_feat_valid[kf_id] & (obs1 >= 0)
    f_ok2 = m.kf_feat_valid[cand_id] & (obs2 >= 0)
    pcv1, pcv2 = _cam_points(m, kf_id, obs1), _cam_points(m, cand_id, obs2)
    ok1 = f_ok1 & m.pt_valid[torch.clamp(obs1, 0, P - 1).long()]
    ok2 = f_ok2 & m.pt_valid[torch.clamp(obs2, 0, P - 1).long()]
    mm2 = matching.search_by_sim3(
        pcv1, m.kf_xy[kf_id], m.kf_level[kf_id], m.kf_desc[kf_id], ok1,
        pcv2, m.kf_xy[cand_id], m.kf_level[cand_id], m.kf_desc[cand_id], ok2,
        res.g12, cfg.scale_factors, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    # the union: the BoW matches, the gaps filled by the guided ones
    idx = torch.where(mm.valid & valid, mm.idx, mm2.idx)
    pair_ok = (mm.valid & valid) | mm2.valid

    # the reprojection refinement (OptimizeSim3, `src/LoopClosing.cc:442-448`,
    # th2 = 10): the keypoints are exact where the duplicated points drifted
    idxc = torch.clamp(idx, 0, N - 1).long()
    pair_on = pair_ok & ok1 & ok2[idxc]
    g_opt, inl, n_inl = sim3_solver.optimize_sim3(
        res.g12, pcv1, pcv2[idxc], m.kf_xy[kf_id], m.kf_xy[cand_id][idxc], m.kf_level[kf_id],
        m.kf_level[cand_id][idxc], pair_on, *geom, fix_scale=fix_scale, ur1=m.kf_ur[kf_id],
        ur2=m.kf_ur[cand_id][idxc], bf=float(cfg.bf))
    n_inl = int(n_inl)
    if n_inl < 20:
        return False, None, None

    # the acceptance gate (`src/LoopClosing.cc:484-540`): the candidate
    # group's points projected into the current keyframe with the corrected
    # Scw; at least 40 matches, the Sim3 ones and the new distinct points
    # (`:511-528`: vpMatched entries are skipped and counted apart). It
    # rejects weak estimates (matches in a thin overlap strip, where the
    # planar two-fold ambiguity leaves Scw meters off) until a later
    # keyframe overlaps more.
    sim3_matched = pair_on & inl
    matched_pt2 = torch.where(sim3_matched, obs2[idxc], torch.full_like(idx, INVALID))
    Scw = sim3.compose(g_opt, Sim3.from_se3(m.kf_pose[cand_id]))
    n_new, _, _, _ = _count_loop_projection_matches(cfg, m, kf_id, cand_id, Scw,
                                                    already_matched=sim3_matched,
                                                    exclude_pts=matched_pt2)
    if int(sim3_matched.sum()) + n_new < 40:
        return False, None, None

    # Monocular: re-estimate the scale, weakly observable from two
    # keyframes' overlap on shallow scenes (pixels cannot fix it: (a s, a t)
    # projects alike), from 3D-3D pairs of wide geometry: the group
    # projection's matches whose current feature has its own binding. A
    # weighted Horn over the union of pairs gives the Sim3, a two-view
    # refinement at fixed scale polishes it on the exact keypoints.
    if cfg.sensor == SENSOR_MONOCULAR:
        _, w_ids, w_valid, w_feat = _count_loop_projection_matches(cfg, m, kf_id, cand_id, Scw)
        own = obs1[torch.clamp(w_feat, 0, N - 1).long()]
        ownc = torch.clamp(own, 0, P - 1).long()
        vb = w_valid & (own >= 0) & m.pt_valid[ownc] & m.pt_valid[w_ids.long()]
        pc1b = se3.apply(m.kf_pose[kf_id], m.pt_pos[ownc])
        pc2b = se3.apply(m.kf_pose[cand_id], m.pt_pos[w_ids.long()])
        if int(vb.sum()) >= 10:
            wu = torch.cat([sim3_matched.to(torch.float32), vb.to(torch.float32)])
            g_u = sim3_solver.horn_sim3(torch.cat([pcv2[idxc], pc2b]), torch.cat([pcv1, pc1b]),
                                        fix_scale=False, w=wu)
            g_fin, _, n_fin = sim3_solver.optimize_sim3(
                g_u, pcv1, pcv2[idxc], m.kf_xy[kf_id], m.kf_xy[cand_id][idxc],
                m.kf_level[kf_id], m.kf_level[cand_id][idxc], pair_on, *geom, fix_scale=True)
            if int(n_fin) >= 20:
                g_opt = g_fin
    return True, g_opt, n_inl


def _count_loop_projection_matches(cfg: SlamConfig, m: mapstate.MapState, kf_id: int,
                                   cand_id: int, Scw: Sim3, already_matched=None,
                                   exclude_pts=None):
    """`SearchByProjection(KeyFrame*, Scw, vpPoints, ...)`'s match count
    (`src/ORBmatcher.cc:760-914`, used at `src/LoopClosing.cc:511-519`): the
    candidate's covisible group's points (at most capacity_pt // 4)
    projected with Scw, a window of 10 * scale(predicted octave) and
    TH_LOW, through K4's window form. already_matched (N,): current
    features bound by SearchBySim3 (skipped, the reference's vpMatched);
    exclude_pts: point ids matched already. Returns (count, the loop
    points' ids, each one's match validity, its matched feature)."""
    P = m.capacity_pt
    dev = m.covis.device
    yes = torch.ones((), dtype=torch.bool, device=dev)
    group = ((m.covis[cand_id] > 0) & m.kf_valid).index_fill(
        0, torch.tensor([cand_id], device=dev), True)
    rows = torch.where(group[:, None] & (m.kf_obs >= 0), m.kf_obs, torch.full_like(m.kf_obs, P))
    loop_pts = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                                 rows.reshape(-1), yes) & m.pt_valid
    if exclude_pts is not None:
        loop_pts = mapstate.put_drop(
            loop_pts, torch.where(exclude_pts >= 0, exclude_pts, torch.full_like(exclude_pts, P)),
            torch.zeros((), dtype=torch.bool, device=dev))
    n_loop_pts = int(loop_pts.sum())
    if n_loop_pts > P // 4:
        # the gather below truncates the projected set and the >= 40 gate
        # then undercounts: visible, so dense maps can raise capacity_pt
        print(f"[loop_closing] projection gather truncated: {n_loop_pts} "
              f"loop points > capacity {P // 4}")
    ids, ids_ok = mapstate.compact_mask(loop_pts, P // 4)
    idc = ids.long()
    pos = m.pt_pos[idc]
    s_safe = torch.clamp(Scw.s, min=1e-12)
    pc = sim3.apply(Scw, pos) / s_safe                      # the SE3 part of Scw
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    uv = torch.stack([cfg.fx * pc[..., 0] / zc + cfg.cx, cfg.fy * pc[..., 1] / zc + cfg.cy], -1)
    ok = ids_ok & (z > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < cfg.width) & \
        (uv[..., 1] >= 0) & (uv[..., 1] < cfg.height)
    # the predicted octave from the scale-invariance band
    Ow = -(Scw.R.T @ Scw.t) / s_safe
    d = pos - Ow
    dist = torch.sqrt((d * d).sum(dim=-1))
    ok = ok & (dist >= 0.8 * m.pt_min_dist[idc]) & (dist <= 1.2 * m.pt_max_dist[idc])
    ratio = m.pt_max_dist[idc] / torch.clamp(dist, min=1e-9)
    pred = torch.clamp(torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) /
                                  math.log(cfg.scale_factor)).to(torch.int32),
                       0, cfg.n_levels - 1)
    f_ok = m.kf_feat_valid[kf_id]
    taken = torch.zeros_like(f_ok) if already_matched is None else already_matched
    mm = matching.search_by_projection_reloc(
        uv, pred, m.pt_desc[idc], ok, torch.zeros_like(dist), m.kf_xy[kf_id], m.kf_level[kf_id],
        m.kf_desc[kf_id], f_ok, m.kf_angle[kf_id], taken, cfg.scale_factors, th=10.0,
        orb_dist=cfg.th_low, check_rotation=False)
    return int(mm.valid.sum()), ids, mm.valid, mm.idx


def _propagate_and_fuse(cfg: SlamConfig, m: mapstate.MapState, kf_id: int, cand_id: int,
                        Scm: Sim3):
    """The Sim3 propagated to the current keyframe's covisible group and
    the group's points re-expressed (CorrectLoop's map-update block,
    `src/LoopClosing.cc:586-660`). Returns (map, group (K,) bool)."""
    K, P = m.capacity_kf, m.capacity_pt
    dev = m.covis.device
    Scw = sim3.compose(Scm, Sim3.from_se3(m.kf_pose[cand_id]))    # kf_id's corrected Siw
    group = ((m.covis[kf_id] > 0) & m.kf_valid).index_fill(
        0, torch.tensor([kf_id], device=dev), True)
    Tiw = m.kf_pose
    Tic = Tiw @ se3.inverse(m.kf_pose[kf_id])
    S_corr = sim3.compose(Sim3.from_se3(Tic), Sim3(Scw.R[None], Scw.t[None], Scw.s[None]))
    S_old = Sim3.from_se3(Tiw)
    rows = torch.where(group[:, None] & (m.kf_obs >= 0), m.kf_obs, torch.full_like(m.kf_obs, P))
    seen = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=dev), rows.reshape(-1),
                             torch.ones((), dtype=torch.bool, device=dev)) & m.pt_valid
    # each point through its reference keyframe where that is in the
    # group, else through kf_id
    ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
    corr_kf = torch.where(group[ref], ref, torch.full_like(ref, kf_id))
    p_cam = sim3.apply(S_old.take(corr_kf), m.pt_pos)
    p_new = sim3.apply(sim3.inverse(S_corr.take(corr_kf)), p_cam)
    m = m._replace(pt_pos=torch.where(seen[:, None], p_new, m.pt_pos),
                   kf_pose=torch.where(group[:, None, None], S_corr.to_se3(), m.kf_pose))
    return m, group


def correct_loop(cfg: SlamConfig, m: mapstate.MapState, kf_id: int, cand_id: int, Scm: Sim3,
                 mesh=None, run_gba: bool = True):
    """The whole loop correction; returns the map. run_gba=False leaves the
    global BA to the caller (the system spreads it over later keyframes
    when cfg.gba_async_chunks > 0). mesh: solve the essential graph and the
    global BA sharded over it."""
    pose_before = m.kf_pose            # the essential graph's old measurements
    m, group = _propagate_and_fuse(cfg, m, kf_id, cand_id, Scm)
    m = fuse_loop_points(cfg, m, cand_id, group)
    # persist the loop edge (KeyFrame::AddLoopEdge, src/KeyFrame.cc:591-599:
    # every later essential graph carries it and both ends are never
    # culled), then the essential graph over all keyframes
    m = mapstate.add_loop_edge(m, kf_id, cand_id)
    m = _essential_graph(cfg, m, pose_before, kf_id, cand_id, group, mesh=mesh)
    if run_gba:
        m = run_global_ba(cfg, m, mesh=mesh, n_iters=cfg.gba_total_iters)
    return m


def fuse_loop_points(cfg: SlamConfig, m: mapstate.MapState, cand_id: int, group):
    """SearchAndFuse (th 4): the points of the candidate and its 9 best
    covisible keyframes (at most capacity_pt // 4) into each keyframe of
    the current group in turn (each fusion changes the bindings the next
    one sees), one K5 search per keyframe; then the observation table."""
    P = m.capacity_pt
    dev = m.covis.device
    w = torch.where(m.kf_valid, m.covis[cand_id], torch.zeros_like(m.covis[cand_id]))
    _, cg_ids = matching.top_k(w.index_fill(0, torch.tensor([cand_id], device=dev), 1 << 20), 10)
    rows = m.kf_obs[cg_ids]
    present = mapstate.put_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                                torch.where(rows >= 0, rows, torch.full_like(rows, P)).reshape(-1),
                                torch.ones((), dtype=torch.bool, device=dev)) & m.pt_valid
    ids, ok = mapstate.compact_mask(present, P // 4)
    for k in np.nonzero(group.cpu().numpy())[0]:
        m = mapping_ops.fuse_into_keyframe(cfg, m, torch.tensor(int(k), device=dev), ids, ok)
    return mapstate.refresh_obs_table(m)


def build_essential_edges(cfg: SlamConfig, m: mapstate.MapState, kf_id: int, cand_id: int):
    """The deduplicated essential-graph edges (`OptimizeEssentialGraph`,
    src/Optimizer.cc:1069-1283), on the host: the spanning tree, the
    covisibility edges of weight >= essential_graph_min_feat, the new loop
    edge and every persisted loop edge (src/Optimizer.cc:1248-1283: a second
    closure must not tear the first open). A list of (i, j)."""
    K = m.capacity_kf
    valid = m.kf_valid.cpu().numpy()
    covis = m.covis.cpu().numpy()
    parent = m.parent.cpu().numpy()
    edges = []
    ks = np.nonzero(valid & (parent >= 0) & valid[np.clip(parent, 0, K - 1)])[0]
    edges += [(int(k), int(parent[k])) for k in ks]
    hi = np.argwhere(np.triu(covis >= cfg.essential_graph_min_feat, 1) &
                     valid[:, None] & valid[None, :])
    edges += [(int(i), int(j)) for i, j in hi]
    edges.append((kf_id, cand_id))
    for i, j in m.loop_edges.cpu().numpy():
        if i >= 0 and j >= 0 and valid[i] and valid[j]:
            edges.append((int(i), int(j)))
    seen, uniq = set(), []
    for e in edges:
        key = (min(e), max(e))
        if key not in seen:
            seen.add(key)
            uniq.append(e)
    return uniq


def essential_problem(cfg: SlamConfig, m: mapstate.MapState, pose_before, kf_id: int,
                      cand_id: int, group, mesh=None) -> pose_graph.PoseGraphProblem:
    """The essential graph as a pose-graph problem (edges padded to a power
    of two, at least 16, then to a multiple of the mesh's size). Each edge's measurement Sji is computed from the
    poses after the correction where the edge is the loop edge or joins two
    keyframes of the corrected group (the reference's vScw,
    src/Optimizer.cc:1139-1160: it carries the closing information), and
    from the poses before it elsewhere (NonCorrectedSim3), so the graph
    spreads the drift."""
    K = m.capacity_kf
    dev = m.covis.device
    uniq = build_essential_edges(cfg, m, kf_id, cand_id)
    E = max(16, 1 << int(np.ceil(np.log2(len(uniq) + 1))))
    if mesh is not None:
        E = -(-E // mesh.size()) * mesh.size()
    group_np = group.cpu().numpy()
    pose_b, pose_a = pose_before.cpu().numpy(), m.kf_pose.cpu().numpy()
    ei, ej = np.zeros(E, np.int32), np.zeros(E, np.int32)
    ev = np.zeros(E, bool)
    mR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    mt = np.zeros((E, 3), np.float32)
    for n, (i, j) in enumerate(uniq):
        ei[n], ej[n], ev[n] = i, j, True
        after = {i, j} == {kf_id, cand_id} or (group_np[i] and group_np[j])
        Pi, Pj = (pose_a[i], pose_a[j]) if after else (pose_b[i], pose_b[j])
        rel = Pj @ np.linalg.inv(Pi)
        mR[n], mt[n] = rel[:3, :3], rel[:3, 3]
    node_fixed = torch.zeros((K,), dtype=torch.bool, device=dev).index_fill(
        0, torch.tensor([cand_id], device=dev), True)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return pose_graph.PoseGraphProblem(
        nodes=Sim3.from_se3(m.kf_pose), node_valid=m.kf_valid, node_fixed=node_fixed,
        edge_i=t(ei), edge_j=t(ej),
        edge_meas=Sim3(t(mR), t(mt), torch.ones((E,), dtype=torch.float32, device=dev)),
        edge_valid=t(ev))


def _essential_graph(cfg: SlamConfig, m: mapstate.MapState, pose_before, kf_id: int,
                     cand_id: int, group, mesh=None):
    """Build and solve the Sim3 pose graph (`OptimizeEssentialGraph`,
    `src/Optimizer.cc:1069-1404`), its edges sharded over `mesh` if one is
    given, then write the poses back (t / s) and re-express each point
    through its reference keyframe."""
    K = m.capacity_kf
    prob = essential_problem(cfg, m, pose_before, kf_id, cand_id, group, mesh=mesh)
    fix_scale = cfg.sensor != SENSOR_MONOCULAR
    if mesh is not None:
        out = sharded_pose_graph.optimize_pose_graph_sharded(prob, mesh, n_iters=20,
                                                             fix_scale=fix_scale)
    else:
        out = pose_graph.optimize_pose_graph(prob, n_iters=20, fix_scale=fix_scale)
    ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
    p_cam = sim3.apply(Sim3.from_se3(m.kf_pose).take(ref), m.pt_pos)
    p_new = sim3.apply(sim3.inverse(out.take(ref)), p_cam)
    return m._replace(kf_pose=torch.where(m.kf_valid[:, None, None], out.to_se3(), m.kf_pose),
                      pt_pos=torch.where(m.pt_valid[:, None], p_new, m.pt_pos))


def global_ba_problem(cfg: SlamConfig, m: mapstate.MapState) -> schur_ba.BAProblem:
    """Every keyframe and every point, the first keyframe held fixed, each
    point's first ba_max_obs observations: C = capacity_kf cameras,
    Q x O = capacity_pt x ba_max_obs edges."""
    with spans.span("loop_closing.ba_problem"):
        K = m.capacity_kf
        obs_kf, obs_ft, obs_on = mapstate.point_observations(m, max_obs=cfg.ba_max_obs)
        kfc = torch.clamp(obs_kf, 0, K - 1).long()
        ftc = torch.clamp(obs_ft, 0, m.n_feat - 1).long()
        first = torch.argmin(torch.where(m.kf_valid, m.kf_frame_id,
                                         torch.full_like(m.kf_frame_id, 1 << 30)))
        cam_fixed = torch.zeros((K,), dtype=torch.bool, device=m.covis.device).index_fill(
            0, first.view(1), True)
        return schur_ba.BAProblem(
            poses=m.kf_pose, cam_valid=m.kf_valid, cam_fixed=cam_fixed, points=m.pt_pos,
            pt_valid=m.pt_valid,
            obs_cam=torch.where(obs_on, obs_kf, torch.full_like(obs_kf, INVALID)),
            obs_uvr=torch.cat([m.kf_xy[kfc, ftc], m.kf_ur[kfc, ftc][..., None]], dim=-1),
            obs_level=m.kf_level[kfc, ftc])


def run_global_ba(cfg: SlamConfig, m: mapstate.MapState, mesh=None, n_iters: int = 10):
    """Global bundle adjustment over the whole map
    (`RunGlobalBundleAdjustment`, `src/LoopClosing.cc:873-1017`): the dense
    Schur solver (K9 at C = capacity_kf) while its dense W, Q x C x 18
    floats, fits in DENSE_GBA_BYTES, else PCG on the implicit Schur
    complement; each sharded over the points if a mesh is given. The
    robust kernel is off."""
    with spans.span("loop_closing.global_ba"):
        prob = global_ba_problem(cfg, m)
        cam = _camera(cfg, m.covis.device)
        dense = prob.points.shape[0] * m.capacity_kf * 18 * 4 <= DENSE_GBA_BYTES
        if mesh is not None and dense:
            res = sharded_ba.solve_global_ba_sharded(cam, prob, cfg.level_sigma2, mesh,
                                                     n_iters=n_iters, robust=False)
        elif mesh is not None:
            res = pcg_ba.solve_ba_pcg_sharded(cam, prob, cfg.level_sigma2, mesh, n_iters=n_iters)
        elif not dense:
            res = pcg_ba.solve_ba_pcg(cam, prob, cfg.level_sigma2, n_iters=n_iters)
        else:
            res = schur_ba.solve_ba(cam, prob, cfg.level_sigma2, iters_a=n_iters, iters_b=0,
                                    robust=False)
        return m._replace(
            kf_pose=torch.where((prob.cam_valid & ~prob.cam_fixed)[:, None, None], res.poses,
                                m.kf_pose),
            pt_pos=torch.where(m.pt_valid[:, None], res.points, m.pt_pos))
