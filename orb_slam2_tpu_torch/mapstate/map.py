"""The map as a fixed-capacity structure of arrays (port of
`orb_slam2_tpu/mapstate/map.py`, the part tracking and keyframe insertion
need).

The reference's pointer graph of Map, KeyFrame and MapPoint with its
mutexes (`include/Map.h`, `include/KeyFrame.h`, `include/MapPoint.h`)
becomes one record of tensors with static capacities (K keyframes, P points,
N features per keyframe) and validity masks:
- `kf_obs[k, i]` is the map point seen by feature i of keyframe k (-1: none);
- `obs_kf`/`obs_ft` cache the point-major view of it, the first OBS_W
  observations of each point in keyframe order;
- `covis` is the dense (K,K) matrix of shared-point counts.

Every function is pure: a MapState in, a new MapState out; no input tensor is
written. Nothing here reads a value back to the host, so a tracking step
that calls these functions queues its work without waiting for the card.
Descriptors are the int32 view of the reference's uint32 words.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..ops.cuda_match import popcount32
from ..ops.matching import top_k
from ..utils.config import device_table, reciprocal_f32

INVALID = -1
OBS_W = 16   # cached observation-table width (first OBS_W by keyframe)


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: torch.Tensor       # (K,4,4) f32 Tcw
    kf_valid: torch.Tensor      # (K,) bool
    kf_frame_id: torch.Tensor   # (K,) i32 source frame index
    kf_timestamp: torch.Tensor  # (K,) f32
    # --- per-keyframe features ---
    kf_xy: torch.Tensor         # (K,N,2) f32 undistorted pixel coords
    kf_level: torch.Tensor      # (K,N) i32
    kf_angle: torch.Tensor      # (K,N) f32 degrees
    kf_desc: torch.Tensor       # (K,N,8) i32 (uint32 bits)
    kf_ur: torch.Tensor         # (K,N) f32 stereo right x (-1 mono)
    kf_depth: torch.Tensor      # (K,N) f32 depth (-1 none)
    kf_feat_valid: torch.Tensor  # (K,N) bool
    kf_obs: torch.Tensor        # (K,N) i32 -> point id or -1
    # --- map points ---
    pt_pos: torch.Tensor        # (P,3) f32 world
    pt_valid: torch.Tensor      # (P,) bool
    pt_desc: torch.Tensor       # (P,8) i32 distinctive descriptor
    pt_normal: torch.Tensor     # (P,3) f32 mean viewing direction
    pt_min_dist: torch.Tensor   # (P,) f32 scale-invariance band
    pt_max_dist: torch.Tensor   # (P,) f32
    pt_ref_kf: torch.Tensor     # (P,) i32
    pt_first_kf: torch.Tensor   # (P,) i32 creation keyframe
    pt_visible: torch.Tensor    # (P,) i32 mnVisible
    pt_found: torch.Tensor      # (P,) i32 mnFound
    pt_obs_cnt: torch.Tensor    # (P,) i32 cached weighted observation count
    pt_forward: torch.Tensor    # (P,) i32 fusion forwarding (identity if live)
    # --- cached point-major observation table ---
    obs_kf: torch.Tensor        # (P,OBS_W) i32 observing keyframes (-1 pad)
    obs_ft: torch.Tensor        # (P,OBS_W) i32 feature index in that keyframe
    # --- graphs ---
    covis: torch.Tensor         # (K,K) i32 shared-point counts
    parent: torch.Tensor        # (K,) i32 spanning-tree parent (-1 root)
    loop_edges: torch.Tensor    # (L,2) i32 loop-closure edges, -1 padded
    # --- counters ---
    next_kf: torch.Tensor       # () i32
    next_pt: torch.Tensor       # () i32

    @property
    def n_keyframes(self):
        return self.kf_valid.sum(dtype=torch.int32)

    @property
    def n_points(self):
        return self.pt_valid.sum(dtype=torch.int32)

    @property
    def capacity_kf(self):
        return self.kf_valid.shape[0]

    @property
    def capacity_pt(self):
        return self.pt_valid.shape[0]

    @property
    def n_feat(self):
        return self.kf_obs.shape[1]


def empty(max_keyframes: int, max_points: int, max_keypoints: int,
          max_loop_edges: int = 32, device="cuda") -> MapState:
    K, P, N = max_keyframes, max_points, max_keypoints
    i32, f32 = torch.int32, torch.float32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return MapState(
        kf_pose=torch.eye(4, dtype=f32, device=device).repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), INVALID, i32),
        kf_timestamp=full((K,), 0.0, f32),
        kf_xy=full((K, N, 2), 0.0, f32),
        kf_level=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_ur=full((K, N), -1.0, f32),
        kf_depth=full((K, N), -1.0, f32),
        kf_feat_valid=full((K, N), False, torch.bool),
        kf_obs=full((K, N), INVALID, i32),
        pt_pos=full((P, 3), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 0.0, f32),
        pt_ref_kf=full((P,), INVALID, i32),
        pt_first_kf=full((P,), INVALID, i32),
        pt_visible=full((P,), 0, i32),
        pt_found=full((P,), 0, i32),
        pt_obs_cnt=full((P,), 0, i32),
        pt_forward=torch.arange(P, dtype=i32, device=device),
        obs_kf=full((P, OBS_W), INVALID, i32),
        obs_ft=full((P, OBS_W), INVALID, i32),
        covis=full((K, K), 0, i32),
        parent=full((K,), INVALID, i32),
        loop_edges=full((max_loop_edges, 2), INVALID, i32),
        next_kf=full((), 0, i32),
        next_pt=full((), 0, i32),
    )


# ---------------------------------------------------------------------------
# Scatters that drop out-of-range indices (`.at[...](mode="drop")`)
# ---------------------------------------------------------------------------

def _padded(arr):
    """arr with one spare row at the end: the target of dropped writes."""
    return torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])


def put_drop(arr, idx, values):
    """arr.at[idx].set(values, mode="drop") for idx in [0, len(arr)]:
    index len(arr) is dropped. Returns a new tensor."""
    return _padded(arr).index_put((idx.long(),), values)[:-1]


def put2_drop(arr, rows, cols, values):
    """arr.at[rows, cols].set(values, mode="drop") for rows in
    [0, len(arr)]: row len(arr) is dropped."""
    return _padded(arr).index_put((rows.long(), cols.long()), values)[:-1]


def last_writers(flat_idx, size: int):
    """(B,) bool: True where entry b is the last entry writing its index
    (indices in [0, size)). `index_put` with repeated indices keeps an
    unspecified one on the card; XLA on the CPU keeps the last, and masking
    every other writer makes that rule explicit."""
    pos = torch.arange(flat_idx.shape[0], device=flat_idx.device)
    last = torch.full((size,), -1, dtype=pos.dtype, device=pos.device)
    last = last.scatter_reduce(0, flat_idx.long(), pos, reduce="amax")
    return last[flat_idx.long()] == pos


def put_last(arr, idx, values):
    """put_drop where idx may repeat with different values: the last
    writer of each index wins."""
    n = arr.shape[0]
    idx = idx.long()
    keep = last_writers(idx, n + 1) | (idx == n)
    return put_drop(arr, torch.where(keep, idx, torch.full_like(idx, n)), values)


def put2_last(arr, rows, cols, values):
    """put2_drop where (rows, cols) may repeat with different values: the
    last writer of each entry wins."""
    n, w = arr.shape[0], arr.shape[1]
    rows, cols = rows.long(), cols.long()
    keep = last_writers(rows * w + cols, (n + 1) * w) | (rows == n)
    return put2_drop(arr, torch.where(keep, rows, torch.full_like(rows, n)), cols, values)


def add_drop(arr, idx, values):
    """arr.at[idx].add(values, mode="drop") for a 1-D arr and idx in
    [0, len(arr)]. A scatter-add: the accumulating index_put sorts its
    indices on the card (~0.4 ms per call at N = 2048 on the H100)."""
    return _padded(arr).scatter_add(0, idx.long(), values.expand(idx.shape))[:-1]


def take(arr, i):
    """arr[i] for a 0-d index tensor i on arr's device (or a Python int).
    Indexing with a 0-d tensor would read it back to the host (a sync);
    index_select does not."""
    if not isinstance(i, torch.Tensor):
        return arr[i]
    return arr.index_select(0, i.reshape(1).long())[0]


def _set_row(arr, i, value):
    """arr.at[i].set(value) for a 0-d index tensor i, with a tensor value
    (index_copy) or a Python scalar (index_fill): no host round trip."""
    if isinstance(value, torch.Tensor) and value.dim() > 0:
        return arr.index_copy(0, i.view(1), value.to(arr.dtype)[None])
    return arr.index_fill(0, i.view(1), value)


# ---------------------------------------------------------------------------
# Keyframe insertion
# ---------------------------------------------------------------------------

def add_keyframe(m: MapState, pose, xy, level, angle, desc, ur, depth,
                 feat_valid, obs, frame_id, timestamp):
    """Insert a keyframe into the first free slot (slot 0 when full: the
    caller guards). obs (N,): point ids already matched by tracking (-1 for
    none). Returns (map, kf_id) with kf_id a 0-d int64 tensor."""
    slot = torch.argmin(m.kf_valid.to(torch.int32))   # first False
    m = m._replace(
        kf_pose=_set_row(m.kf_pose, slot, pose),
        kf_valid=_set_row(m.kf_valid, slot, True),
        kf_frame_id=_set_row(m.kf_frame_id, slot, frame_id),
        kf_timestamp=_set_row(m.kf_timestamp, slot, timestamp),
        kf_xy=_set_row(m.kf_xy, slot, xy),
        kf_level=_set_row(m.kf_level, slot, level),
        kf_angle=_set_row(m.kf_angle, slot, angle),
        kf_desc=_set_row(m.kf_desc, slot, desc),
        kf_ur=_set_row(m.kf_ur, slot, ur),
        kf_depth=_set_row(m.kf_depth, slot, depth),
        kf_feat_valid=_set_row(m.kf_feat_valid, slot, feat_valid),
        kf_obs=_set_row(m.kf_obs, slot,
                        torch.where(feat_valid, obs, torch.full_like(obs, INVALID))),
        next_kf=m.next_kf + 1,
    )
    return m, slot


def point_indicator(m: MapState, kf_id):
    """(P,) int32 indicator of the points observed by keyframe kf_id."""
    obs = take(m.kf_obs, kf_id)
    ind = torch.zeros((m.capacity_pt,), dtype=torch.int32, device=obs.device)
    return ind.scatter_reduce(0, torch.clamp(obs, 0, m.capacity_pt - 1).long(),
                              (obs >= 0).to(torch.int32), reduce="amax")


def incidence_counts(m: MapState, ind):
    """(K,) per-keyframe sums of a point indicator over the observation
    incidence: w[k] = sum_i ind[kf_obs[k, i]], exact (no table truncation).
    One (K,N) gather: the reference's chunk skipping is a host branch
    here, and the gather is small."""
    P = m.capacity_pt
    g = ind[torch.clamp(m.kf_obs, 0, P - 1).long()]
    return torch.where(m.kf_obs >= 0, g, torch.zeros_like(g)).sum(dim=1,
                                                                  dtype=torch.int32)


def shared_observers(m: MapState, point_ids, point_mask):
    """(K,) count of the given map points each keyframe observes."""
    P = m.capacity_pt
    ind = put_drop(torch.zeros((P,), dtype=torch.int32, device=point_ids.device),
                   torch.where(point_mask, point_ids, torch.full_like(point_ids, P)),
                   torch.ones((), dtype=torch.int32, device=point_ids.device))
    return incidence_counts(m, ind)


def update_connections(m: MapState, kf_id, use_table: bool = False):
    """Recompute the covisibility weights of kf_id against every keyframe
    and set its spanning-tree parent once, to the best-sharing earlier
    keyframe (`KeyFrame::UpdateConnections`, `src/KeyFrame.cc:411-533`).
    The weights are exact either way: use_table is kept for the reference's
    signature and ignored, as there."""
    del use_table
    w = incidence_counts(m, point_indicator(m, kf_id))
    w = torch.where(m.kf_valid, w, torch.zeros_like(w))
    w = w.index_fill(0, kf_id.view(1), 0)
    covis = m.covis.index_copy(0, kf_id.view(1), w[None])
    covis = covis.index_copy(1, kf_id.view(1), w[:, None])
    earlier = m.kf_frame_id < take(m.kf_frame_id, kf_id)
    w_earlier = torch.where(earlier & m.kf_valid, w, torch.full_like(w, -1))
    best = torch.argmax(w_earlier)            # first maximum
    own = take(m.parent, kf_id)
    new_parent = torch.where(own >= 0, own,
                             torch.where(take(w_earlier, best) > 0, best.to(torch.int32),
                                         torch.full_like(own, INVALID)))
    return m._replace(covis=covis, parent=m.parent.index_copy(0, kf_id.view(1),
                                                               new_parent.view(1)))


def covisible_keyframes(m: MapState, kf_id, k: int, min_weight: int = 1):
    """The top-k covisible keyframes of kf_id, (k,) int32 ids (-1 below
    min_weight) and their (k,) weights; ties to the lower id, as
    `lax.top_k` breaks them."""
    w = take(m.covis, kf_id)
    w = torch.where(m.kf_valid, w, torch.zeros_like(w))
    vals, idx = top_k(w, k)
    return torch.where(vals >= min_weight, idx.to(torch.int32),
                       torch.full_like(vals, INVALID)), vals


def loop_protected_keyframes(m: MapState):
    """(K,) bool: the keyframes of a persisted loop edge (never culled)."""
    K = m.capacity_kf
    le = m.loop_edges
    prot = torch.zeros((K,), dtype=torch.bool, device=le.device)
    yes = torch.ones((), dtype=torch.bool, device=le.device)
    for c in range(2):
        prot = put_drop(prot, torch.where(le[:, c] >= 0, le[:, c], torch.full_like(le[:, c], K)),
                        yes)
    return prot


# ---------------------------------------------------------------------------
# Point insertion
# ---------------------------------------------------------------------------

def compact_mask(mask, size: int):
    """Indices of the first `size` True entries of mask, ascending:
    (idx (size,) int32, 0 past the end; valid (size,) bool). A cumsum and a
    scatter, no sort."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    tgt = torch.where(mask & (rank < size), rank, torch.full_like(rank, size))
    idx = put_drop(torch.zeros((size,), dtype=torch.int32, device=mask.device), tgt,
                   torch.arange(n, dtype=torch.int32, device=mask.device))
    valid = torch.arange(size, device=mask.device) < mask.sum(dtype=torch.int32)
    return idx, valid


def allocate_points(m: MapState, want_mask):
    """Free point slots for each True in want_mask (B,): (B,) slot ids, -1
    where not wanted or the map is full."""
    B = want_mask.shape[0]
    free_slots, free_ok = compact_mask(~m.pt_valid, B)
    n_free = free_ok.sum(dtype=torch.int32)
    order = torch.cumsum(want_mask.to(torch.int32), 0) - 1     # rank among wanted
    slot = free_slots[torch.clamp(order, 0, B - 1).long()]
    return torch.where(want_mask & (order < n_free), slot, torch.full_like(slot, INVALID))


def add_points(m: MapState, slots, pos, desc, ref_kf, first_kf):
    """Write point data into pre-allocated slots (B,); slots < 0 are
    skipped. A reused slot is a fresh point: its forwarding, cached count
    and cached table row are reset."""
    P = m.capacity_pt
    ok = slots >= 0
    si = torch.where(ok, slots, torch.full_like(slots, P))
    B = slots.shape[0]

    def const(value, like):
        return torch.full((B,) + like.shape[1:], value, dtype=like.dtype,
                          device=like.device)

    return m._replace(
        pt_pos=put_drop(m.pt_pos, si, pos),
        pt_desc=put_drop(m.pt_desc, si, desc),
        pt_valid=put_drop(m.pt_valid, si, const(True, m.pt_valid)),
        pt_ref_kf=put_drop(m.pt_ref_kf, si, ref_kf.to(torch.int32).expand(B)),
        pt_first_kf=put_drop(m.pt_first_kf, si, first_kf.to(torch.int32).expand(B)),
        pt_visible=put_drop(m.pt_visible, si, const(1, m.pt_visible)),
        pt_found=put_drop(m.pt_found, si, const(1, m.pt_found)),
        pt_forward=put_drop(m.pt_forward, si, torch.where(ok, slots, torch.zeros_like(slots))),
        pt_obs_cnt=put_drop(m.pt_obs_cnt, si, const(0, m.pt_obs_cnt)),
        obs_kf=put_drop(m.obs_kf, si, const(INVALID, m.obs_kf)),
        obs_ft=put_drop(m.obs_ft, si, const(INVALID, m.obs_ft)),
        next_pt=m.next_pt + ok.sum(dtype=torch.int32),
    )


def bind_observations(m: MapState, kf_id, feat_idx, point_ids, mask):
    """kf_obs[kf_id, feat_idx[b]] = point_ids[b] where mask."""
    fi = torch.where(mask, feat_idx, torch.full_like(feat_idx, m.n_feat))
    row = put_drop(take(m.kf_obs, kf_id), fi, point_ids.to(torch.int32))
    return m._replace(kf_obs=m.kf_obs.index_copy(0, kf_id.view(1), row[None]))


# ---------------------------------------------------------------------------
# Point removal and fusion
# ---------------------------------------------------------------------------

def _invalid_like(t):
    return torch.full_like(t, INVALID)


def erase_points(m: MapState, point_mask):
    """Invalidate the points of point_mask (P,) and clear every observation
    of them (`MapPoint::SetBadFlag`): the full (K,N) incidence sweep."""
    kill = point_mask & m.pt_valid
    P = m.capacity_pt
    obs_clear = kill[torch.clamp(m.kf_obs, 0, P - 1).long()] & (m.kf_obs >= 0)
    return m._replace(pt_valid=m.pt_valid & ~kill,
                      kf_obs=torch.where(obs_clear, _invalid_like(m.kf_obs), m.kf_obs))


def replace_points(m: MapState, mapping):
    """Point fusion (`MapPoint::Replace`) over the full incidence: mapping
    (P,) gives each point itself or its replacement. Observations are
    redirected; where a keyframe then observes a point twice, the lowest
    feature keeps it. Replaced points become invalid; their visible/found
    counts move to the replacement."""
    K, N = m.kf_obs.shape
    P = m.capacity_pt
    dev = m.kf_obs.device
    redirected = torch.where(m.kf_obs >= 0, mapping[torch.clamp(m.kf_obs, 0, P - 1).long()],
                             _invalid_like(m.kf_obs))
    fidx = torch.arange(N, dtype=torch.int32, device=dev).expand(K, N)
    key = torch.where(redirected >= 0, fidx, torch.full_like(fidx, N))
    cell = (torch.arange(K, device=dev)[:, None] * P +
            torch.clamp(redirected, 0, P - 1).long()).reshape(-1)
    first = torch.full((K * P,), N, dtype=torch.int32, device=dev)
    first = first.scatter_reduce(0, cell, key.reshape(-1), reduce="amin")
    dup = (redirected >= 0) & (fidx != first[cell].reshape(K, N))
    replaced = mapping != torch.arange(P, dtype=mapping.dtype, device=dev)
    tgt = torch.clamp(mapping, 0, P - 1).long()

    def moved(count):
        return torch.zeros_like(count).scatter_add(
            0, tgt, torch.where(replaced, count, torch.zeros_like(count)))

    return m._replace(
        kf_obs=torch.where(dup, _invalid_like(redirected), redirected),
        pt_valid=m.pt_valid & ~replaced,
        pt_visible=m.pt_visible + moved(m.pt_visible),
        pt_found=m.pt_found + moved(m.pt_found),
        pt_forward=mapping[torch.clamp(m.pt_forward, 0, P - 1).long()],
    )


def erase_points_fast(m: MapState, point_mask, extra_row=None, max_killed: int = 4096):
    """erase_points through the cached observation table: clear exactly the
    listed (kf, feat) entries of the killed points, plus a direct sweep of
    keyframe extra_row (the just-inserted one, whose bindings postdate the
    table). A killed point whose table row is full may have unlisted
    observations, and more than max_killed kills overflow the compaction:
    then the full sweep runs instead. The reference's `lax.cond` is a
    `torch.where` on the device predicate: both sides are computed (a
    (K,N) select each)."""
    K, P = m.capacity_kf, m.capacity_pt
    kill = point_mask & m.pt_valid
    sel, ok = compact_mask(kill, max_killed)
    rows_kf = m.obs_kf[sel.long()]
    rows_ft = m.obs_ft[sel.long()]
    overflow = (ok & (rows_kf >= 0).all(dim=1)).any() | \
        (kill.sum(dtype=torch.int32) > max_killed)

    kf_obs = m.kf_obs
    slow = torch.where(kill[torch.clamp(kf_obs, 0, P - 1).long()] & (kf_obs >= 0),
                       _invalid_like(kf_obs), kf_obs)
    on = (rows_kf >= 0) & ok[:, None]
    fast = put2_drop(kf_obs, torch.where(on, rows_kf, torch.full_like(rows_kf, K)).reshape(-1),
                     torch.where(on, rows_ft, torch.zeros_like(rows_ft)).reshape(-1),
                     torch.full((), INVALID, dtype=kf_obs.dtype, device=kf_obs.device))
    if extra_row is not None:
        row = take(fast, extra_row)
        row = torch.where((row >= 0) & kill[torch.clamp(row, 0, P - 1).long()],
                          _invalid_like(row), row)
        fast = fast.index_copy(0, extra_row.view(1), row[None])
    return m._replace(
        kf_obs=torch.where(overflow, slow, fast),
        pt_valid=m.pt_valid & ~kill,
        obs_kf=torch.where(kill[:, None], _invalid_like(m.obs_kf), m.obs_kf),
        obs_ft=torch.where(kill[:, None], _invalid_like(m.obs_ft), m.obs_ft),
    )


def _left_pack(rows_kf, rows_ft):
    """Valid entries (kf >= 0) first, in their order: a stable sort."""
    order = torch.argsort((rows_kf < 0).to(torch.int8), dim=1, stable=True)
    return torch.gather(rows_kf, 1, order), torch.gather(rows_ft, 1, order)


def _obs_weight(m: MapState, kf, ft):
    """+2 for a stereo observation, +1 for a mono one."""
    w = m.kf_ur[torch.clamp(kf, 0, m.capacity_kf - 1).long(),
                torch.clamp(ft, 0, m.n_feat - 1).long()]
    return torch.where(w >= 0, 2, 1).to(torch.int32)


def replace_points_fast(m: MapState, mapping, max_replaced: int = 2048):
    """Point fusion (`MapPoint::Replace`) through the cached observation
    table: rewrite exactly the replaced points' observations and patch the
    table rows. Where a keyframe already observes the replacement, the
    source's entry is erased (the existing binding wins,
    `KeyFrame::ReplaceMapPointMatch`); otherwise it is rewritten to the
    replacement. mapping must be chain-resolved. A replaced point with a
    full table row, or more than max_replaced, takes the full-incidence
    rewrite (computed beside the fast one and selected on the device).
    Where two writes hit one entry (two sources of one target, or a stale
    table), the last wins, as XLA's scatter on the CPU keeps it."""
    K, P, W = m.capacity_kf, m.capacity_pt, OBS_W
    dev = m.kf_obs.device
    replaced = (mapping != torch.arange(P, dtype=mapping.dtype, device=dev)) & m.pt_valid
    sel, ok = compact_mask(replaced, max_replaced)
    src = torch.clamp(sel, 0, P - 1).long()
    tgt = torch.clamp(mapping[src], 0, P - 1).long()
    s_kf, s_ft = m.obs_kf[src], m.obs_ft[src]
    t_kf, t_ft = m.obs_kf[tgt], m.obs_ft[tgt]
    s_on = (s_kf >= 0) & ok[:, None]
    t_on = (t_kf >= 0) & ok[:, None]
    dup = (s_kf[:, :, None] == torch.where(t_on, t_kf, torch.full_like(t_kf, -2))[:, None, :]
           ).any(dim=2) & s_on
    overflow = (ok & (s_kf >= 0).all(dim=1)).any() | \
        (replaced.sum(dtype=torch.int32) > max_replaced)

    kf_obs = m.kf_obs
    # the full-incidence rewrite: a changed entry that collides with the
    # target's existing binding in that keyframe is erased
    redirected = torch.where(kf_obs >= 0, mapping[torch.clamp(kf_obs, 0, P - 1).long()],
                             _invalid_like(kf_obs))
    trow = m.obs_kf[torch.clamp(redirected, 0, P - 1).long()]          # (K,N,W)
    krow = torch.arange(K, dtype=torch.int32, device=dev)[:, None, None]
    already = ((trow == krow) & (trow >= 0)).any(dim=-1)
    slow = torch.where((redirected != kf_obs) & (kf_obs >= 0) & already,
                       _invalid_like(redirected), redirected)
    newval = torch.where(dup, torch.full_like(s_kf, INVALID), tgt[:, None].to(torch.int32))
    fast = put2_last(kf_obs, torch.where(s_on, s_kf, torch.full_like(s_kf, K)).reshape(-1),
                     torch.where(s_on, s_ft, torch.zeros_like(s_ft)).reshape(-1),
                     newval.expand(s_kf.shape).reshape(-1))
    kf_obs = torch.where(overflow, slow, fast)

    # the table: target rows gain the source's entries that are not duplicates
    add = s_on & ~dup
    add_kf = torch.where(add, s_kf, _invalid_like(s_kf))
    add_ft = torch.where(add, s_ft, _invalid_like(s_ft))
    mk, mf = _left_pack(torch.cat([torch.where(t_on, t_kf, _invalid_like(t_kf)), add_kf], 1),
                        torch.cat([torch.where(t_on, t_ft, _invalid_like(t_ft)), add_ft], 1))
    ti = torch.where(ok, tgt, torch.full_like(tgt, P))
    si = torch.where(ok, src, torch.full_like(src, P))
    blank = torch.full((max_replaced, W), INVALID, dtype=torch.int32, device=dev)
    obs_kf = put_drop(put_last(m.obs_kf, ti, mk[:, :W]), si, blank)
    obs_ft = put_drop(put_last(m.obs_ft, ti, mf[:, :W]), si, blank)

    # survivors take the replaced points' visible/found and observation weights
    def added(values):
        return add_drop(torch.zeros((P,), dtype=torch.int32, device=dev), ti,
                        torch.where(ok, values, torch.zeros_like(values)))

    w_add = torch.where(add_kf >= 0, _obs_weight(m, add_kf, add_ft),
                        torch.zeros_like(add_kf)).sum(dim=1, dtype=torch.int32)
    return m._replace(
        kf_obs=kf_obs, obs_kf=obs_kf, obs_ft=obs_ft,
        pt_valid=m.pt_valid & ~replaced,
        pt_visible=m.pt_visible + added(m.pt_visible[src]),
        pt_found=m.pt_found + added(m.pt_found[src]),
        pt_obs_cnt=m.pt_obs_cnt + added(w_add),
        pt_forward=mapping[torch.clamp(m.pt_forward, 0, P - 1).long()],
    )


def table_revalidate_points(m: MapState, pt_mask, max_pts: int = 512) -> MapState:
    """Re-derive the cached table rows of the points in pt_mask (P,) from
    kf_obs: entries whose keyframe no longer binds the point are dropped,
    the row is left-packed again and the cached count loses their weights.
    More than max_pts flagged points take the full rebuild instead (the
    reference's `lax.cond`, here both computed and selected on the
    device)."""
    K, P = m.capacity_kf, m.capacity_pt
    n = pt_mask.sum(dtype=torch.int32)
    sel, ok = compact_mask(pt_mask, max_pts)
    p = torch.clamp(sel, 0, P - 1).long()
    rows_kf, rows_ft = m.obs_kf[p], m.obs_ft[p]
    on = rows_kf >= 0
    back = m.kf_obs[torch.clamp(rows_kf, 0, K - 1).long(),
                    torch.clamp(rows_ft, 0, m.n_feat - 1).long()]
    keep = on & (back == p[:, None])
    dec = torch.where(on & ~keep, _obs_weight(m, rows_kf, rows_ft),
                      torch.zeros_like(rows_kf)).sum(dim=1, dtype=torch.int32)
    rows_kf, rows_ft = _left_pack(torch.where(keep, rows_kf, _invalid_like(rows_kf)),
                                  torch.where(keep, rows_ft, _invalid_like(rows_ft)))
    pi = torch.where(ok, p, torch.full_like(p, P))
    fast = m._replace(obs_kf=put_drop(m.obs_kf, pi, rows_kf),
                      obs_ft=put_drop(m.obs_ft, pi, rows_ft),
                      pt_obs_cnt=put_drop(m.pt_obs_cnt, pi,
                                          torch.clamp(m.pt_obs_cnt[p] - dec, min=0)))
    slow = refresh_obs_table(m)
    big = n > max_pts
    return m._replace(obs_kf=torch.where(big, slow.obs_kf, fast.obs_kf),
                      obs_ft=torch.where(big, slow.obs_ft, fast.obs_ft),
                      pt_obs_cnt=torch.where(big, slow.pt_obs_cnt, fast.pt_obs_cnt))


# ---------------------------------------------------------------------------
# The cached point-major observation table
# ---------------------------------------------------------------------------

def table_append_keyframe(m: MapState, kf_id) -> MapState:
    """Add keyframe kf_id's bindings to the cached table: each bound point
    gains (kf_id, feature) at the first free slot of its left-packed row;
    full rows drop it. The caller guarantees the bindings are not in the
    table yet."""
    P = m.capacity_pt
    row = take(m.kf_obs, kf_id)
    on = row >= 0
    pt = torch.clamp(row, 0, P - 1).long()
    pos = (m.obs_kf[pt] >= 0).sum(dim=1)
    keep = on & (pos < OBS_W)
    ridx = torch.where(keep, pt, torch.full_like(pt, P))
    cidx = torch.where(keep, pos, torch.zeros_like(pos))
    n = row.shape[0]
    return m._replace(
        obs_kf=put2_drop(m.obs_kf, ridx, cidx, kf_id.to(torch.int32).expand(n)),
        obs_ft=put2_drop(m.obs_ft, ridx, cidx,
                         torch.arange(n, dtype=torch.int32, device=row.device)))


def point_observations(m: MapState, max_obs: int = 16):
    """Point-major observation lists from kf_obs: (obs_kf, obs_ft,
    obs_valid), each (P, max_obs); a point with more than max_obs
    observations keeps its first max_obs in keyframe order. A keyframe that
    binds a point at two features (a transient fusion duplicate) lists it
    once, at its last feature, as the reference's placement does. A stable
    sort of the (K*N) incidence by (point, keyframe) groups each point's
    observations in keyframe order; the last entry of each (point,
    keyframe) group stays, and its rank among the point's kept entries is
    its column."""
    K, N = m.kf_obs.shape
    P = m.capacity_pt
    dev = m.kf_obs.device
    flat = m.kf_obs.reshape(-1).long()
    pos = torch.arange(K * N, device=dev)
    key = torch.where(flat >= 0, flat * K + pos // N, torch.full_like(flat, P * K))
    key_sorted, order = torch.sort(key, stable=True)
    last = torch.cat([key_sorted[1:] != key_sorted[:-1],
                      torch.ones((1,), dtype=torch.bool, device=dev)])
    on = (key_sorted < P * K) & last
    pt = torch.where(on, key_sorted // K, torch.full_like(key_sorted, P))
    seen = torch.cumsum(on.to(torch.int64), 0) - 1          # index among the kept
    first = torch.full((P + 1,), K * N, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, pt, torch.where(on, seen, torch.full_like(seen, K * N)),
                                 reduce="amin")
    rank = seen - first[pt]
    keep = on & (rank < max_obs)
    rows = torch.where(keep, pt, torch.full_like(pt, P))
    cols = torch.where(keep, rank, torch.zeros_like(rank))
    blank = torch.full((P, max_obs), INVALID, dtype=torch.int32, device=dev)
    obs_kf = put2_drop(blank, rows, cols, (order // N).to(torch.int32))
    obs_ft = put2_drop(blank, rows, cols, (order % N).to(torch.int32))
    return obs_kf, obs_ft, obs_kf >= 0


def obs_table_counts(m: MapState, obs) -> torch.Tensor:
    """Weighted observation counts (+1 mono, +2 stereo, like nObs) from an
    observation table; they saturate at its width."""
    obs_kf, obs_ft, obs_on = obs
    kfc = torch.clamp(obs_kf, 0, m.capacity_kf - 1).long()
    ftc = torch.clamp(obs_ft, 0, m.n_feat - 1).long()
    w = torch.where(m.kf_ur[kfc, ftc] >= 0, 2, 1)
    return torch.where(obs_on, w, torch.zeros_like(w)).sum(dim=-1, dtype=torch.int32)


def refresh_obs_table(m: MapState, obs=None) -> MapState:
    """Rebuild the cached observation table and the weighted counts from
    kf_obs (or from a given point_observations table)."""
    if obs is None:
        obs = point_observations(m, OBS_W)
    obs_kf, obs_ft = obs[0][:, :OBS_W], obs[1][:, :OBS_W]
    m = m._replace(obs_kf=obs_kf, obs_ft=obs_ft)
    return m._replace(pt_obs_cnt=obs_table_counts(m, (obs_kf, obs_ft, obs_kf >= 0)))


# ---------------------------------------------------------------------------
# Point statistics
# ---------------------------------------------------------------------------

def update_point_descriptors(m: MapState, point_mask, max_obs: int = 16, obs=None):
    """Distinctive descriptor = the observation with the least median
    Hamming distance to the others (`MapPoint::ComputeDistinctiveDescriptors`),
    for the points in point_mask."""
    obs_kf, obs_ft, obs_ok = obs if obs is not None else point_observations(m, max_obs)
    kfc = torch.clamp(obs_kf, 0, m.capacity_kf - 1).long()
    ftc = torch.clamp(obs_ft, 0, m.n_feat - 1).long()
    descs = m.kf_desc[kfc, ftc]                                  # (P,O,8)
    dist = popcount32(descs[:, :, None, 0] ^ descs[:, None, :, 0])
    for w in range(1, descs.shape[-1]):
        dist = dist + popcount32(descs[:, :, None, w] ^ descs[:, None, :, w])
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    dist = torch.where(pair_ok, dist, torch.full_like(dist, 512))
    srt = torch.sort(dist, dim=-1).values
    n_obs = obs_ok.to(torch.int32).sum(dim=-1)
    med_idx = torch.clamp((n_obs[:, None] - 1) // 2, 0, max_obs - 1)       # (P,1)
    med = torch.gather(srt, 2, med_idx[:, :, None].expand(-1, srt.shape[1], 1).long())[..., 0]
    med = torch.where(obs_ok, med, torch.full_like(med, 1 << 20))
    best = torch.argmin(med, dim=-1)
    new_desc = descs[torch.arange(m.capacity_pt, device=best.device), best]
    use = point_mask & m.pt_valid & (n_obs > 0)
    return m._replace(pt_desc=torch.where(use[:, None], new_desc, m.pt_desc))


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def update_point_normals(m: MapState, point_mask, scale_factors, max_obs: int = 16,
                         obs=None):
    """Mean viewing direction and scale-invariance distance band
    (`MapPoint::UpdateNormalAndDepth`). scale_factors: the per-octave scale
    factors (floats)."""
    obs_kf, obs_ft, obs_ok = obs if obs is not None else point_observations(m, max_obs)
    kfc = torch.clamp(obs_kf, 0, m.capacity_kf - 1).long()
    centers = se3.translation(se3.inverse(m.kf_pose))           # (K,3)
    d = m.pt_pos[:, None, :] - centers[kfc]                      # (P,O,3)
    d = d / torch.clamp(_norm(d), min=1e-9)[..., None]
    n_obs = torch.clamp(obs_ok.to(torch.int32).sum(dim=-1), min=1)
    normal = torch.where(obs_ok[..., None], d, torch.zeros_like(d)).sum(dim=1) / \
        n_obs[:, None]
    n_levels = len(scale_factors)
    sf = device_table(tuple(scale_factors), m.pt_pos.device)
    ref = torch.clamp(m.pt_ref_kf, 0, m.capacity_kf - 1).long()
    dist_ref = _norm(m.pt_pos - centers[ref])
    # the octave of the observing feature in the reference keyframe (the
    # first match), else 0
    is_ref = obs_ok & (obs_kf == m.pt_ref_kf[:, None])
    levels = m.kf_level[kfc, torch.clamp(obs_ft, 0, m.n_feat - 1).long()]
    ref_level = torch.where(is_ref, levels, torch.zeros_like(levels)).max(dim=-1).values
    max_dist = dist_ref * sf[torch.clamp(ref_level, 0, n_levels - 1).long()]
    min_dist = max_dist * reciprocal_f32(scale_factors[-1])
    use = point_mask & m.pt_valid
    return m._replace(
        pt_normal=torch.where(use[:, None], normal, m.pt_normal),
        pt_max_dist=torch.where(use, max_dist, m.pt_max_dist),
        pt_min_dist=torch.where(use, min_dist, m.pt_min_dist),
    )
