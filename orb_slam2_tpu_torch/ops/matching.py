"""Descriptor matching, dense, masked and fixed-shape (port of
`orb_slam2_tpu/ops/matching.py`, the searches tracking runs).

ORBmatcher (`src/ORBmatcher.cc`) prunes its candidates with a feature grid
and BoW buckets; here every search is a candidate gate, Hamming distances
(XOR + popcount over 8 words) and a best / second-best reduction, all three
in one launch of a hand-written kernel of `cuda_match.py` on a CUDA tensor
(its plain twin, which builds the gate as a dense mask, on a CPU tensor).

Descriptors are the int32 view of the reference's uint32 words. Tie rules
follow the reference: the lowest index wins an argmin, the lowest bin index
wins a histogram tie (`lax.top_k`).
Thresholds: TH_HIGH=100, TH_LOW=50, HISTO_LENGTH=30 (`src/ORBmatcher.cc:56-58`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import sim3
from ..utils.config import device_table
from . import cuda_match
# the plain building blocks live beside the kernels' twins that use them
from .cuda_match import BIG, best_two, hamming_matrix, popcount32  # noqa: F401

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30


def resolve_conflicts(best_idx, best_dist, accept, n_targets: int):
    """Keep, for each target, only the accepted source with the least
    distance, ties to the lowest source index (the reference's
    overwrite-previous-match bookkeeping, `src/ORBmatcher.cc:700-720`).
    Sources lie along the last axis; leading axes are independent
    searches."""
    n = best_idx.shape[-1]
    src = torch.arange(n, dtype=torch.int32, device=best_idx.device)
    none = BIG * n + n
    key = torch.where(accept, best_dist * n + src, torch.full_like(best_dist, none))
    target_best = torch.full(best_idx.shape[:-1] + (n_targets,), none, dtype=key.dtype,
                             device=key.device)
    target_best = target_best.scatter_reduce(-1, best_idx.long(), key, reduce="amin")
    return accept & (key == torch.gather(target_best, -1, best_idx.long()))


def top_k(values, k: int):
    """`lax.top_k`: the k largest values and their indices, ties to the
    lower index (a stable descending sort; `torch.topk` has no tie order)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k]


def rotation_consistency(angle_src, angle_dst, matched_mask, best_idx):
    """Keep matches whose angle difference falls in the 3 dominant bins of
    a 30-bin rotation histogram (`ORBmatcher::ComputeThreeMaxima`,
    `src/ORBmatcher.cc:2076-2118`, with the < 0.1x pruning of bins 2, 3).
    Matches lie along the last axis, one histogram per leading index;
    angle_src broadcasts against them."""
    rot = angle_src - torch.gather(angle_dst, -1, best_idx.long())
    rot = torch.where(rot < 0, rot + 360.0, rot)
    factor = 1.0 / (360.0 / HISTO_LENGTH)
    bins = torch.round(rot * factor).to(torch.int64)
    bins = torch.where(bins == HISTO_LENGTH, torch.zeros_like(bins), bins)
    lead = bins.shape[:-1]
    counts = torch.zeros(lead + (HISTO_LENGTH,), dtype=torch.int32, device=rot.device)
    counts = counts.scatter_add(-1, bins, matched_mask.to(torch.int32))
    top_val, top_idx = torch.sort(counts, dim=-1, descending=True, stable=True)  # top_k order
    keep = torch.stack([torch.ones_like(top_val[..., 0], dtype=torch.bool),
                        top_val[..., 1] >= 0.1 * top_val[..., 0],
                        top_val[..., 2] >= 0.1 * top_val[..., 0]], dim=-1)
    keep_bin = torch.zeros(lead + (HISTO_LENGTH,), dtype=torch.bool, device=rot.device)
    keep_bin = keep_bin.scatter(-1, top_idx[..., :3], keep)
    return matched_mask & torch.gather(keep_bin, -1, bins)


class Matches(NamedTuple):
    """For each of N sources: a target index, its distance and a validity
    flag."""
    idx: torch.Tensor    # (N,) int32 into targets
    dist: torch.Tensor   # (N,) int32
    valid: torch.Tensor  # (N,) bool


def _radius(th, scale_factors, level):
    """th * the scale factor of each source's octave (th a float or a
    tensor; scale_factors the per-octave factors as floats)."""
    sf = device_table(tuple(scale_factors), level.device)
    return th * sf[torch.clamp(level, 0, sf.shape[0] - 1).long()]


def search_by_projection_points(
    uv, pred_level, view_cos, point_desc, point_valid, point_ur,
    kp_xy, kp_level, kp_desc, kp_valid, kp_ur,
    scale_factors, th: float, nn_ratio: float = 0.8, already_matched=None,
):
    """Local-map point -> current frame search
    (`ORBmatcher::SearchByProjection(Frame&, vector<MapPoint*>&, th)`,
    `src/ORBmatcher.cc:78-191`). uv (P,2) projected pixels; pred_level (P,)
    predicted octave; view_cos (P,); point_ur (P,) projected right x or -1;
    kp_ur (N,) keypoint right x or -1; scale_factors the octave factors.
    The window, octave and stereo gate, the distances and the level-aware
    best / second best run in the K5 kernel (its twin on the CPU)."""
    radius = _radius(torch.where(view_cos > 0.998, 2.5, 4.0) * th, scale_factors,
                     pred_level)
    kv = kp_valid if already_matched is None else kp_valid & ~already_matched
    best, best_idx, second_same_lvl = cuda_match.projection_best_two(
        uv, radius, pred_level, point_ur, point_valid, point_desc,
        kp_xy, kp_level, kp_ur, kv, kp_desc)
    # the ratio test fires only when a second candidate shares the best's
    # octave (src/ORBmatcher.cc:160-170)
    ratio_ok = torch.where(second_same_lvl < BIG, best <= nn_ratio * second_same_lvl,
                           torch.ones_like(point_valid))
    accept = (best <= TH_HIGH) & ratio_ok & point_valid
    keep = resolve_conflicts(best_idx, best, accept, kp_xy.shape[0])
    return Matches(best_idx, best, keep)


def search_by_projection_reloc(
    uv, pred_level, point_desc, point_valid, point_angle,
    kp_xy, kp_level, kp_desc, kp_valid, kp_angle, already_matched,
    scale_factors, th: float, orb_dist: int, check_rotation: bool = True,
):
    """The relocalization rescue search (`ORBmatcher::SearchByProjection(
    Frame&, KeyFrame*, set&, th, ORBdist)`, `src/ORBmatcher.cc:1922-2075`):
    the candidate keyframe's points (P,) projected at the pose estimate,
    square window th * scale(predicted octave), octaves [pred - 1, pred + 1],
    no stereo test, targets the valid keypoints not matched yet; accept at
    distance <= orb_dist, the rotation histogram, no ratio test. The gate
    and the reduction are K4's window form; its second best is unused."""
    radius = _radius(th, scale_factors, pred_level)
    best, best_idx, _ = cuda_match.window_best_two(
        uv, radius, pred_level, torch.full_like(radius, -1.0), point_valid, point_desc,
        kp_xy, kp_level, torch.full((kp_xy.shape[0],), -1.0, device=kp_xy.device),
        (kp_valid & ~already_matched).contiguous(), kp_desc, (-1, 1))
    accept = (best <= orb_dist) & point_valid
    if check_rotation:
        accept = rotation_consistency(point_angle, kp_angle, accept, best_idx)
    keep = resolve_conflicts(best_idx, best, accept, kp_xy.shape[0])
    return Matches(best_idx, best, keep)


def search_by_projection_frame(
    uv, src_level, src_desc, src_valid, src_angle, src_ur,
    kp_xy, kp_level, kp_desc, kp_valid, kp_angle, kp_ur,
    scale_factors, th: float, forward: bool, backward: bool,
    check_rotation: bool = True,
):
    """Last-frame -> current-frame projection search of the motion model
    (`ORBmatcher::SearchByProjection(Frame&, Frame&, th, bMono)`,
    `src/ORBmatcher.cc:1741-1921`): window th * scale(source level), the
    octave range of the forward/backward rule; the gate and the reduction
    are K4's window form."""
    radius = _radius(th, scale_factors, src_level)
    octaves = (0, cuda_match.OPEN) if forward else (cuda_match.OPEN, 0) if backward else (-1, 1)
    best, best_idx, _ = cuda_match.window_best_two(uv, radius, src_level, src_ur, src_valid,
                                                   src_desc, kp_xy, kp_level, kp_ur, kp_valid,
                                                   kp_desc, octaves)
    accept = (best <= TH_HIGH) & src_valid
    if check_rotation:
        accept = rotation_consistency(src_angle, kp_angle, accept, best_idx)
    keep = resolve_conflicts(best_idx, best, accept, kp_xy.shape[0])
    return Matches(best_idx, best, keep)


def search_for_initialization(
    kp1_xy, kp1_level, kp1_desc, kp1_valid, kp1_angle,
    kp2_xy, kp2_level, kp2_desc, kp2_valid, kp2_angle,
    window: float = 100.0, nn_ratio: float = 0.9, check_rotation: bool = True,
):
    """The monocular initialization's wide-window search
    (`ORBmatcher::SearchForInitialization`, `src/ORBmatcher.cc:580-759`):
    frame 1's keypoints against frame 2's within a square window of
    `window` px, octave 0 on both sides, TH_LOW, the best / second-best
    ratio and the rotation histogram. The gate and the reduction are K4's
    window form: the sources masked to octave 0, the targets' octave range
    (0, 0) around it, no right coordinates (no stereo test)."""
    n1, n2 = kp1_xy.shape[0], kp2_xy.shape[0]
    dev = kp1_xy.device
    best, best_idx, second = cuda_match.window_best_two(
        kp1_xy, torch.full((n1,), window, device=dev), kp1_level,
        torch.full((n1,), -1.0, device=dev), (kp1_valid & (kp1_level == 0)).contiguous(),
        kp1_desc, kp2_xy, kp2_level, torch.full((n2,), -1.0, device=dev), kp2_valid, kp2_desc,
        (0, 0))
    accept = (best <= TH_LOW) & (best < nn_ratio * second) & kp1_valid
    if check_rotation:
        accept = rotation_consistency(kp1_angle, kp2_angle, accept, best_idx)
    keep = resolve_conflicts(best_idx, best, accept, n2)
    return Matches(best_idx, best, keep)


def search_by_node(
    node_a, desc_a, valid_a, angle_a,
    node_b, desc_b, valid_b, angle_b,
    nn_ratio: float = 0.7, check_rotation: bool = True, max_dist: int = TH_LOW,
):
    """BoW-bucket matching (`ORBmatcher::SearchByBoW`,
    `src/ORBmatcher.cc:255-579`): the FeatureVector's node buckets become an
    equality gate on per-feature vocabulary node ids; the gate and the
    reduction are K4's node form."""
    best, best_idx, second = cuda_match.node_best_two(node_a, desc_a, valid_a,
                                                      node_b, desc_b, valid_b)
    accept = (best <= max_dist) & (best < nn_ratio * second) & valid_a
    if check_rotation:
        accept = rotation_consistency(angle_a, angle_b, accept, best_idx)
    keep = resolve_conflicts(best_idx, best, accept, desc_b.shape[0])
    return Matches(best_idx, best, keep)


def search_by_sim3(
    pc1, uv1, lvl1, desc1, valid1,
    pc2, uv2, lvl2, desc2, valid2,
    g12, scale_factors, fx: float, fy: float, cx: float, cy: float,
    th: float = 7.5, max_dist: int = TH_HIGH,
):
    """Guided mutual Sim3 search (`ORBmatcher::SearchBySim3`,
    `src/ORBmatcher.cc:1139-1320`): keyframe 2's points projected into
    image 1 by g12 and keyframe 1's into image 2 by g12^-1, a window of
    th * scale(source octave), any target octave, no stereo test; a pair is
    kept where both directions pick each other at distance <= max_dist
    (:1300-1318). Each direction is one launch of K4's window form, with
    the projected depth z > 0 folded into the sources' validity.
    pc1/pc2 (N,3) bound map points in each camera frame, uv1/uv2 their
    keypoints, g12 maps camera-2 points into camera 1. Returns Matches over
    keyframe 1's features (idx into keyframe 2's)."""
    def project(p):
        z = torch.clamp(p[..., 2], min=1e-9)
        return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1), p[..., 2]

    uv2in1, z21 = project(sim3.apply(g12, pc2))
    uv1in2, z12 = project(sim3.apply(sim3.inverse(g12), pc1))
    open_ = (cuda_match.OPEN, cuda_match.OPEN)
    no_ur1 = torch.full((pc1.shape[0],), -1.0, device=pc1.device)
    no_ur2 = torch.full((pc2.shape[0],), -1.0, device=pc2.device)
    best21, idx21, _ = cuda_match.window_best_two(
        uv2in1, _radius(th, scale_factors, lvl2), lvl2, no_ur2, valid2 & (z21 > 0), desc2,
        uv1, lvl1, no_ur1, valid1, desc1, open_)
    best12, idx12, _ = cuda_match.window_best_two(
        uv1in2, _radius(th, scale_factors, lvl1), lvl1, no_ur1, valid1 & (z12 > 0), desc1,
        uv2, lvl2, no_ur2, valid2, desc2, open_)
    j = torch.clamp(idx12, 0, idx21.shape[0] - 1).long()
    mutual = idx21[j] == torch.arange(idx12.shape[0], dtype=idx21.dtype, device=idx21.device)
    accept = mutual & (best12 <= max_dist) & (best21[j] <= max_dist) & valid1
    return Matches(idx12, best12, accept)
