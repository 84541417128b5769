"""The keyframe database of place recognition (port of
`orb_slam2_tpu/bow/database.py`).

`KeyFrameDatabase` (`src/KeyFrameDatabase.cc`) keeps an inverted file word
-> keyframes sized to the vocabulary; here each keyframe holds a sorted
sparse BoW row of fixed capacity (word ids and weights, at most one entry
per feature), and a query, itself a sorted sparse row, is scored against
every keyframe by one batched binary search: independent of the
vocabulary's size, so the 10^6-word tree fits. The shared-word counts (the
reference's first gate) come out of the same lookup. Plain PyTorch on the
database's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PAD = 2 ** 31 - 1   # sorted-row padding (sorts last)


class BowDatabase(NamedTuple):
    words: torch.Tensor     # (K, S) int32 sorted word ids, PAD for unused
    weights: torch.Tensor   # (K, S) float32, L1-normalized per row
    valid: torch.Tensor     # (K,) bool

    @staticmethod
    def empty(max_keyframes: int, capacity: int, device="cuda"):
        """capacity: the most distinct words of a keyframe (its features)."""
        return BowDatabase(
            words=torch.full((max_keyframes, capacity), PAD, dtype=torch.int32, device=device),
            weights=torch.zeros((max_keyframes, capacity), dtype=torch.float32, device=device),
            valid=torch.zeros((max_keyframes,), dtype=torch.bool, device=device))

    def add(self, kf_id, bow):
        """bow: (words (S,), weights (S,)) from `vocabulary.bow_sparse`;
        kf_id an int or a 0-d tensor on the database's device."""
        w, wt = bow
        k = torch.as_tensor(kf_id, device=self.valid.device).long().reshape(1)
        return self._replace(words=self.words.index_copy(0, k, w[None]),
                             weights=self.weights.index_copy(0, k, wt[None]),
                             valid=self.valid.index_fill(0, k, True))

    def erase(self, kf_mask):
        return self._replace(valid=self.valid & ~kf_mask)


def query_scores(db: BowDatabase, bow):
    """(K,) L1 scores and shared-word counts of a sparse query against every
    keyframe: for L1-normalized rows the DBoW2 L1 score is sum min(a_w, b_w)
    over the shared words (`ScoringObject.cc` L1Scoring)."""
    qw, qwt = bow
    idx = torch.clamp(torch.searchsorted(qw, db.words), 0, qw.shape[0] - 1)
    hit = (qw[idx] == db.words) & (db.words != PAD)
    scores = torch.where(hit, torch.minimum(db.weights, qwt[idx]), torch.zeros_like(db.weights))
    scores = torch.where(db.valid, scores.sum(dim=-1), torch.zeros((), device=qwt.device))
    shared = torch.where(db.valid, hit.sum(dim=-1, dtype=torch.int32),
                         torch.zeros((), dtype=torch.int32, device=qw.device))
    return scores, shared


def _covis_groups(covis):
    """Each keyframe's 10 best covisibility weights and their keyframes
    (`lax.top_k` order: descending, ties to the lower index)."""
    w, i = torch.sort(covis, dim=-1, descending=True, stable=True)
    k = min(10, covis.shape[0])
    return w[:, :k], i[:, :k]


def detect_candidates(db: BowDatabase, bow, exclude_mask, min_score, covis):
    """`DetectLoopCandidates` (`src/KeyFrameDatabase.cc:113-264`): keyframes
    outside exclude_mask sharing > 0.8 * the most shared words and scoring
    >= min_score; each candidate's score accumulated over its top-10
    covisibility group, kept above 0.75 * the best. covis (K,K). Returns
    (cand_mask, acc_scores)."""
    scores, shared = query_scores(db, bow)
    usable = db.valid & ~exclude_mask
    shared = torch.where(usable, shared, torch.zeros_like(shared))
    first = usable & (shared > 0.8 * shared.max()) & (shared > 0) & (scores >= min_score)
    top_w, top_i = _covis_groups(covis)
    group = torch.where((top_w > 0) & first[top_i], scores[top_i], torch.zeros_like(top_w,
                                                                                   dtype=scores.dtype))
    acc = torch.where(first, scores + group.sum(dim=1), torch.zeros_like(scores))
    return first & (acc > 0.75 * acc.max()) & (acc > 0), acc


def detect_reloc_candidates(db: BowDatabase, bow, covis):
    """`DetectRelocalizationCandidates` (`src/KeyFrameDatabase.cc:275-420`):
    as loop detection with no score floor and no exclusion; groups with an
    accumulated score > 0.75 * the best are kept, each returning its
    best-scoring member, the seed included (`:398-414`). Returns (cand_mask
    (K,), acc (K,), scores (K,))."""
    scores, shared = query_scores(db, bow)
    shared = torch.where(db.valid, shared, torch.zeros_like(shared))
    first = db.valid & (shared.to(torch.float32) > 0.8 * shared.max()) & (shared > 0)
    top_w, top_i = _covis_groups(covis)
    member_ok = (top_w > 0) & first[top_i]
    group = torch.where(member_ok, scores[top_i], torch.zeros((), device=scores.device))
    acc = torch.where(first, scores + group.sum(dim=1), torch.zeros_like(scores))
    keep_group = first & (acc > 0.75 * acc.max()) & (acc > 0)

    mem_scores = torch.where(member_ok, scores[top_i], torch.full((), -1.0, device=scores.device))
    best_score, best_col = torch.max(mem_scores, dim=1)
    rows = torch.arange(covis.shape[0], device=covis.device)
    best_kf = torch.where(best_score > scores, top_i[rows, best_col], rows)
    K = covis.shape[0]
    mask = torch.zeros((K + 1,), dtype=torch.bool, device=covis.device).index_fill_(
        0, torch.where(keep_group, best_kf, torch.full_like(best_kf, K)), True)
    return mask[:K], acc, scores
