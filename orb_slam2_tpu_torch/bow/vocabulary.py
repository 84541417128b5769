"""Array-form binary vocabulary tree, the DBoW2 equivalent (port of
`orb_slam2_tpu/bow/vocabulary.py`).

`TemplatedVocabulary` / `FORB` (`Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h:135-372`, `FORB.cpp:30-60`): a k-ary tree over 256-bit
ORB descriptors stored as flat tensors (a children index matrix and the
nodes' descriptors as int32 words, the view of the reference's uint32 bits).
`transform` descends the tree for every descriptor at once, one level per
step (a Hamming argmin over each node's k children), as plain PyTorch on the
tensors' device. Training (hierarchical k-medians with bit-majority
centroids, like `FORB::meanValue`) and the ORBvoc.txt reader are host NumPy,
the reference's own code, so both packages build the same tree.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda_match import popcount32

INT32_MAX = 2 ** 31 - 1


class Vocabulary(NamedTuple):
    k: int                      # branching factor
    depth: int                  # levels below the root
    children: torch.Tensor      # (n_nodes, k) int32 child node ids (-1 pad)
    centroids: torch.Tensor     # (n_nodes, 8) int32 node descriptors
    node_valid: torch.Tensor    # (n_nodes,) bool
    word_id: torch.Tensor       # (n_nodes,) int32 leaf -> word id (-1 inner)
    word_weight: torch.Tensor   # (n_nodes,) float32 idf weight (leaves)
    n_words: int

    @property
    def n_nodes(self):
        return self.children.shape[0]


def _from_arrays(k, depth, children, centroids, node_valid, word_id, weights, n_words,
                 device) -> Vocabulary:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Vocabulary(k=int(k), depth=int(depth), children=t(children.astype(np.int32)),
                      centroids=t(np.asarray(centroids, np.uint32).view(np.int32)),
                      node_valid=t(node_valid.astype(bool)), word_id=t(word_id.astype(np.int32)),
                      word_weight=t(weights.astype(np.float32)), n_words=int(n_words))


def _popcount_np(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _hamming_np(a, b):
    """a: (N,8) uint32, b: (M,8) -> (N,M) int."""
    return _popcount_np(a[:, None, :] ^ b[None, :, :])


def _mean_binary(descs):
    """Bit-majority centroid (FORB::meanValue)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)   # (n, 256)
    return np.packbits((bits.mean(0) >= 0.5).astype(np.uint8)).view(np.uint32)


def build_vocabulary(descriptors, k: int = 10, depth: int = 4, seed: int = 0,
                     n_iters: int = 8, device="cuda") -> Vocabulary:
    """Hierarchical k-medians over (N,8) descriptor words (uint32, or their
    int32 view), breadth first; node count bounded by the geometric series,
    unused branches masked. Leaf weights are the training set's idf."""
    rng = np.random.default_rng(seed)
    descriptors = np.ascontiguousarray(descriptors).view(np.uint32)

    max_nodes = 1 + sum(k ** (lv + 1) for lv in range(depth))
    children = np.full((max_nodes, k), -1, np.int32)
    centroids = np.zeros((max_nodes, 8), np.uint32)
    node_valid = np.zeros(max_nodes, bool)
    node_valid[0] = True
    next_node = 1
    word_id = np.full(max_nodes, -1, np.int32)

    def kmedians(data):
        n = len(data)
        kk = min(k, n)
        cent = data[rng.choice(n, kk, replace=False)]
        for _ in range(n_iters):
            assign = _hamming_np(data, cent).argmin(1)
            for c in range(kk):
                sel = data[assign == c]
                if len(sel):
                    cent[c] = _mean_binary(sel)
        return cent, _hamming_np(data, cent).argmin(1), kk

    queue = [(0, descriptors, 0)]   # (node, data, level)
    leaves = []
    while queue:
        node, data, level = queue.pop(0)
        if level == depth or len(data) <= 1:
            leaves.append(node)
            continue
        cent, assign, kk = kmedians(data)
        for c in range(kk):
            child = next_node
            next_node += 1
            children[node, c] = child
            centroids[child] = cent[c]
            node_valid[child] = True
            sel = data[assign == c]
            if level + 1 == depth or len(sel) <= 1:
                leaves.append(child)
            else:
                queue.append((child, sel, level + 1))
    for w, leaf in enumerate(sorted(leaves)):
        word_id[leaf] = w

    arrays = (children[:next_node], centroids[:next_node], node_valid[:next_node],
              word_id[:next_node])
    tmp = _from_arrays(k, depth, *arrays, (word_id[:next_node] >= 0).astype(np.float32),
                       len(leaves), "cpu")
    # idf weights from the training set (DBoW2 TF-IDF: rare words discriminate)
    words, _, _ = transform(tmp, torch.from_numpy(descriptors.view(np.int32)),
                            torch.ones(len(descriptors), dtype=torch.bool))
    words = words.numpy()
    counts = np.bincount(words[words >= 0], minlength=len(leaves))
    idf = np.maximum(np.log(len(descriptors) / (1.0 + counts)).astype(np.float32), 0.0)
    weights = np.zeros(next_node, np.float32)
    leaf = word_id[:next_node] >= 0
    weights[leaf] = idf[word_id[:next_node][leaf]]
    return _from_arrays(k, depth, *arrays, weights, len(leaves), device)


def synth_vocabulary(k: int = 10, depth: int = 6, seed: int = 0, device="cuda") -> Vocabulary:
    """A complete k-ary tree at the reference ORBvoc's scale (k=10, depth=6:
    10^6 words, 1,111,111 nodes, the shape `src/System.cc:58-77` loads), with
    random centroids and idf weights: the same descent, memory layout and
    sparse-row sizes as the real vocabulary, without its 140 MB text file.
    The breadth-first child layout of a complete tree is arithmetic."""
    rng = np.random.default_rng(seed)
    level_sizes = [k ** (lv + 1) for lv in range(depth)]
    n_nodes = 1 + sum(level_sizes)
    # level l starts at off[l]; node p of level l has children
    # off[l+1] + p*k .. +k-1
    off = np.zeros(depth + 1, np.int64)
    for lv in range(depth):
        off[lv + 1] = off[lv] + (1 if lv == 0 else level_sizes[lv - 1])
    children = np.full((n_nodes, k), -1, np.int32)
    for lv in range(depth):
        n_par = 1 if lv == 0 else level_sizes[lv - 1]
        par = np.arange(off[lv], off[lv] + n_par)
        base = off[lv + 1] + np.arange(n_par)[:, None] * k
        children[par] = (base + np.arange(k)[None, :]).astype(np.int32)
    centroids = rng.integers(0, 2 ** 32, size=(n_nodes, 8), dtype=np.uint64).astype(np.uint32)
    word_id = np.full(n_nodes, -1, np.int32)
    n_words = level_sizes[-1]
    word_id[off[depth]:] = np.arange(n_words, dtype=np.int32)
    weights = np.zeros(n_nodes, np.float32)
    weights[off[depth]:] = rng.uniform(0.1, 4.0, n_words).astype(np.float32)
    return _from_arrays(k, depth, children, centroids, np.ones(n_nodes, bool), word_id,
                        weights, n_words, device)


def save_npz(voc: Vocabulary, path: str):
    """Cache a vocabulary as npz (centroids as the reference's uint32
    words), so a converted ORBvoc.txt is parsed once."""
    a = lambda t: t.cpu().numpy()
    np.savez_compressed(
        path, k=voc.k, depth=voc.depth, children=a(voc.children),
        centroids=a(voc.centroids).view(np.uint32), node_valid=a(voc.node_valid),
        word_id=a(voc.word_id), word_weight=a(voc.word_weight), n_words=voc.n_words)


def load_npz(path: str, device="cuda") -> Vocabulary:
    d = np.load(path)
    return _from_arrays(d["k"], d["depth"], d["children"], d["centroids"], d["node_valid"],
                        d["word_id"], d["word_weight"], d["n_words"], device)


def load_orb_vocabulary(path: str, device="cuda") -> Vocabulary:
    """The reference's ORBvoc.txt (DBoW2 text format: a header 'k L s1 s2',
    then one line per node: parent, is-leaf, 32 descriptor bytes, weight)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        rows = [parts for parts in (line.split() for line in f) if len(parts) >= 35]
    n = len(rows) + 1
    children = np.full((n, k), -1, np.int32)
    centroids = np.zeros((n, 8), np.uint32)
    node_valid = np.zeros(n, bool)
    node_valid[0] = True
    word_id = np.full(n, -1, np.int32)
    weights = np.zeros(n, np.float32)
    child_count = np.zeros(n, np.int32)
    n_words = 0
    for i, parts in enumerate(rows):
        nid, parent = i + 1, int(parts[0])
        centroids[nid] = np.array([int(x) for x in parts[2:34]], np.uint8).view(np.uint32)
        weights[nid] = float(parts[34])
        children[parent, child_count[parent]] = nid
        child_count[parent] += 1
        node_valid[nid] = True
        if int(parts[1]):
            word_id[nid] = n_words
            n_words += 1
    return _from_arrays(k, L, children, centroids, node_valid, word_id, weights, n_words,
                        device)


def transform(voc: Vocabulary, desc, valid, levels_up: int = 2):
    """The tree descent of every descriptor at once (DBoW2 `transform` with
    the FeatureVector's node record): desc (N,8) int32, valid (N,) bool on
    the vocabulary's device. Returns (word (N,) int32, -1 where invalid;
    weight (N,) float32; node (N,) int32, the node at depth `levels_up`)."""
    n = desc.shape[0]
    dev = desc.device
    last = voc.n_nodes - 1
    cur = torch.zeros((n,), dtype=torch.int64, device=dev)
    rec = torch.zeros((n,), dtype=torch.int64, device=dev)
    for level in range(voc.depth):
        ch = voc.children[cur]                                      # (N,k)
        ch_ok = ch >= 0
        cent = voc.centroids[torch.clamp(ch, 0, last).long()]       # (N,k,8)
        d = popcount32(cent ^ desc[:, None, :]).sum(dim=-1)
        d = torch.where(ch_ok, d, torch.full_like(d, 1 << 20))
        nxt = torch.gather(ch, 1, torch.argmin(d, dim=-1, keepdim=True))[:, 0].long()
        # a node without children keeps its id
        cur = torch.where(ch_ok.any(dim=-1), nxt, cur)
        if level + 1 == levels_up:
            rec = cur
    word = torch.where(valid, voc.word_id[cur], torch.full((), -1, dtype=torch.int32,
                                                           device=dev))
    weight = torch.where(valid, voc.word_weight[cur], torch.zeros((), device=dev))
    rec = torch.where(valid, rec.to(torch.int32), torch.full((), -1, dtype=torch.int32,
                                                             device=dev))
    return word, weight, rec


def bow_sparse(word, weight):
    """Per-descriptor (word, weight) pairs summed into a sorted sparse
    L1-normalized BoW row: (words (N,) int32 ascending, INT32_MAX padded;
    weights (N,) float32). Zero-weight words (idf-0 stop words) are dropped,
    as DBoW2's BowVector::addWeight does under TF-IDF."""
    n = word.shape[0]
    dev = word.device
    pad = torch.full((), INT32_MAX, dtype=torch.int32, device=dev)
    w = torch.where((word >= 0) & (weight > 0), word, pad)
    ws, order = torch.sort(w, stable=True)
    live = ws != pad
    wt = torch.where(live, weight[order], torch.zeros((), device=dev))
    is_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), ws[1:] != ws[:-1]])
    is_first = is_first & live
    seg = torch.cumsum(is_first.to(torch.int64), 0) - 1           # run index
    agg = torch.zeros((n + 1,), dtype=torch.float32, device=dev).index_add_(
        0, torch.where(live, seg, torch.full_like(seg, n)), wt)[:n]
    uniq = torch.full((n + 1,), INT32_MAX, dtype=torch.int32, device=dev).index_put_(
        (torch.where(is_first, seg, torch.full_like(seg, n)),), ws)[:n]
    return uniq, agg / torch.clamp(agg.sum(), min=1e-12)


def bow_vector(word, weight, n_words: int):
    """Per-descriptor words summed into a dense L1-normalized BoW vector
    (n_words,)."""
    v = torch.zeros((n_words + 1,), dtype=torch.float32, device=word.device).index_add_(
        0, torch.where(word >= 0, word, n_words).long(), weight)[:n_words]
    return v / torch.clamp(v.sum(), min=1e-12)


def l1_score(v1, v2):
    """DBoW2's L1 score of L1-normalized vectors, sum min(a, b)
    (`ScoringObject.cc` L1Scoring)."""
    return torch.minimum(v1, v2).sum(dim=-1)
