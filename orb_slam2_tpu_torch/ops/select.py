"""Spatially-uniform keypoint selection to a fixed budget (port of
`orb_slam2_tpu/ops/select.py`).

The reference's recursive quadtree `DistributeOctTree`
(`src/ORBextractor.cc:696-1042`) in fixed-depth form: a geometric ladder of
nested uniform grids (4x cells per step, starting from ~round(W/H) root
cells like the reference's nIni); the coarsest depth whose occupied-cell
count reaches the budget keeps the best-scoring pixel of each occupied cell;
a stable sort by response trims to the budget. The image-resolution work is
one pooling pass at the finest grid; every coarser depth is a 2x2 merge of
(value desc, pixel index asc) winners. No host synchronisation: the depth
is chosen on the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_DEPTH = 7  # 4^7 * nIni cells — beyond any per-level budget


def _fold_best(entries):
    """Best (v, i) of a list of entry pairs under the strict (value desc,
    pixel index asc) order."""
    v, i = entries[0]
    for vn, inn in entries[1:]:
        take = (vn > v) | ((vn == v) & (inn < i))
        v = torch.where(take, vn, v)
        i = torch.where(take, inn, i)
    return v, i


def _top2_of(entries, noidx: int):
    """The best two of a list of (v, i) pairs under the (value desc, pixel
    index asc) order, the first taken out exactly once (indices are unique
    but for padded noidx entries, which are interchangeable)."""
    v1, i1 = _fold_best(entries)
    rest, taken = [], None
    for v, i in entries:
        match = (v == v1) & (i == i1)
        remove = match if taken is None else match & ~taken
        taken = match if taken is None else taken | match
        rest.append((torch.where(remove, float("-inf"), v), torch.where(remove, noidx, i)))
    v2, i2 = _fold_best(rest)
    return v1, i1, v2, i2


def select_uniform(score, budget: int,
                   min_border_x: int, max_border_x: int,
                   min_border_y: int, max_border_y: int,
                   per_cell: int = 1):
    """score: (H, W) map with -inf at non-candidates.

    Returns (ys, xs, resp, valid), each of shape (budget,): int32 pixel
    coords of the selected keypoints (level-image frame), their scores and
    a validity mask. per_cell=2 (`cfg.select_top2`) keeps the best and the
    second best of each cell before the trim (the reference's quadtree
    keeps one per leaf, `src/ORBextractor.cc:1030-1037`)."""
    h, w = score.shape
    dev = score.device
    width = max_border_x - min_border_x
    height = max_border_y - min_border_y
    n_ini = max(int(round(width / height)), 1)
    D = MAX_DEPTH

    nrf = 1 << (D - 1)
    ncf = n_ini << (D - 1)
    ch = -(-height // nrf)       # ceil
    cw = -(-width // ncf)
    R, C = nrf * ch, ncf * cw

    sl = score[min_border_y:max_border_y, min_border_x:max_border_x]
    sl = F.pad(sl, (0, C - width, 0, R - height), value=float("-inf"))
    cand = sl > float("-inf")
    lin = torch.arange(R * C, dtype=torch.int32, device=dev).reshape(R, C)
    NOIDX = R * C
    Fn = nrf * ncf               # finest cell count: every depth pads to it

    def up(g):
        return g.repeat_interleave(ch, dim=0).repeat_interleave(cw, dim=1)

    # the only image-resolution pass: finest-depth per-cell winners
    v1 = sl.reshape(nrf, ch, ncf, cw).amax(dim=(1, 3))
    is_max = cand & (sl == up(v1))
    def pool_min_idx(mask):
        return torch.where(mask, lin, torch.full_like(lin, NOIDX)).reshape(
            nrf, ch, ncf, cw).amin(dim=(1, 3))

    i1 = pool_min_idx(is_max)
    states = [[(v1, i1)]]                                 # index: D-1-d
    if per_cell >= 2:
        # each finest cell's runner-up: its winner masked out
        sl2 = torch.where(is_max & (lin == up(i1)), float("-inf"), sl)
        v2 = sl2.reshape(nrf, ch, ncf, cw).amax(dim=(1, 3))
        states[0].append((v2, pool_min_idx((sl2 > float("-inf")) & (sl2 == up(v2)))))

    def quads(a):
        q = a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2)
        return [q[:, 0, :, 0], q[:, 0, :, 1], q[:, 1, :, 0], q[:, 1, :, 1]]

    for _ in range(D - 1):
        ents = [e for pv, pi in states[-1] for e in zip(quads(pv), quads(pi))]
        if per_cell >= 2:
            nv1, ni1, nv2, ni2 = _top2_of(ents, NOIDX)
            states.append([(nv1, ni1), (nv2, ni2)])
        else:
            states.append([_fold_best(ents)])
    states = states[::-1]                                 # index by depth d

    val_rows, idx_rows, occupied = [], [], []
    for ranks in states:
        n_cells = ranks[0][0].numel()
        occupied.append((ranks[0][0] > float("-inf")).sum())
        val_rows.append(torch.cat([F.pad(gv.reshape(-1), (0, Fn - n_cells), value=float("-inf"))
                                   for gv, _ in ranks]))
        idx_rows.append(torch.cat([F.pad(gi.reshape(-1), (0, Fn - n_cells), value=NOIDX)
                                   for _, gi in ranks]))

    reaches = torch.stack(occupied) >= budget             # (D,)
    # coarsest depth reaching the budget; if none, the deepest grid. A fill
    # and a 1-element index_select: no copy from the host and no read back
    first = torch.argmax(reaches.to(torch.int32))
    depth = torch.where(reaches.any(), first, torch.full_like(first, D - 1)).view(1)
    sel_val = torch.stack(val_rows).index_select(0, depth)[0]
    sel_idx = torch.stack(idx_rows).index_select(0, depth)[0]

    # top-k with the lower index first among equal responses (lax.top_k's
    # order; torch.topk promises none)
    k = torch.argsort(sel_val, descending=True, stable=True)[:budget]
    resp = sel_val[k]
    idx = sel_idx[k]
    valid = (resp > float("-inf")) & (idx < NOIDX)
    idxc = torch.clamp(idx, max=NOIDX - 1)
    ys_out = torch.clamp(idxc // C + min_border_y, max=h - 1).to(torch.int32)
    xs_out = torch.clamp(idxc % C + min_border_x, max=w - 1).to(torch.int32)
    return ys_out, xs_out, resp, valid
