"""The local-BA assembly kernel K9, its plain-PyTorch twins and its wrapper
(port of the BA half of `orb_slam2_tpu/ops/pallas_kernels.py` and of the
reductions `schur_ba._assemble_pallas` runs around it).

| wrapper       | kernel (csrc/) | replaces (TPU kernel)                 | twin                 |
|---------------|----------------|---------------------------------------|----------------------|
| `ba_assemble` | `ba_edge.cu`   | `pallas_kernels.ba_edge_terms_pallas` | `ba_assemble_plain`  |

The wrapper dispatches on the device of its input (`launch.py`): a CPU
tensor runs the twin, a CUDA tensor launches the kernel or raises. One
launch gives every field of `schur_ba.Lin`. The per-edge terms are
`ba_edge_terms_plain`, the reference's (64, E) row matrix (`BA_ROW_*` name
its blocks); kernel and twin perform the same float32 operations per edge
in the same order (the kernel is built without FMA contraction), and sum
them in the same fixed order (`ba_assemble_plain`), so they agree bit for
bit.
"""
from __future__ import annotations


import torch

from ..solvers import reproj
from ..utils.config import device_cache, device_table
from .launch import check, counters as launch_counters, launch, on_cpu, ptr

BA_ROWS = 64
BA_ROW_HCC = 0        # 21 rows: upper triangle of the 6x6 pose block
BA_ROW_W = 21         # 18 rows: the 6x3 pose-point block, row-major
BA_ROW_HPP = 39       # 6 rows: upper triangle of the 3x3 point block
BA_ROW_BC = 45        # 6 rows: pose right-hand side
BA_ROW_BP = 51        # 3 rows: point right-hand side
BA_ROW_ERR = 54       # chi2 * mask: the LM accept/reject error term
BA_ROW_CHI2 = 55      # raw chi2 (penalty form), for reclassification
BA_ROW_DEPTH = 56     # depth_ok
BA_THREADS = 256     # the kernel's block: threads of a chunk and of the err tree (NT)
BA_CHUNK = 512       # edges of a camera-role chunk (`csrc/ba_edge.cu` K)
TRI6 = [(i, j) for i in range(6) for j in range(i, 6)]
TRI3 = [(i, j) for i in range(3) for j in range(i, 3)]


@device_cache()
def symmetric_index(n: int, device):
    """(n, n) int64 index of the symmetric matrix into its row-major upper
    triangle's n(n+1)/2 entries."""
    tri = TRI6 if n == 6 else TRI3
    idx = torch.zeros((n, n), dtype=torch.int64)
    for r, (i, j) in enumerate(tri):
        idx[i, j] = idx[j, i] = r
    return idx.to(device)


def ba_edge_terms_plain(cam, pose_rows, Xw, obs, inv_sigma2, stereo, mask,
                        robust: bool):
    """pose_rows (12,E): each edge's camera pose, R row-major then t;
    Xw, obs (3,E) (obs uR = -1 mono); inv_sigma2, stereo (0/1), mask (E,)
    float32. Returns the (64,E) float32 rows (`BA_ROW_*`), each term in
    the reference kernel's operation order (`_ba_edge_kernel`)."""
    r = pose_rows
    x, y, z = Xw[0], Xw[1], Xw[2]
    d2m, d2s = device_table((reproj.CHI2_MONO, reproj.CHI2_STEREO), Xw.device)
    pcx = r[0] * x + r[1] * y + r[2] * z + r[9]
    pcy = r[3] * x + r[4] * y + r[5] * z + r[10]
    pcz = r[6] * x + r[7] * y + r[8] * z + r[11]
    invz_p = 1.0 / torch.clamp(pcz, min=1e-9)
    u_p = cam.fx * pcx * invz_p + cam.cx
    v_p = cam.fy * pcy * invz_p + cam.cy
    ur_p = u_p - cam.bf * invz_p
    eu, ev, eur = obs[0] - u_p, obs[1] - v_p, obs[2] - ur_p
    st = stereo
    chi2 = inv_sigma2 * (eu * eu + ev * ev + st * eur * eur)
    delta2 = d2m + st * (d2s - d2m)
    if robust:
        w_rob = torch.where(chi2 <= delta2, torch.ones_like(chi2),
                            torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
    else:
        w_rob = torch.ones_like(chi2)
    front = pcz > 1e-6
    depth_ok = front.to(torch.float32)
    w = w_rob * inv_sigma2 * mask * depth_ok

    invz = torch.where(front, invz_p, torch.zeros_like(invz_p))
    invz2 = invz * invz
    a, b = cam.fx * invz, cam.fy * invz
    c = -cam.fx * pcx * invz2
    d = -cam.fy * pcy * invz2
    cr = c + cam.bf * invz2
    zero = torch.zeros_like(a)
    Ju = (-a, zero, -c, -(c * pcy), -(a * pcz - c * pcx), a * pcy)
    Jv = (zero, -b, -d, -(-b * pcz + d * pcy), d * pcx, -b * pcx)
    Jr = (-a, zero, -cr, -(cr * pcy), -(a * pcz - cr * pcx), a * pcy)
    Jlu = [-(a * r[k] + c * r[6 + k]) for k in range(3)]
    Jlv = [-(b * r[3 + k] + d * r[6 + k]) for k in range(3)]
    Jlr = [-(a * r[k] + cr * r[6 + k]) for k in range(3)]
    wst = w * st
    wJu, wJv, wJr = [w * t for t in Ju], [w * t for t in Jv], [wst * t for t in Jr]
    wJlu, wJlv, wJlr = [w * t for t in Jlu], [w * t for t in Jlv], [wst * t for t in Jlr]

    rows = [wJu[i] * Ju[j] + wJv[i] * Jv[j] + wJr[i] * Jr[j] for i, j in TRI6]
    rows += [wJu[i] * Jlu[k] + wJv[i] * Jlv[k] + wJr[i] * Jlr[k]
             for i in range(6) for k in range(3)]
    rows += [wJlu[i] * Jlu[j] + wJlv[i] * Jlv[j] + wJlr[i] * Jlr[j] for i, j in TRI3]
    rows += [-(wJu[i] * eu + wJv[i] * ev + wJr[i] * eur) for i in range(6)]
    rows += [-(wJlu[k] * eu + wJlv[k] * ev + wJlr[k] * eur) for k in range(3)]
    rows += [chi2 * mask, chi2, depth_ok]
    rows += [zero] * (BA_ROWS - len(rows))
    return torch.stack(rows)


def _halve(x):
    """The kernel's halving tree over the last axis (a power of two):
    x[u] += x[u + n] for n = N/2 .. 1. Returns x[..., 0]."""
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:2 * n]
    return x[..., 0]


def _strided_sums(vals, valid, nt: int):
    """vals (V, G, L), valid (G, L) bool with L a multiple of nt: per thread
    t < nt of each group g, the sum from 0 of vals[:, g, t + i*nt] in order
    of i over the valid positions, then the halving tree. Returns (V, G)."""
    V, G, L = vals.shape
    vals = vals.reshape(V, G, L // nt, nt)
    valid = valid.reshape(G, L // nt, nt)
    acc = torch.zeros((V, G, nt), dtype=vals.dtype, device=vals.device)
    for i in range(L // nt):
        acc = torch.where(valid[:, i], acc + vals[:, :, i], acc)
    return _halve(acc)


def ba_assemble_plain(cam, poses, points, pt_valid, edges, edge_mask, robust: bool):
    """The normal-equation pieces of local BA at (poses (C,4,4), points
    (Q,3)): (Hcc (C,6,6), bc (C,6), Hpp (Q,3,3), bp (Q,3), We (Q,O,6,3),
    pt_on (Q,) bool, err (), chi2 (Q,O), depth_ok (Q,O) bool), the fields
    of `schur_ba.Lin`. edges: `schur_ba._Edges` (the camera-major list
    included); edge_mask (Q,O) float32. Any C >= 1.

    The per-edge terms are `ba_edge_terms_plain`; the sums run in the
    kernel's order (`csrc/ba_edge.cu`), written out with explicit adds:
    - per point, its O edges in order o = 0..O-1 from 0 (Hpp, bp, and the
      point's share of err);
    - per camera, its edges in edge order cut into chunks of BA_CHUNK: in a
      chunk, thread t < BA_THREADS sums positions t, t + BA_THREADS, ...
      from 0, then the halving tree over the threads; then the camera's
      chunks in order from 0 (no chunk: zeros). Chunk j of camera c is
      block first(c) + j of the grid, first(c) the chunks of the cameras
      before c;
    - err: thread t sums the points' shares t, t + BA_THREADS, ... from 0,
      then the halving tree."""
    dev = points.device
    C, Q = poses.shape[0], points.shape[0]
    O = edge_mask.shape[1]
    E, nt, k = Q * O, BA_THREADS, BA_CHUNK
    rows = torch.cat([poses[:, :3, :3].reshape(C, 9), poses[:, :3, 3]], dim=1)
    out = ba_edge_terms_plain(cam, rows.index_select(0, edges.cam.long()).T,
                              points.repeat_interleave(O, dim=0).T, edges.obs,
                              edges.inv_sigma2, edges.stereo, edge_mask.reshape(E), robust)

    pt = out[[*range(BA_ROW_HPP, BA_ROW_BC), *range(BA_ROW_BP, BA_ROW_ERR + 1)]
             ].reshape(10, Q, O)
    acc = torch.zeros((10, Q), dtype=torch.float32, device=dev)
    for o in range(O):
        acc = acc + pt[:, :, o]
    Hpp = acc[:6].T[:, symmetric_index(3, dev).reshape(-1)].reshape(Q, 3, 3)
    bp = acc[6:9].T.contiguous()

    # the camera role's chunks (a static bound on their count, as the grid)
    G = -(-E // k) + C
    g = torch.arange(G, dtype=torch.int64, device=dev)
    cam_start = edges.cam_start.long()
    n_chunks = (cam_start[1:] - cam_start[:-1] + k - 1) // k
    chunk_start = torch.cat([cam_start[:1] * 0, torch.cumsum(n_chunks, 0)])   # first(c)
    c = torch.clamp(torch.searchsorted(chunk_start, g, right=True) - 1, 0, C - 1)
    pos0 = cam_start[c] + (g - chunk_start[c]) * k
    pos1 = torch.minimum(pos0 + k, cam_start[c + 1])
    pos = pos0[:, None] + torch.arange(k, device=dev)[None, :]
    valid = (g < chunk_start[C])[:, None] & (pos < pos1[:, None])
    e = edges.order.long()[torch.clamp(pos, 0, E - 1)]
    cam_rows = out[[*range(BA_ROW_HCC, BA_ROW_W), *range(BA_ROW_BC, BA_ROW_BP)]]
    partial = _strided_sums(cam_rows[:, e], valid, nt)                 # (27, G)
    tot = torch.zeros((27, C), dtype=torch.float32, device=dev)
    for j in range(int(n_chunks.max()) if C else 0):
        gj = torch.clamp(chunk_start[:-1] + j, 0, G - 1)
        tot = torch.where(j < n_chunks, tot + partial[:, gj], tot)
    Hcc = tot[:21].T[:, symmetric_index(6, dev).reshape(-1)].reshape(C, 6, 6)
    bc = tot[21:].T.contiguous()

    rows_q = -(-Q // nt)
    share = torch.zeros(rows_q * nt, dtype=torch.float32, device=dev)
    share[:Q] = acc[9]
    q_ok = torch.arange(rows_q * nt, device=dev) < Q
    err = _strided_sums(share.reshape(1, 1, -1), q_ok.reshape(1, -1), nt)[0, 0]

    We = out[BA_ROW_W:BA_ROW_HPP].T.reshape(Q, O, 6, 3)
    pt_on = pt_valid & (edge_mask > 0).any(dim=1)
    return (Hcc, bc, Hpp, bp, We, pt_on, err, out[BA_ROW_CHI2].reshape(Q, O),
            out[BA_ROW_DEPTH].reshape(Q, O) > 0)


def ba_assemble(cam, poses, points, pt_valid, edges, edge_mask, robust: bool):
    """Kernel wrapper of `ba_assemble_plain` (K9, `csrc/ba_edge.cu`): one
    launch, deterministic."""
    if on_cpu(points):
        return ba_assemble_plain(cam, poses, points, pt_valid, edges, edge_mask, robust)
    dev = points.device
    C, Q = poses.shape[0], points.shape[0]
    O = edge_mask.shape[1] if edge_mask.dim() == 2 else 0
    E = Q * O
    if C < 1 or Q < 1 or not 1 <= O <= BA_THREADS:
        raise ValueError(f"ba_assemble: C={C}, Q={Q}, O={O} (the kernel takes C >= 1, Q >= 1 "
                         f"and 1 <= O <= {BA_THREADS})")
    for t, dtype, shape, name in (
            (poses, torch.float32, (C, 4, 4), "poses"), (points, torch.float32, (Q, 3), "points"),
            (pt_valid, torch.bool, (Q,), "pt_valid"), (edges.cam, torch.int32, (E,), "cam"),
            (edges.obs, torch.float32, (3, E), "obs"),
            (edges.inv_sigma2, torch.float32, (E,), "inv_sigma2"),
            (edges.stereo, torch.float32, (E,), "stereo"),
            (edge_mask, torch.float32, (Q, O), "edge_mask"),
            (edges.order, torch.int32, (E,), "order"),
            (edges.cam_start, torch.int32, (C + 1,), "cam_start")):
        check(t, dtype, shape, dev, f"ba_assemble {name}", 4 if t.element_size() >= 4 else 1)
    for field in ("fx", "fy", "cx", "cy", "bf"):
        check(getattr(cam, field), torch.float32, (), dev, f"ba_assemble camera {field}")
    f32 = dict(dtype=torch.float32, device=dev)
    Hcc, bc = torch.empty((C, 6, 6), **f32), torch.empty((C, 6), **f32)
    Hpp, bp = torch.empty((Q, 3, 3), **f32), torch.empty((Q, 3), **f32)
    We, err, chi2 = torch.empty((Q, O, 6, 3), **f32), torch.empty((), **f32), torch.empty((Q, O), **f32)
    pt_on = torch.empty((Q,), dtype=torch.bool, device=dev)
    depth_ok = torch.empty((Q, O), dtype=torch.bool, device=dev)
    partial = torch.empty((-(-E // BA_CHUNK) + C, 27), **f32)
    err_pt = torch.empty((Q,), **f32)
    counters = launch_counters("ba_edge", dev, C + 1)
    launch("ba_edge", "orb_ba_assemble", dev, ptr(cam.fx), ptr(cam.fy), ptr(cam.cx),
           ptr(cam.cy), ptr(cam.bf), reproj.CHI2_MONO, reproj.CHI2_STEREO, int(bool(robust)),
           ptr(poses), ptr(points), ptr(pt_valid), ptr(edges.cam), ptr(edges.obs),
           ptr(edges.inv_sigma2), ptr(edges.stereo), ptr(edge_mask), ptr(edges.order),
           ptr(edges.cam_start), Q, O, C, ptr(Hcc), ptr(bc), ptr(Hpp), ptr(bp), ptr(We),
           ptr(pt_on), ptr(err), ptr(chi2), ptr(depth_ok), ptr(partial), ptr(err_pt),
           ptr(counters))
    return Hcc, bc, Hpp, bp, We, pt_on, err, chi2, depth_ok
