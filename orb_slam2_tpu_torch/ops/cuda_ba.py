"""The local-BA edge kernel K9, its plain-PyTorch twin and its wrapper (port
of the BA half of `orb_slam2_tpu/ops/pallas_kernels.py`).

| wrapper         | kernel (csrc/)  | replaces (TPU kernel)                   | twin                  |
|-----------------|-----------------|-----------------------------------------|-----------------------|
| `ba_edge_terms` | `ba_edge.cu`    | `pallas_kernels.ba_edge_terms_pallas`   | `ba_edge_terms_plain` |

The wrapper dispatches on the device of its input (`launch.py`): a CPU
tensor runs the twin, a CUDA tensor launches the kernel or raises. Kernel
and twin perform the same float32 operations per edge in the same order
(the kernel is built without FMA contraction), so they differ only where a
library's division or square root rounds differently. The output is the
reference's (64, E) row matrix; `BA_ROW_*` name its blocks.
"""
from __future__ import annotations

import functools

import torch

from ..solvers import reproj
from ..utils.config import device_table
from .launch import check, launch, on_cpu, ptr

BA_ROWS = 64
BA_ROW_HCC = 0        # 21 rows: upper triangle of the 6x6 pose block
BA_ROW_W = 21         # 18 rows: the 6x3 pose-point block, row-major
BA_ROW_HPP = 39       # 6 rows: upper triangle of the 3x3 point block
BA_ROW_BC = 45        # 6 rows: pose right-hand side
BA_ROW_BP = 51        # 3 rows: point right-hand side
BA_ROW_ERR = 54       # chi2 * mask: the LM accept/reject error term
BA_ROW_CHI2 = 55      # raw chi2 (penalty form), for reclassification
BA_ROW_DEPTH = 56     # depth_ok
TRI6 = [(i, j) for i in range(6) for j in range(i, 6)]
TRI3 = [(i, j) for i in range(3) for j in range(i, 3)]


@functools.lru_cache(maxsize=16)
def symmetric_index(n: int, device):
    """(n, n) int64 index of the symmetric matrix into its row-major upper
    triangle's n(n+1)/2 entries."""
    tri = TRI6 if n == 6 else TRI3
    idx = torch.zeros((n, n), dtype=torch.int64)
    for r, (i, j) in enumerate(tri):
        idx[i, j] = idx[j, i] = r
    return idx.to(device)


def _params(cam, device):
    """The kernel's (7,) parameter vector: fx fy cx cy bf and the chi2
    thresholds mono and stereo."""
    return torch.cat([torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf]).to(device),
                      device_table((reproj.CHI2_MONO, reproj.CHI2_STEREO), device)])


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


def ba_edge_terms(cam, pose_rows, Xw, obs, inv_sigma2, stereo, mask, robust: bool):
    """Kernel wrapper of `ba_edge_terms_plain` (K9, `csrc/ba_edge.cu`)."""
    if on_cpu(Xw):
        return ba_edge_terms_plain(cam, pose_rows, Xw, obs, inv_sigma2, stereo, mask,
                                   robust)
    dev = Xw.device
    e = Xw.shape[1]
    for t, shape, name in ((pose_rows, (12, e), "pose_rows"), (Xw, (3, e), "Xw"),
                           (obs, (3, e), "obs"), (inv_sigma2, (e,), "inv_sigma2"),
                           (stereo, (e,), "stereo"), (mask, (e,), "mask")):
        check(t, torch.float32, shape, dev, f"ba_edge_terms {name}", 4)
    par = _params(cam, dev)                  # named: lives until the launch is queued
    out = torch.empty((BA_ROWS, e), dtype=torch.float32, device=dev)
    if e:
        launch("ba_edge", "orb_ba_edge", dev, ptr(par), ptr(pose_rows), ptr(Xw), ptr(obs),
               ptr(inv_sigma2), ptr(stereo), ptr(mask), e, int(bool(robust)), ptr(out))
    return out
