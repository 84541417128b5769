"""The pose kernels K6 and K7, their plain-PyTorch twins and their wrappers
(port of the pose half of `orb_slam2_tpu/ops/pallas_kernels.py`).

| wrapper           | kernel (csrc/)              | replaces (TPU kernel)                     | twin                    |
|-------------------|-----------------------------|-------------------------------------------|-------------------------|
| `pose_lm`         | `pose_lm.cu` `orb_pose_lm`  | `pallas_kernels.pose_lm_pallas`           | `pose_lm_plain`         |
| `pose_normal_eqs` | `pose_lm.cu` `orb_pose_normal_eqs` | `pallas_kernels.pose_normal_eqs_pallas` | `pose_normal_eqs_plain` |

Both kernels run one thread-block cluster of 8 CTAs (sm_90) and reduce the
per-edge terms of `csrc/pose_sweep.cuh` through one cluster sweep
(`pose_lm.cu` `cluster_sweep`), in a fixed order. Each wrapper
dispatches on the device of its input (`launch.py`): a CPU tensor runs the
twin, a CUDA tensor launches the kernel or raises. The kernels sum the edges
in another order than the twins, so they agree within a tolerance, not bit
for bit. The twin of K6 is the reference's XLA schedule
(`solvers/pose_opt.py`); the twin of K7 is its normal-equation build.
Per-edge inputs: Xw, obs (E,3) float32 (uR = -1 mono), inv_sigma2 (E,)
float32, stereo and valid (E,) bool; the camera's fields are 0-d float32
tensors on the edges' device.
"""
from __future__ import annotations


import torch

from ..solvers import reproj
from ..utils.config import device_cache
from .launch import check, launch, on_cpu, ptr


@device_cache()
def triangle(device):
    """The row-major upper triangle of a 6x6 on `device`: its 21 row and
    column indices, and the (6,6) gather index of the symmetric matrix from
    the 21 entries."""
    i, j = torch.triu_indices(6, 6)
    full = torch.zeros((6, 6), dtype=torch.int64)
    full[i, j] = full[j, i] = torch.arange(21)
    return i.to(device), j.to(device), full.to(device)


def _params(cam, Tcw, name):
    """The kernels' pose and camera arguments, as the caller holds them (no
    packing on the card): Tcw (4,4) and fx fy cx cy bf (0-d float32
    tensors), then the chi2 thresholds mono and stereo by value."""
    dev = Tcw.device
    check(Tcw, torch.float32, (4, 4), dev, f"{name} Tcw")
    for field in ("fx", "fy", "cx", "cy", "bf"):
        check(getattr(cam, field), torch.float32, (), dev, f"{name} camera {field}")
    return (ptr(Tcw), ptr(cam.fx), ptr(cam.fy), ptr(cam.cx), ptr(cam.cy), ptr(cam.bf),
            reproj.CHI2_MONO, reproj.CHI2_STEREO)


def _check_edges(Xw, obs, inv_sigma2, name):
    e = Xw.shape[0]
    for t, shape, what in ((Xw, (e, 3), "Xw"), (obs, (e, 3), "obs"),
                           (inv_sigma2, (e,), "inv_sigma2")):
        check(t, torch.float32, shape, Xw.device, f"{name} {what}")
    return e


# ---------------------------------------------------------------------------
# K6: the whole 4 x 10 LM schedule
# ---------------------------------------------------------------------------

def pose_lm_plain(cam, Tcw, Xw, obs, inv_sigma2, stereo, valid, n_rounds: int,
                  n_iters: int):
    """The reference's XLA schedule (`pose_opt.py:142-156`): n_rounds rounds
    of n_iters LM steps at a fixed inlier mask (Huber on rounds 1-2), then
    every valid edge reclassified by chi2 and depth. Returns (Tcw (4,4),
    inliers (E,) bool, n_inliers () int32, chi2 (E,))."""
    from ..solvers import pose_opt        # pose_opt imports this module
    delta2 = torch.where(stereo, reproj.CHI2_STEREO, reproj.CHI2_MONO)
    inlier = valid
    chi2 = torch.zeros_like(inv_sigma2)
    for r in range(n_rounds):
        Tcw = pose_opt._lm_rounds(cam, Tcw, Xw, obs, stereo, inv_sigma2,
                                  inlier.to(torch.float32), r < 2, n_iters)
        e, pc, comp_w = reproj.project_residual(cam, Tcw, Xw, obs, stereo)
        chi2 = reproj.edge_chi2(e, comp_w, inv_sigma2)
        inlier = valid & (chi2 <= delta2) & (pc[..., 2] > 0)
    return Tcw, inlier, inlier.sum(dtype=torch.int32), chi2


def pose_lm(cam, Tcw, Xw, obs, inv_sigma2, stereo, valid, n_rounds: int,
            n_iters: int):
    """Kernel wrapper of `pose_lm_plain`: one launch, one cluster of 8 CTAs
    (sm_90), one edge per thread up to 2048 edges, the rest looped over."""
    if on_cpu(Xw):
        return pose_lm_plain(cam, Tcw, Xw, obs, inv_sigma2, stereo, valid,
                             n_rounds, n_iters)
    dev = Xw.device
    e = _check_edges(Xw, obs, inv_sigma2, "pose_lm")
    check(stereo, torch.bool, (e,), dev, "pose_lm stereo")
    check(valid, torch.bool, (e,), dev, "pose_lm valid")
    T = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inliers = torch.empty((e,), dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    chi2 = torch.empty((e,), dtype=torch.float32, device=dev)
    launch("pose_lm", "orb_pose_lm", dev, *_params(cam, Tcw, "pose_lm"), ptr(Xw), ptr(obs),
           ptr(inv_sigma2), ptr(stereo), ptr(valid), e, int(n_rounds), int(n_iters), ptr(T),
           ptr(inliers), ptr(n_inl), ptr(chi2))
    return T, inliers, n_inl, chi2


# ---------------------------------------------------------------------------
# K7: one normal-equation sweep
# ---------------------------------------------------------------------------

def pose_normal_eqs_plain(cam, Tcw, Xw, obs, inv_sigma2, stereo, weight_mask,
                          robust: bool):
    """H (6,6), b (6,) and err () of the normal equations at Tcw
    (`pose_opt._build_normal_eqs`); weight_mask (E,) float32."""
    from ..solvers import pose_opt
    return pose_opt._build_normal_eqs(cam, Tcw, Xw, obs, stereo, inv_sigma2,
                                      weight_mask, robust)


def pose_normal_eqs(cam, Tcw, Xw, obs, inv_sigma2, stereo, weight_mask,
                    robust: bool):
    """Kernel wrapper of `pose_normal_eqs_plain`: one launch, one cluster of
    8 CTAs (sm_90) running K6's sweep once, edges beyond 2048 looped; the
    kernel writes H whole, so the results are views of its output."""
    if on_cpu(Xw):
        return pose_normal_eqs_plain(cam, Tcw, Xw, obs, inv_sigma2, stereo,
                                     weight_mask, robust)
    dev = Xw.device
    e = _check_edges(Xw, obs, inv_sigma2, "pose_normal_eqs")
    check(stereo, torch.bool, (e,), dev, "pose_normal_eqs stereo")
    check(weight_mask, torch.float32, (e,), dev, "pose_normal_eqs weight_mask")
    out = torch.empty((43,), dtype=torch.float32, device=dev)   # H 6x6, b, err
    launch("pose_normal_eqs", "orb_pose_normal_eqs", dev,
           *_params(cam, Tcw, "pose_normal_eqs"), ptr(Xw), ptr(obs), ptr(inv_sigma2),
           ptr(stereo), ptr(weight_mask), e, int(bool(robust)), ptr(out))
    return out[:36].view(6, 6), out[36:42], out[42]
