"""Trajectory export in the TUM and KITTI formats, and ATE / RPE evaluation
(port of `orb_slam2_tpu/utils/trajectory.py`).

`System::SaveTrajectoryTUM/KITTI/SaveKeyFrameTrajectoryTUM`
(`src/System.cc:416-618`) and the TUM benchmark's evaluation scripts the
reference points to (`include/System.h:130,144`). Host code: NumPy, with the
quaternion conversions in float32 on the CPU, as the reference computes
them, so both packages write the same files.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..geometry import se3


def save_tum(path: str, traj: Sequence[Tuple[float, np.ndarray]]):
    """traj: list of (timestamp, T_wc). TUM format: t tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        for ts, T in traj:
            t = T[:3, 3]
            q = se3.to_quat(torch.as_tensor(np.asarray(T[:3, :3], np.float32))).numpy()
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_kitti(path: str, traj: Sequence[Tuple[float, np.ndarray]]):
    """KITTI format: 12 numbers per line, row-major 3x4 of T_wc."""
    with open(path, "w") as f:
        for _, T in traj:
            row = T[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_tum(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            ts, tx, ty, tz, qx, qy, qz, qw = (float(x) for x in line.split()[:8])
            T = np.eye(4)
            T[:3, :3] = se3.from_quat(torch.tensor([qx, qy, qz, qw], dtype=torch.float32)).numpy()
            T[:3, 3] = [tx, ty, tz]
            out.append((ts, T))
    return out


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity / rigid alignment est -> gt, both (N,3).
    Returns (s, R, t)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(ec.T @ gc / len(est))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    s = np.trace(np.diag(D) @ S) / ((ec ** 2).sum() / len(est)) if with_scale else 1.0
    return s, R, mu_g - s * R @ mu_e


def ate_rmse(est_traj, gt_traj, with_scale: bool = False, max_dt: float = 0.02) -> float:
    """Absolute trajectory error RMSE after timestamp association and
    Umeyama alignment (the TUM benchmark's evaluate_ate)."""
    gt_ts = np.array([ts for ts, _ in gt_traj])
    pairs = []
    for ts, T in est_traj:
        i = np.argmin(np.abs(gt_ts - ts))
        if abs(gt_ts[i] - ts) <= max_dt:
            pairs.append((T[:3, 3], gt_traj[i][1][:3, 3]))
    if len(pairs) < 2:
        return float("inf")
    est = np.array([p[0] for p in pairs])
    gt = np.array([p[1] for p in pairs])
    s, R, t = umeyama_align(est, gt, with_scale)
    est_aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est_aligned - gt) ** 2, axis=1))))


def rpe_stats(est_traj, gt_traj, delta: int = 1):
    """Relative pose error (translation) over `delta`-frame intervals, the
    KITTI-style drift metric."""
    n = min(len(est_traj), len(gt_traj))
    errs = []
    for i in range(n - delta):
        Te = np.linalg.inv(est_traj[i][1]) @ est_traj[i + delta][1]
        Tg = np.linalg.inv(gt_traj[i][1]) @ gt_traj[i + delta][1]
        errs.append(np.linalg.norm((np.linalg.inv(Tg) @ Te)[:3, 3]))
    if not errs:
        return dict(rmse=float("inf"), mean=float("inf"))
    errs = np.array(errs)
    return dict(rmse=float(np.sqrt((errs ** 2).mean())), mean=float(errs.mean()))
