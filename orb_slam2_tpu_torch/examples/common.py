"""Shared scaffolding of the example scripts: the run loop with per-frame timing statistics
(the median / mean report of `Examples/Monocular/mono_tum.cc:113-122`) and
the trajectory export."""
from __future__ import annotations

import time

import numpy as np

from ..utils import trajectory as traj_io


def run_sequence(sys_, frames, track_fn, save_prefix=None, realtime_fps=None):
    """frames: iterable of per-frame tuples; track_fn(sys_, frame) -> Tcw.
    Returns each call's seconds. realtime_fps is accepted for the
    reference's example scripts' signature: no sleep, the achievable
    throughput is reported."""
    times = []
    n_lost = 0
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        Tcw = track_fn(sys_, frame)
        dt = time.perf_counter() - t0
        times.append(dt)
        if Tcw is None and i > 2:
            n_lost += 1
        if i % 50 == 0:
            m = sys_.metrics[-1] if sys_.metrics else {}
            print(f"frame {i:5d}  {dt*1000:7.1f} ms  inliers={m.get('inliers','-')} "
                  f"kf={m.get('n_kf','-')} pts={m.get('n_pts','-')}")

    times_sorted = sorted(times[3:]) or times
    print("-" * 60)
    print(f"frames: {len(times)}   lost: {n_lost}")
    print(f"median tracking time: {np.median(times_sorted)*1000:.2f} ms")
    print(f"mean tracking time:   {np.mean(times_sorted)*1000:.2f} ms")

    if save_prefix:
        traj = sys_.get_trajectory()
        traj_io.save_tum(save_prefix + "_FrameTrajectory_TUM.txt", traj)
        traj_io.save_kitti(save_prefix + "_CameraTrajectory_KITTI.txt", traj)
        kf = sys_.keyframe_trajectory()
        traj_io.save_tum(save_prefix + "_KeyFrameTrajectory_TUM.txt", kf)
        print(f"trajectories saved with prefix {save_prefix}")
    return times


def run_dataset(s, ds, track_fn, prefix):
    """run_sequence over a dataset, its streams closed at the end. Returns
    the system."""
    try:
        run_sequence(s, ds, track_fn, save_prefix=prefix)
    finally:
        ds.close()
    return s
