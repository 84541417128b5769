"""Entry points in the style of the repository's `__graft_entry__.py`: the
single-device forward step and a multi-device dry run, for the port.

    python -m orb_slam2_tpu_torch.graft_entry [--cpu] [N]

`entry()` returns the per-frame hot path, the ORB front end (pyramid ->
FAST -> select -> orient -> BRIEF, K1-K3 on the card) at the reference's
TUM settings (640x480, 1000 features), as a callable and its inputs.
`dryrun_multichip(n)` spawns n ranks over `parallel.init_distributed` (NCCL
on the card, one GPU a rank; gloo on the CPU), runs one sharded global-BA
solve and one sharded essential-graph solve on tiny problems, and, with
n >= 2, rank 0 runs the tracking / mapping split (`SlamSystem`'s
`mapping_device`, the second GPU where there is one).
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, (img,)): fn(img) -> (xy, desc, valid) of `extractor.extract`."""
    from .ops import extractor
    from .utils.config import SlamConfig

    cfg = SlamConfig(n_features=1000, width=640, height=480)

    def fn(img):
        kps = extractor.extract(img, cfg)
        return kps.xy, kps.desc, kps.valid

    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, size=(480, 640)).astype(np.float32)).to(device)
    return fn, (img,)


def _ba_problem(n_devices, dev):
    """The tiny global BA problem of `__graft_entry__.py`: 6 of 8 camera
    slots (2 fixed), 16 points a rank seen by up to 3 cameras each."""
    from .geometry import se3
    from .geometry.camera import Camera
    from .solvers.schur_ba import BAProblem

    rng = np.random.default_rng(0)
    C, n_cams, Q, O = 8, 6, 16 * n_devices, 4
    fx = fy = 300.0
    cx, cy = 160.0, 120.0
    cam = Camera.make(fx, fy, cx, cy, bf=30.0, device=dev)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (C, 4, 4)).copy()
    for c in range(n_cams):
        xi = np.array([0.2 * c, 0.0, 0.01 * c, 0.0, 0.02 * c, 0.0], np.float32)
        poses[c] = se3.exp(torch.from_numpy(xi)).numpy()
    X = np.stack([rng.uniform(-3, 3, Q), rng.uniform(-2, 2, Q),
                  rng.uniform(5, 12, Q)], axis=-1).astype(np.float32)
    obs_cam = np.full((Q, O), -1, np.int32)
    obs_uvr = np.zeros((Q, O, 3), np.float32)
    obs_uvr[..., 2] = -1.0
    for q in range(Q):
        for o, c in enumerate(rng.choice(n_cams, size=min(O, 3), replace=False)):
            pc = poses[c, :3, :3] @ X[q] + poses[c, :3, 3]
            if pc[2] < 0.5:
                continue
            u = fx * pc[0] / pc[2] + cx
            v = fy * pc[1] / pc[2] + cy
            obs_cam[q, o] = c
            obs_uvr[q, o] = [u, v, u - 30.0 / pc[2]]
    cam_valid = np.zeros(C, bool)
    cam_valid[:n_cams] = True
    cam_fixed = np.zeros(C, bool)
    cam_fixed[:2] = True
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    prob = BAProblem(poses=t(poses), cam_valid=t(cam_valid), cam_fixed=t(cam_fixed),
                     points=t(X), pt_valid=torch.ones(Q, dtype=torch.bool, device=dev),
                     obs_cam=t(obs_cam), obs_uvr=t(obs_uvr),
                     obs_level=torch.zeros((Q, O), dtype=torch.int32, device=dev))
    return cam, prob, poses, n_cams


def _pose_graph(poses, n_cams, n_devices, dev):
    """A chain of the BA problem's cameras, its edge axis padded to the mesh."""
    from .geometry.sim3 import Sim3
    from .solvers.pose_graph import PoseGraphProblem

    K, E = 8, 8 * max(n_devices, 2)
    nodesT = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    nodesT[:n_cams] = poses[:n_cams]
    ei, ej = np.zeros(E, np.int32), np.zeros(E, np.int32)
    ev = np.zeros(E, bool)
    mR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    mt = np.zeros((E, 3), np.float32)
    for k in range(n_cams - 1):
        rel = nodesT[k + 1] @ np.linalg.inv(nodesT[k])
        ei[k], ej[k], ev[k] = k, k + 1, True
        mR[k], mt[k] = rel[:3, :3], rel[:3, 3]
    nv = np.zeros(K, bool)
    nv[:n_cams] = True
    nf = np.zeros(K, bool)
    nf[0] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=dev)  # noqa: E731
    return PoseGraphProblem(
        nodes=Sim3(t(nodesT[:, :3, :3]), t(nodesT[:, :3, 3]), ones(K)),
        node_valid=t(nv), node_fixed=t(nf), edge_i=t(ei), edge_j=t(ej),
        edge_meas=Sim3(t(mR), t(mt), ones(E)), edge_valid=t(ev))


def _split_lap(dev, mapping_device):
    """The full SlamSystem streaming at depth 2 with every keyframe's
    mapping pass on `mapping_device`, over 24 frames of a small plate world."""
    from .pipeline.system import SlamSystem
    from .utils.config import SENSOR_RGBD, SlamConfig
    from .utils.synthetic import PlateWorld, lateral_trajectory

    fx = 130.0
    cfg = SlamConfig(fx=fx, fy=fx, cx=80.0, cy=60.0, width=160, height=120, n_features=250,
                     bf=fx * 0.25, sensor=SENSOR_RGBD, fps=10.0, th_depth=40.0,
                     max_keyframes=16, max_map_points=1 << 11, ba_local_cams=8,
                     ba_fixed_cams=8, ba_max_points=1 << 9, ba_max_obs=6,
                     max_local_keyframes=8, max_local_points=1 << 10)
    world = PlateWorld(fx, fx, 80.0, 60.0, 160, 120, z0=4.0)
    s = SlamSystem(cfg, enable_loop_closing=False, pipeline_depth=2,
                   mapping_device=mapping_device, device=dev)
    for i, T in enumerate(lateral_trajectory(24, step=0.12)):
        img, depth = world.render_with_depth(T)
        s.track_rgbd(img, depth, i / cfg.fps)
    s.flush()
    assert int(s.m.n_keyframes) >= 2, "split pipeline inserted no keyframe"
    assert len(s.get_trajectory()) >= 20
    return s


def _dryrun_rank(rank, n_devices, init_file, device):
    from .parallel import distributed, sharded_ba, sharded_pose_graph

    dev = torch.device(device, rank) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:                       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    mesh = distributed.init_distributed(init_method=f"file://{init_file}",
                                        world_size=n_devices, rank=rank, device=device)
    try:
        cam, prob, poses, n_cams = _ba_problem(n_devices, dev)
        level_sigma2 = [1.2 ** (2 * i) for i in range(8)]
        res = sharded_ba.solve_global_ba_sharded(cam, prob, level_sigma2, mesh, n_iters=2)
        assert torch.isfinite(res.poses).all() and torch.isfinite(res.points).all()
        out = sharded_pose_graph.optimize_pose_graph_sharded(
            _pose_graph(poses, n_cams, n_devices, dev), mesh, n_iters=2, fix_scale=True)
        assert torch.isfinite(out.t).all()
        if n_devices >= 2 and rank == 0:
            second = (torch.device("cuda", 1) if dev.type == "cuda" and
                      torch.cuda.device_count() > 1 else dev)
            _split_lap(dev, second)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Spawn n_devices ranks (one GPU each on the card) and run one sharded
    global-BA solve and one sharded essential-graph solve on every rank;
    with n_devices >= 2 rank 0 also runs the tracking / mapping split.
    Raises if a rank fails."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dryrun_rank, args=(n_devices, os.path.join(tmp, "init"), device),
                 nprocs=n_devices, join=True)
    print(f"dryrun_multichip({n_devices}): sharded global BA + sharded essential graph"
          f"{' + tracking / mapping split' if n_devices >= 2 else ''} over {n_devices} "
          f"ranks ({device})")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    dev = "cpu" if "--cpu" in sys.argv else "cuda"
    fn, inputs = entry(dev)
    xy, desc, valid = fn(*inputs)
    print(f"entry(): {int(valid.sum())} keypoints, descriptors {tuple(desc.shape)}")
    n = int(args[0]) if args else (torch.cuda.device_count() if dev == "cuda" else 2)
    dryrun_multichip(n, dev)
