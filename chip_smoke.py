#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: the quickest proof that the port
builds and runs its main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its result; any failure exits non-zero):
1. device    — needs CUDA; prints nvidia-smi's name and power limit;
2. build     — compiles orb_slam2_tpu_torch/csrc/*.cu with nvcc for sm_90a,
               one nvcc per source, all at once; prints ptxas registers and
               spills;
3. parity    — each kernel against its plain-PyTorch twin on the card:
               K1-K3 at every pyramid level of a 640x480 frame and K4/K5
               bit-exact; K6/K7 within tolerance; on the inputs the main
               path hands them on real frames, and on synthetic ones;
4. main path — PlateWorld 640x480, 1000 features, 8 levels (the reference
               bench's configuration), the bench loop's first 16 poses:
               frame 0 through `make_frame_rgbd` and the RGB-D
               initialization (`insert_keyframe(all_depth=True)`), frames
               1-15 through `full_tracking_step_from_images`, a keyframe
               forced on every 3rd frame (no local mapping: not ported yet).
               Checked: keypoints, ok flags, local-map inliers and
               translation error against the JAX reference's recorded
               numbers, launch counts against the frames' branches, host
               syncs, and the whole sequence against the twin path;
5. timing    — median ms per frame of the front end and of the tracking
               step on the kernel path and the twin path, device time and
               idle share, and each kernel against its twin at the main
               path's shapes.
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

from orb_slam2_tpu_torch.geometry import se3
from orb_slam2_tpu_torch.geometry.camera import Camera
from orb_slam2_tpu_torch.mapstate import map as mapstate
from orb_slam2_tpu_torch.ops import _build, launch
from orb_slam2_tpu_torch.ops import cuda_extract as ce
from orb_slam2_tpu_torch.ops import cuda_match as cm
from orb_slam2_tpu_torch.ops import cuda_pose as cp
from orb_slam2_tpu_torch.ops import extractor as ex
from orb_slam2_tpu_torch.ops import orient_brief, select
from orb_slam2_tpu_torch.pipeline import mapping_ops, tracking_step
from orb_slam2_tpu_torch.pipeline.frame import make_frame_rgbd
from orb_slam2_tpu_torch.utils.config import SlamConfig, SENSOR_RGBD
from orb_slam2_tpu_torch.utils.synthetic import PlateWorld, loop_trajectory

# What the reference package (orb_slam2_tpu, XLA path, use_pallas=0) gives on
# the frames below, rendered and quantized exactly as here, with the same
# initialization, forced keyframe rule and state chaining as main_path_phase.
# Measured with jax 0.9.0 on the CPU.
REFERENCE_VALID = [1000] * 12          # valid keypoints, frames 0-11
REFERENCE_LOCAL_INLIERS = [           # local-map inliers, frames 1-15
    586, 598, 520, 675, 647, 551, 669, 574, 519, 681, 589, 506, 642, 568, 506]
REFERENCE_TRANS_ERR_M = [             # camera-centre error vs ground truth (m), frames 1-15
    0.00326, 0.00239, 0.00328, 0.0034, 0.00461, 0.00322, 0.00761, 0.00133, 0.00228,
    0.00441, 0.00277, 0.00357, 0.00397, 0.00183, 0.00208]
KEYPOINT_FLOOR = 0.95       # fraction of REFERENCE_VALID each frame must reach
DEPTH_FLOOR = 0.5           # fraction of valid keypoints that must have depth
INLIER_FLOOR = 0.90         # fraction of the reference's local-map inliers
N_FRONT = 12                # frames of the front-end checks
N_FRAMES = 16               # frames of the tracking sequence
KF_EVERY = 3                # a keyframe forced on every 3rd frame (bench.py:118-124)
POSE_TOL = 1e-4             # K6 against its twin, per entry of Tcw
FX, W, H = 517.3, 640, 480
SOURCES = {   # kernel: (CUDA source, the TPU kernel's pallas_call it replaces)
    "pyramid": ("orb_slam2_tpu_torch/csrc/pyramid.cu",
                "orb_slam2_tpu/ops/pallas_extract.py:263"),
    "dense_stage": ("orb_slam2_tpu_torch/csrc/dense_stage.cu",
                    "orb_slam2_tpu/ops/pallas_extract.py:157"),
    "brief": ("orb_slam2_tpu_torch/csrc/brief.cu",
              "orb_slam2_tpu/ops/pallas_extract.py:360"),
    "best_two": ("orb_slam2_tpu_torch/csrc/best_two.cu",
                 "orb_slam2_tpu/ops/pallas_kernels.py:74"),
    "proj_match": ("orb_slam2_tpu_torch/csrc/proj_match.cu",
                   "orb_slam2_tpu/ops/pallas_kernels.py:174"),
    "pose_lm": ("orb_slam2_tpu_torch/csrc/pose_lm.cu",
                "orb_slam2_tpu/ops/pallas_kernels.py:807"),
    "pose_normal_eqs": ("orb_slam2_tpu_torch/csrc/pose_lm.cu",
                        "orb_slam2_tpu/ops/pallas_kernels.py:301"),
}
WRAPPERS = {  # kernel: (module, wrapper, twin)
    "pyramid": (ce, "pyramid", ce.pyramid_plain),
    "dense_stage": (ce, "dense_stage", ce.dense_stage_plain),
    "brief": (ce, "brief", ce.brief_plain),
    "best_two": (cm, "masked_best_two", cm.masked_best_two_plain),
    "proj_match": (cm, "projection_best_two", cm.projection_best_two_plain),
    "pose_lm": (cp, "pose_lm", cp.pose_lm_plain),
    "pose_normal_eqs": (cp, "pose_normal_eqs", cp.pose_normal_eqs_plain),
}


def log(msg):
    print(msg, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke runs only on a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def build_phase():
    path, seconds, report = _build.build()
    _build.library()
    log(f"[build] {os.path.relpath(path)}: {len(_build._sources())} sources compiled "
        f"in {seconds:.2f} s (0 = reused)")
    for line in report.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line \
                or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def bench_config():
    return SlamConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                      bf=FX * 0.25, sensor=SENSOR_RGBD, fps=30.0, th_depth=40.0,
                      n_features=1000, max_keyframes=128, max_map_points=1 << 14)


def render_frames():
    """The reference bench's circle (181 frames, radius 3, spiral 0.12): its
    first N_FRAMES poses (camera-to-world) and their renders, gray quantized
    to uint8 as a camera delivers it."""
    world = PlateWorld(FX, FX, W / 2, H / 2, W, H, z0=5.0)
    poses = loop_trajectory(181, radius=3.0, overshoot=0.5, spiral=0.12)[:N_FRAMES]
    frames = []
    for T in poses:
        gray, depth = world.render_with_depth(T)
        frames.append((np.clip(np.round(gray), 0, 255).astype(np.uint8), depth))
    return poses, frames


@contextmanager
def twins():
    """Route every wrapper to its plain twin (the twin path)."""
    saved = {k: getattr(mod, name) for k, (mod, name, _) in WRAPPERS.items()}
    for mod, name, twin in WRAPPERS.values():
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for k, (mod, name, _) in WRAPPERS.items():
            setattr(mod, name, saved[k])


@contextmanager
def recording(calls):
    """Record the arguments the main path hands K4, K5 and K6 (by kernel)."""
    saved = {k: getattr(WRAPPERS[k][0], WRAPPERS[k][1])
             for k in ("best_two", "proj_match", "pose_lm")}

    def recorder(k):
        def call(*args):
            calls.setdefault(k, []).append(args)
            return saved[k](*args)
        return call

    for k in saved:
        setattr(WRAPPERS[k][0], WRAPPERS[k][1], recorder(k))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(WRAPPERS[k][0], WRAPPERS[k][1], fn)


def _region(h, w):
    e = ex.EDGE_THRESHOLD
    return e - 3, w - e + 3, e - 3, h - e + 3


def kernel_inputs(cfg, img, dev):
    """The extractor and, per level, what the main path hands the dense
    stage and BRIEF: (level image, blur, ys, xs, dx, dy), built by the twins."""
    ext = ex.extractor_for(cfg, H, W, dev)
    pyr = ce.pyramid_plain(img, ext.pyramid_taps())
    levels = []
    for lvl, budget in enumerate(ext.budgets):
        region = _region(*pyr[lvl].shape)
        s, hi, blur = ce.dense_stage_plain(pyr[lvl], cfg.ini_th_fast,
                                           cfg.min_th_fast, *region)
        ys, xs, _, valid = select.select_uniform(
            ce.candidates_from_dense(s, hi, *region), budget, *region)
        ys = torch.where(valid, ys, torch.full_like(ys, ex.EDGE_THRESHOLD))
        xs = torch.where(valid, xs, torch.full_like(xs, ex.EDGE_THRESHOLD))
        ang = orient_brief.ic_angles(pyr[lvl], ys, xs)
        dx, dy = orient_brief.rotated_offsets(ang, ext.brief_points)
        levels.append((pyr[lvl], blur, ys, xs, dx, dy))
    return ext, pyr, levels


def _max_abs(a, b):
    """Max |a - b| over two tensors, equal values (infinities too) as 0."""
    a, b = a.double(), b.double()
    return float(torch.where(a == b, torch.zeros_like(a), (a - b).abs()).max())


def _require_equal(what, a, b):
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: kernel differs from its twin "
                             f"(max |diff| {_max_abs(a, b):.3g})")


def front_parity(cfg, frames, dev, errs):
    img = torch.from_numpy(frames[0][0]).to(dev).to(torch.float32)
    ext, pyr_twin, levels = kernel_inputs(cfg, img, dev)
    pyr = ce.pyramid(img, ext.pyramid_taps())
    torch.cuda.synchronize()
    for lvl, (a, b) in enumerate(zip(pyr, pyr_twin)):
        errs["pyramid"] = max(errs["pyramid"], _max_abs(a, b))
        _require_equal(f"pyramid level {lvl}", a, b)
    log(f"[parity] pyramid: {len(pyr) - 1} levels bit-exact")
    for lvl, (lv, blur, ys, xs, dx, dy) in enumerate(levels):
        args = (lv, cfg.ini_th_fast, cfg.min_th_fast, *_region(*lv.shape))
        got, want = ce.dense_stage(*args), ce.dense_stage_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("score_nms", "hi", "blur"), got, want):
            errs["dense_stage"] = max(errs["dense_stage"], _max_abs(a, b))
            _require_equal(f"dense_stage level {lvl} {name}", a, b)
        got, want = ce.brief(blur, ys, xs, dx, dy), ce.brief_plain(blur, ys, xs, dx, dy)
        torch.cuda.synchronize()
        errs["brief"] = max(errs["brief"], _max_abs(got, want))
        _require_equal(f"brief level {lvl}", got, want)
        log(f"[parity] level {lvl} {lv.shape[0]}x{lv.shape[1]}: dense_stage "
            f"bit-exact, brief {ys.shape[0]} keypoints bit-exact")


def _random_desc(rng, n, dev):
    return torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
                            .view(np.int32)).to(dev)


def _synthetic_pose_edges(rng, n, stereo, dev):
    """A pose problem with known answer: 20 % of the observations moved by
    20-80 px; returns pose_lm's arguments."""
    Xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 15, n)],
                  -1).astype(np.float32)
    T_true = se3.exp(torch.tensor([0.1, -0.05, 0.08, 0.02, -0.03, 0.01])).numpy()
    pc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
    u = 500.0 * pc[:, 0] / pc[:, 2] + 320.0
    v = 500.0 * pc[:, 1] / pc[:, 2] + 240.0
    ur = np.where(rng.random(n) < 0.8, u - 40.0 / pc[:, 2], -1.0) if stereo else -np.ones(n)
    obs = np.stack([u, v, ur], -1).astype(np.float32)
    k = n // 5
    obs[:k, :2] += (rng.uniform(20, 80, (k, 2)) * rng.choice([-1, 1], (k, 2))).astype(np.float32)
    obs[k:, :2] += rng.normal(0, 0.5, (n - k, 2)).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 8, n)).astype(np.float32)
    cam = Camera.make(500.0, 500.0, 320.0, 240.0, bf=40.0 if stereo else 0.0, device=dev)
    T0 = se3.orthonormalize(se3.retract(torch.from_numpy(T_true),
                                        torch.tensor([0.1, -0.08, 0.05, 0.03, -0.02, 0.04])))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (cam, T0.to(dev), t(Xw), t(obs), t(inv_s2), t(obs[:, 2] >= 0),
            torch.ones(n, dtype=torch.bool, device=dev))


def match_pose_parity(recorded, dev, errs):
    """K4-K7 against their twins on the main path's own inputs and on
    synthetic ones (random masks with rows masked everywhere, P=8192 local
    maps, stereo and mono pose problems with 20 % outliers, and the
    degenerate pose problems of `degenerate_pose_parity`)."""
    rng = np.random.default_rng(0)
    cases = [("motion-model search, frame 1", recorded["best_two"][0])]
    for n, m, density in ((2048, 2048, 0.01), (777, 2048, 0.3)):
        mask = torch.from_numpy(rng.random((n, m)) < density).to(dev)
        mask[::11] = False
        cases.append((f"random {n}x{m}, rows masked everywhere",
                      (_random_desc(rng, n, dev), _random_desc(rng, m, dev), mask)))
    for what, args in cases:
        got, want = cm.masked_best_two(*args), cm.masked_best_two_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "idx", "second"), got, want):
            _require_equal(f"best_two {what} {name}", a, b)
        log(f"[parity] best_two {what} ({args[0].shape[0]}x{args[1].shape[0]}, "
            f"{int(args[2].sum())} candidates): bit-exact")

    rec = recorded["proj_match"][0]
    uv, radius, pred, p_ur, p_valid, p_desc, kp_xy, kp_level, kp_ur, kp_valid, kp_desc = rec
    P = 8192
    src = torch.from_numpy(rng.integers(0, kp_xy.shape[0], P)).to(dev)
    synth = ((kp_xy[src] + torch.randn(P, 2, device=dev) * 5).contiguous(),
             torch.full((P,), 12.0, device=dev), kp_level[src].contiguous(),
             kp_ur[src].contiguous(), torch.ones(P, dtype=torch.bool, device=dev),
             (kp_desc[src] ^ (_random_desc(rng, P, dev) & 0x00110011)).contiguous(),
             kp_xy, kp_level, kp_ur, kp_valid, kp_desc)
    for what, args in (("local map, frame 1", rec), ("synthetic P=8192", synth)):
        got, want = cm.projection_best_two(*args), cm.projection_best_two_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "idx", "second"), got, want):
            _require_equal(f"proj_match {what} {name}", a, b)
        log(f"[parity] proj_match {what} ({args[0].shape[0]} points x "
            f"{args[6].shape[0]} keypoints, {int((got[0] < cm.BIG).sum())} with a "
            f"candidate): bit-exact")

    pose_cases = [(f"frame 1 call {i}", a) for i, a in enumerate(recorded["pose_lm"][:2])]
    pose_cases += [("synthetic stereo, 20 % outliers", _synthetic_pose_edges(rng, 2048, True, dev) + (4, 10)),
                   ("synthetic mono, 20 % outliers", _synthetic_pose_edges(rng, 2048, False, dev) + (4, 10))]
    for what, args in pose_cases:
        T, inl, n_inl, chi2 = cp.pose_lm(*args)
        Tp, inl_p, n_p, chi2_p = cp.pose_lm_plain(*args)
        torch.cuda.synchronize()
        err = float((T - Tp).abs().max())
        errs["pose_lm"] = max(errs["pose_lm"], err)
        d2 = torch.where(args[5], 7.815, 5.991)
        near = (chi2_p - d2).abs() <= 1e-3 * d2
        off = int(((inl != inl_p) & ~near).sum())
        if err > POSE_TOL or off or int(n_inl) != int(inl.sum()):
            raise AssertionError(f"pose_lm {what}: Tcw max diff {err:.3g} (tol {POSE_TOL}), "
                                 f"{off} inliers differ away from the threshold")
        log(f"[parity] pose_lm {what} (E={args[2].shape[0]}): Tcw max diff {err:.3g}, "
            f"inliers {int(n_inl)} vs twin {int(n_p)}")

    for what, args in pose_cases + degenerate_pose_parity(rng, dev):
        cam, T0, Xw, obs, inv_s2, st, valid = args[:7]
        mask = valid.to(torch.float32)
        for robust in (True, False):
            H_, b, e = cp.pose_normal_eqs(cam, T0, Xw, obs, inv_s2, st, mask, robust)
            Hp, bp, ep = cp.pose_normal_eqs_plain(cam, T0, Xw, obs, inv_s2, st, mask, robust)
            torch.cuda.synchronize()
            errs["pose_normal_eqs"] = max(errs["pose_normal_eqs"], _max_abs(H_, Hp),
                                          _max_abs(b, bp))
            torch.testing.assert_close(H_, Hp, rtol=3e-4, atol=2e-3)
            torch.testing.assert_close(b, bp, rtol=3e-4, atol=2e-2)
            torch.testing.assert_close(e, ep, rtol=3e-4, atol=0.0)
            log(f"[parity] pose_normal_eqs {what} robust={robust}: H max diff "
                f"{_max_abs(H_, Hp):.3g} (|H| up to {float(Hp.abs().max()):.3g}), b "
                f"{_max_abs(b, bp):.3g}, err {_max_abs(e, ep):.3g}")


def degenerate_pose_parity(rng, dev):
    """K6 and K7 where the solve degenerates. Rank-deficient: 2 valid mono
    edges of 2048, so H has rank 4 and the pose is not unique; kernel and
    twin may part along the null space and are held to a finite pose, the
    same inliers and the same residual error. Poisoned: one edge with a NaN
    world point, so every sweep's err is NaN and every step is rejected (the
    reference's NaN * 0 = NaN), and the pose stays at its seed on both sides.
    K7 on the poisoned set and at a NaN pose (what a NaN step retracts to)
    gives NaN err on both sides. Returns the rank-deficient set, for K7 at
    its seed."""
    rank_def = _synthetic_pose_edges(rng, 2048, False, dev)
    valid = torch.zeros_like(rank_def[6])
    valid[[1000, 1500]] = True
    rank_def = rank_def[:6] + (valid,)
    poisoned = _synthetic_pose_edges(rng, 2048, True, dev)
    poisoned[2][1000] = float("nan")
    for what, args in (("rank-deficient, 2 valid edges", rank_def),
                       ("poisoned, a NaN world point", poisoned)):
        T, inl, n_inl, chi2 = cp.pose_lm(*args, 4, 10)
        Tp, inl_p, n_p, chi2_p = cp.pose_lm_plain(*args, 4, 10)
        torch.cuda.synchronize()
        err, err_p = float(chi2[inl].sum()), float(chi2_p[inl_p].sum())   # inliers' error
        if not bool(torch.isfinite(T).all()) or not torch.equal(inl, inl_p) \
                or abs(err - err_p) > 1e-4:
            raise AssertionError(f"pose_lm {what}: Tcw finite {bool(torch.isfinite(T).all())}, "
                                 f"inliers {int(n_inl)} vs twin {int(n_p)}, error "
                                 f"{err:.3g} vs twin {err_p:.3g}")
        if what.startswith("poisoned") and not (torch.equal(T[:3], args[1][:3])
                                                and torch.equal(Tp[:3], args[1][:3])):
            raise AssertionError(f"pose_lm {what}: a step was accepted "
                                 f"(|T - T0| {float((T - args[1]).abs().max()):.3g})")
        log(f"[parity] pose_lm {what}: Tcw max diff {float((T - Tp).abs().max()):.3g} "
            f"(seed moved {float((T - args[1]).abs().max()):.3g}), inliers {int(n_inl)} vs "
            f"twin {int(n_p)}, error {err:.3g} vs twin {err_p:.3g}")
    cam, T0, Xw, obs, inv_s2, st, valid = poisoned
    mask = valid.to(torch.float32)
    nan_pose = torch.full_like(T0, float("nan"))
    for what, T in (("the poisoned set", T0), ("a NaN pose", nan_pose)):
        for robust in (True, False):
            H_, b, e = cp.pose_normal_eqs(cam, T, Xw, obs, inv_s2, st, mask, robust)
            Hp, bp, ep = cp.pose_normal_eqs_plain(cam, T, Xw, obs, inv_s2, st, mask, robust)
            torch.cuda.synchronize()
            if not (bool(e.isnan()) and bool(ep.isnan())):
                raise AssertionError(f"pose_normal_eqs on {what}: err {float(e)}, twin "
                                     f"{float(ep)} (both must be NaN)")
            torch.testing.assert_close(H_, Hp, equal_nan=True, rtol=3e-4, atol=2e-3)
            torch.testing.assert_close(b, bp, equal_nan=True, rtol=3e-4, atol=2e-2)
        log(f"[parity] pose_normal_eqs on {what}: err NaN, as its twin's")
    return [("rank-deficient, 2 valid edges", rank_def)]


def _last_points(cfg, m, f, Tcw, matched):
    """The next frame's 3D points after a keyframe (SlamSystem._set_last,
    orb_slam2_tpu/pipeline/system.py:354-380): the bound map points and the
    close-depth points of the unbound keypoints."""
    P = m.capacity_pt
    idx = torch.clamp(matched, 0, P - 1).long()
    has = (matched >= 0) & m.pt_valid[idx]
    pw = se3.apply(se3.inverse(Tcw), mapping_ops.unproject(cfg, f))
    temporal = (f.depth > 0) & (f.depth < cfg.th_depth * cfg.baseline) & ~has & f.valid
    return torch.where(temporal[:, None], pw, m.pt_pos[idx]), has | temporal


def run_sequence(cfg, uploads, count_syncs=False):
    """Initialization on frame 0, then frames 1.. through the tracking step
    with a keyframe forced on every KF_EVERY-th frame, chaining the state as
    SlamSystem._set_last/_track_frame do. Returns the step results, the
    inputs of each step (for re-timing), the host syncs per frame and the
    source lines that synced (with count_syncs)."""
    dev = uploads[0][0].device
    N = cfg.max_keypoints
    eye = torch.eye(4, device=dev)
    f0 = make_frame_rgbd(*uploads[0], cfg)
    m = mapstate.empty(cfg.max_keyframes, cfg.max_map_points, N, device=dev)
    m, kf = mapping_ops.insert_keyframe(cfg, m, f0, eye,
                                        torch.full((N,), -1, dtype=torch.int32, device=dev),
                                        0, 0.0, all_depth=True)
    lm = mapstate.take(m.kf_obs, kf)
    lp, lpv = _last_points(cfg, m, f0, eye, lm)
    last, T_last, vel, has_vel, ref = f0, eye, eye, False, kf
    results, inputs, syncs, where = [], [], [], Counter()
    for i in range(1, len(uploads)):
        args = (cfg, m, uploads[i], last, lp, lpv, lm, T_last, vel, has_vel, ref, 30, "rgbd")
        inputs.append(args)
        with warnings.catch_warnings(record=True) as caught:
            if count_syncs:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            try:
                r = tracking_step.full_tracking_step_from_images(*args)
                m = r.m
                if i % KF_EVERY == 0:
                    m, kf = mapping_ops.insert_keyframe(cfg, m, r.frame, r.Tcw, r.matched_pt,
                                                        i, i / cfg.fps)
                    lm = mapstate.take(m.kf_obs, kf)
                    lp, lpv = _last_points(cfg, m, r.frame, r.Tcw, lm)
                    ref = kf
                else:
                    lm, lp, lpv, ref = r.matched_pt, r.next_pts, r.next_pts_valid, r.ref_kf
            finally:
                torch.cuda.set_sync_debug_mode(0)
        hits = [w for w in caught if "synchroniz" in str(w.message)]
        syncs.append(len(hits))
        where.update(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in hits)
        last, T_last, vel, has_vel = r.frame, r.Tcw, r.next_vel, True
        results.append(r)
    return results, inputs, syncs, where


def _centre_error(Tcw, T_wc0, T_wci):
    c_est = np.linalg.inv(Tcw.cpu().double().numpy())[:3, 3]
    return float(np.linalg.norm(c_est - (np.linalg.inv(T_wc0) @ T_wci)[:3, 3]))


def main_path_phase(cfg, poses, frames, dev):
    uploads = [(torch.from_numpy(g).to(dev), torch.from_numpy(d).to(dev))
               for g, d in frames]
    torch.cuda.synchronize()

    # front end alone: K1-K3
    launch.reset_launches()
    out = [make_frame_rgbd(g, d, cfg) for g, d in uploads[:N_FRONT]]
    torch.cuda.synchronize()
    front_launches = dict(launch.LAUNCHES)
    n_levels = cfg.n_levels
    per_frame = {"pyramid": n_levels - 1, "dense_stage": n_levels,
                 "brief": sum(1 for b in cfg.features_per_level() if b > 0)}
    expected = {**dict.fromkeys(launch.LAUNCHES, 0),
                **{k: v * N_FRONT for k, v in per_frame.items()}}
    log(f"[main] front end, {N_FRONT} frames: launches {front_launches}")
    if front_launches != expected:
        raise AssertionError(f"front-end launches {front_launches} != expected {expected}")
    for i, f in enumerate(out):
        for name, t in f._asdict().items():
            if t.shape[0] != cfg.max_keypoints:
                raise AssertionError(f"frame {i} {name}: shape {tuple(t.shape)}")
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise AssertionError(f"frame {i} {name}: non-finite values")
        nv, nd = int(f.valid.sum()), int(((f.depth > 0) & f.valid).sum())
        ang = f.angle[f.valid]
        if nv < KEYPOINT_FLOOR * REFERENCE_VALID[i] or nd < DEPTH_FLOOR * nv or \
                bool(((ang < 0) | (ang >= 360)).any()):
            raise AssertionError(f"frame {i}: {nv} valid keypoints (reference "
                                 f"{REFERENCE_VALID[i]}), {nd} with depth")
    log(f"[main] front end: valid keypoints {[int(f.valid.sum()) for f in out]} "
        f"(reference {REFERENCE_VALID[0]} each), with depth "
        f"{[int(((f.depth > 0) & f.valid).sum()) for f in out]}")

    # the tracking sequence: K1-K6
    log(f"[main] tracking {N_FRAMES - 1} frames after the RGB-D initialization, a keyframe "
        f"forced on every {KF_EVERY}rd frame; no local mapping (culling, triangulation, "
        f"fusion, local BA): that is the next slice")
    tracking_step.HOST_READS["count"] = 0
    launch.reset_launches()
    results, inputs, syncs, where = run_sequence(cfg, uploads, count_syncs=True)
    torch.cuda.synchronize()
    launches = dict(launch.LAUNCHES)
    reads = tracking_step.HOST_READS["count"]
    sc = torch.stack([r.scalars for r in results]).cpu().numpy()
    n_track = len(results)
    expected = {k: v * N_FRAMES for k, v in per_frame.items()}
    expected.update(best_two=int(n_track + sc[:, 10].sum() + sc[:, 7].sum()),
                    proj_match=n_track, pose_lm=int(2 * n_track + sc[:, 7].sum()),
                    pose_normal_eqs=0)
    log(f"[main] launches {launches}, expected from the frames' branches {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != expected {expected}")
    log(f"[main] host syncs per tracked frame (sync debug mode, insertion included): "
        f"{syncs}; the step's own reads {reads} ({reads / n_track:.1f} per frame); "
        f"by source line over the {n_track} frames: {dict(where.most_common())}")

    rows = []
    for i, r in enumerate(results, start=1):
        ok, n_local = bool(sc[i - 1, 0]), int(sc[i - 1, 3])
        terr = _centre_error(r.Tcw, poses[0], poses[i])
        if not bool(torch.isfinite(r.Tcw).all()) or not ok:
            raise AssertionError(f"frame {i}: tracking failed (scalars {sc[i - 1].tolist()})")
        ref_inl, ref_err = REFERENCE_LOCAL_INLIERS[i - 1], REFERENCE_TRANS_ERR_M[i - 1]
        if n_local < INLIER_FLOOR * ref_inl or terr > 2 * ref_err + 0.01:
            raise AssertionError(f"frame {i}: {n_local} local-map inliers (reference "
                                 f"{ref_inl}), translation error {terr:.4f} m (reference "
                                 f"{ref_err:.4f} m)")
        rows.append((i, n_local, ref_inl, terr, ref_err))
        log(f"[main] frame {i}: ok, motion model {sc[i - 1, 1]} matches / {sc[i - 1, 2]} "
            f"inliers, local map {n_local} inliers (reference {ref_inl}), fallback "
            f"{sc[i - 1, 7]}, retry {sc[i - 1, 10]}, translation error {terr * 100:.2f} cm "
            f"(reference {ref_err * 100:.2f} cm)")
    m = results[-1].m
    log(f"[main] the map frame {N_FRAMES - 1} was tracked against: {int(m.n_keyframes)} "
        f"keyframes, {int(m.n_points)} points")

    with twins():
        launch.reset_launches()
        twin_results = run_sequence(cfg, uploads)[0]
        torch.cuda.synchronize()
        if any(launch.LAUNCHES.values()):
            raise AssertionError(f"the twin path launched kernels: {launch.LAUNCHES}")
    worst_T, worst_same = 0.0, 1.0
    for i, (a, b) in enumerate(zip(results, twin_results), start=1):
        dT = float((a.Tcw - b.Tcw).abs().max())
        bound = (a.matched_pt >= 0) | (b.matched_pt >= 0)
        same = float((a.matched_pt == b.matched_pt)[bound].float().mean())
        worst_T, worst_same = max(worst_T, dT), min(worst_same, same)
        if dT > 1e-3 or same < 0.99:
            raise AssertionError(f"frame {i}: kernel path vs twin path: Tcw max diff {dT:.3g}, "
                                 f"{same:.4f} of the matches the same")
    log(f"[main] kernel path vs twin path on the card, {n_track} frames: Tcw max diff "
        f"{worst_T:.3g}, >= {worst_same:.4f} of the matched keypoints bound to the same "
        f"map point")
    return launches, uploads, inputs, results, syncs, reads / n_track


def _wall_ms(fn, items, rounds=1):
    times = []
    for _ in range(rounds):
        for item in items:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(item)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def _event_ms(fn, reps=50):
    """Time per call of back-to-back calls, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_ms(fn, reps=20):
    """Device time per call: the GPU activity the profiler records over
    `reps` calls (host overhead excluded), divided by reps."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / reps


def _paths_ms(name, fn, items, card):
    """Wall ms per item on the kernel path and the twin path in turns
    (k, t, t, k), then device ms and the idle share of one item."""
    _wall_ms(fn, items[:2])
    with twins():
        _wall_ms(fn, items[:2])
    k_ms = _wall_ms(fn, items)
    with twins():
        t_ms = _wall_ms(fn, items, 2)
    k_ms += _wall_ms(fn, items)
    res = {"kernel_ms": statistics.median(k_ms), "twin_ms": statistics.median(t_ms)}
    res["kernel_device_ms"] = _device_ms(lambda: fn(items[0]), reps=5)
    with twins():
        res["twin_device_ms"] = _device_ms(lambda: fn(items[0]), reps=5)
    log(f"[timing] {card}: {name} median {res['kernel_ms']:.3f} ms/frame kernel path, "
        f"{res['twin_ms']:.3f} ms/frame twin path ({len(k_ms)} frames each); device "
        f"{res['kernel_device_ms']:.3f} ms/frame kernel path "
        f"({1 - res['kernel_device_ms'] / res['kernel_ms']:.1%} of the frame idle), "
        f"{res['twin_device_ms']:.3f} ms/frame twin path "
        f"({1 - res['twin_device_ms'] / res['twin_ms']:.1%} idle)")
    return res


def timing_phase(cfg, frames, uploads, inputs, results, recorded, syncs, reads, dev, card):
    front = _paths_ms("make_frame_rgbd 640x480/1000", lambda gd: make_frame_rgbd(*gd, cfg),
                      uploads[:6], card)
    step = _paths_ms("tracking step (full_tracking_step_from_images, front end included)",
                     lambda a: tracking_step.full_tracking_step_from_images(*a),
                     inputs[:6], card)
    # the same steps on the frames already extracted: the tracking alone
    given = [a[:2] + (r.frame,) + a[3:12] for a, r in zip(inputs, results)]
    track = _paths_ms("tracking alone (full_tracking_step, frame given)",
                      lambda a: tracking_step.full_tracking_step(*a), given[:6], card)
    launch.reset_launches()
    for a in inputs:
        tracking_step.full_tracking_step_from_images(*a)
    torch.cuda.synchronize()
    n_launch = sum(launch.LAUNCHES.values()) / len(inputs)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracking_step.full_tracking_step_from_images(*inputs[0])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    all_launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    log(f"[timing] {card}: device time of one tracking step by kernel (profiler, frame 1): "
        + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                    for e in top))
    step.update(hand_kernel_launches_per_frame=n_launch,
                device_launches_per_frame=all_launches,
                host_syncs_per_frame=statistics.mean(syncs), step_reads_per_frame=reads)
    log(f"[timing] {card}: tracking step: {n_launch:.1f} hand-kernel launches per frame, "
        f"{all_launches} device activities in all (profiler, frame 1), "
        f"{step['host_syncs_per_frame']:.2f} host syncs per frame")
    log(f"[result] {card}: " + json.dumps({"frame_ms": front, "step_ms": step,
                                           "track_ms": track}))

    img = torch.from_numpy(frames[0][0]).to(dev).to(torch.float32)
    ext, _, levels = kernel_inputs(cfg, img, dev)
    lv0, blur0, ys, xs, dx, dy = levels[0]
    taps = ext.pyramid_taps()
    args = (lv0, cfg.ini_th_fast, cfg.min_th_fast, *_region(*lv0.shape))
    k4 = recorded["best_two"][0]
    k5 = recorded["proj_match"][0]
    k6 = recorded["pose_lm"][0]
    k7 = k6[:6] + (k6[6].to(torch.float32), True)
    calls = {   # kernel: (shapes, kernel call, twin call)
        "pyramid": (f"{H}x{W} -> {cfg.n_levels - 1} levels",
                    lambda: ce.pyramid(img, taps), lambda: ce.pyramid_plain(img, taps)),
        "dense_stage": (f"{H}x{W}", lambda: ce.dense_stage(*args, taps=ext.gauss),
                        lambda: ce.dense_stage_plain(*args, taps=ext.gauss)),
        "brief": (f"{ys.shape[0]} keypoints on {H}x{W}",
                  lambda: ce.brief(blur0, ys, xs, dx, dy),
                  lambda: ce.brief_plain(blur0, ys, xs, dx, dy)),
        "best_two": (f"{k4[0].shape[0]}x{k4[1].shape[0]}, motion-model mask of frame 1",
                     lambda: cm.masked_best_two(*k4), lambda: cm.masked_best_two_plain(*k4)),
        "proj_match": (f"{k5[0].shape[0]} local points x {k5[6].shape[0]} keypoints, frame 1",
                       lambda: cm.projection_best_two(*k5),
                       lambda: cm.projection_best_two_plain(*k5)),
        "pose_lm": (f"E={k6[2].shape[0]}, 4x10, frame 1", lambda: cp.pose_lm(*k6),
                    lambda: cp.pose_lm_plain(*k6)),
        "pose_normal_eqs": (f"E={k6[2].shape[0]}, frame 1", lambda: cp.pose_normal_eqs(*k7),
                            lambda: cp.pose_normal_eqs_plain(*k7)),
    }
    per_call = {}
    for name, (shapes, kernel, twin) in calls.items():
        reps = 10 if name == "pose_lm" else 50
        per_call[name] = (_event_ms(kernel, reps), _event_ms(twin, reps))
        dev_k, dev_t = _device_ms(kernel, 10), _device_ms(twin, 10)
        log(f"[timing] {card}: {name} ({shapes}): per call (CUDA events, back to "
            f"back) kernel {per_call[name][0]:.4f} ms, twin {per_call[name][1]:.4f} ms; "
            f"device time (profiler) kernel {dev_k:.4f} ms, twin {dev_t:.4f} ms")
    return per_call


def k7_path(recorded):
    """K7 is on no call chain, as in the reference (its build closure in
    pose_opt._lm_rounds is shadowed by the fused K6 path): drive it alone,
    one build per reference round at frame 1's edges (robust, robust,
    plain, plain), counts reset before and read after."""
    cam, T0, Xw, obs, inv_s2, st, valid = recorded["pose_lm"][0][:7]
    launch.reset_launches()
    for robust in (True, True, False, False):
        cp.pose_normal_eqs(cam, T0, Xw, obs, inv_s2, st, valid.to(torch.float32), robust)
    torch.cuda.synchronize()
    n = launch.LAUNCHES["pose_normal_eqs"]
    log(f"[main] pose_normal_eqs (K7) is on no call chain, as in the reference: driven "
        f"alone, {n} launches")
    return n


def main():
    card = device_phase()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build_phase()

    cfg = bench_config()
    t0 = time.perf_counter()
    poses, frames = render_frames()
    log(f"[main] rendered {len(frames)} RGB-D frames {W}x{H} in "
        f"{time.perf_counter() - t0:.1f} s")
    errs = dict.fromkeys(SOURCES, 0.0)
    front_parity(cfg, frames, dev, errs)
    recorded = {}
    uploads3 = [(torch.from_numpy(g).to(dev), torch.from_numpy(d).to(dev))
                for g, d in frames[:3]]
    with twins(), recording(recorded):
        run_sequence(cfg, uploads3)
    match_pose_parity(recorded, dev, errs)

    launches, uploads, inputs, results, syncs, reads = main_path_phase(cfg, poses, frames,
                                                                       dev)
    side_launches = {"pose_normal_eqs": k7_path(recorded)}
    missing = [k for k, v in {**launches, **side_launches}.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")
    per_call = timing_phase(cfg, frames, uploads, inputs, results, recorded, syncs, reads,
                            dev, card)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # K7 is on no call chain of the main path: its `launches` are the side
    # run's (k7_path), and `main_path_launches` says what the main path gave
    kernels = []
    for name, (src, rep) in SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": side_launches.get(name, launches[name]),
                 "main_path_launches": launches[name], "max_abs_err": errs[name],
                 "ms": per_call[name][0], "plain_ms": per_call[name][1]}
        if name in side_launches:
            entry["launches_from"] = "a run of its own: no call chain of the main path reaches it"
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
