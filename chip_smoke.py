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
               K1-K3 at every pyramid level of the 12 front-end frames at
               640x480 (each in its one launch over the pyramid), K4 (the
               motion-model search with its gate, and the BoW-node form),
               K5, K8 (the event's search from the map's rows) and every
               field of the K9 assembly bit-exact, K6/K7 (one cluster of 8
               CTAs each) within tolerance;
               on the inputs the main path hands them on real frames and
               keyframe events (K5 also on fusion's), and on synthetic ones
               with degenerate cases (K4 under each octave rule and past
               one tile, K5 also at N = 16,384 keypoints, two tiles, ties
               across the tile border);
4. main path — PlateWorld 640x480, 1000 features, 8 levels (the reference
               bench's configuration), the bench loop's first 31 poses:
               frame 0 through `make_frame_rgbd` and the RGB-D
               initialization (`insert_keyframe(all_depth=True)`), frames
               1-30 through `full_tracking_step_from_images`, a keyframe
               forced on every 3rd frame through `keyframe_pass` (insertion,
               point culling, triangulation, fusion, local BA, keyframe
               culling): 10 keyframe events, 9 with local BA.
               Checked: keypoints, ok flags, local-map inliers, camera-centre
               error and each event's map statistics against the JAX
               reference's recorded numbers, a finite map, launch counts
               against the frames' and events' branches, host syncs; a
               second kernel-path run under torch's deterministic algorithms
               giving the same poses and map bit for bit; a run with every
               kernel but K6/K7 on its twin giving the kernel path's, bit for
               bit; the whole sequence against the twin path;
5. system    — the port's entry point as a user calls it: SlamSystem
               (`pipeline/system.py`, loop closing off, synth_vocabulary(10,
               6) on the card, the natural keyframe policy) over the same 31
               frames as host arrays: a synchronous lap, a kidnap (state
               LOST, then the render of pose 12 must relocalize within 5 cm:
               BoW candidates, K4's node form, EPnP RANSAC, K6, and K4's
               window form in the rescue rounds), a fresh system streaming
               at depth 3 and its flush, save_tum / load_tum. Checked against
               the JAX reference's SlamSystem on the same frames: every
               frame's state, the keyframe frames within 2, the ATE within 2x
               + 1 cm (the stream's also within max(3x the sync lap's, 3
               cm)), a finite map; every kernel but K7 launched. Timed: the
               median ms per track_rgbd (frames with and without a keyframe
               apart), the stream's frames per second, the relocalization;
6. timing    — median ms per frame of the front end and of the tracking
               step, and per keyframe event, on the kernel path and the twin
               path, device time and idle share, and each kernel against its
               twin at the main path's shapes, beside its bound (the bytes
               and operations its function needs on this run's inputs) and,
               where one PyTorch call computes the same function, its time
               (K1: F.interpolate); K1, K2 and K3 per frame (one launch
               each over all levels), K4 as the motion-model search unit
               and its node form at 2048 x 2048, K5 at fusion's union and
               at N = 16,384, K8 as the event's search unit, K6 split by
               its schedule (1x0, 2x0, 1x10, 4x10).
7. loop      — loop closing through SlamSystem with its defaults (loop
               closing on, 4 amortized global-BA chunks) on the fig8-rgbd
               row of the reference's evaluation (560 frames of a figure
               eight over PlateWorld with 400 plates, ImperfectCamera), then
               flush(): the loops closed, each closure's keyframe and
               candidate, the frames tracked, the ATE, a finite map and the
               loop edges against the JAX reference's SlamSystem on the same
               frames (REFERENCE_LOOP); the loop path's kernel inputs
               against the twins bit for bit (K4's window form with open
               octaves and at the loop projection count, its node form on
               all pairs, K5 in the loop fusion, K9 at C = 128 and E =
               196,608); a second lap (the closure warm) and a third under
               torch's deterministic algorithms, both identical to the
               first bit for bit; the host syncs of frames without a
               keyframe equal to a lap with loop closing off; PCG against
               the dense Schur solve on the final map's global BA problem.
               Timed: track_rgbd per frame (without a keyframe, with one,
               with a closure), loop detection, compute_sim3, correct_loop's
               stages, each global-BA chunk (the first lap's and the
               second's), K9 at the global BA's shape.
8. stereo    — EVAL.md's block-stereo row (BlockWorld, the street canyon,
               its first 390 of 780 frames, bf 0.5 fx) through
               SlamSystem.track_stereo with
               its defaults, the pairs rendered on a thread pool ahead of
               the tracker, then flush(); checked against the JAX reference's
               SlamSystem on the same frames (REFERENCE_STEREO: the states
               of frames 0-30, the keyframes there, the frames tracked, the
               ATE, the closures, the keyframe count); K1, K2 and K3 twice a
               frame; host syncs per frame no more than the [loop] lap's; a
               depth-3 stream of the first 240 frames (against the JAX
               stream, REFERENCE_STREAMS); the stereo matcher on the card against the
               CPU and a right image's K1-K3 against their twins. Timed:
               track_stereo, make_frame_stereo, the matcher, K1-K3 on a
               right image beside their bounds;
9. mono      — EVAL.md's fig8-mono row ([loop]'s clean renders through a
               camera of noise 2) through SlamSystem.track_monocular, then
               flush(); checked against three JAX reference runs
               (REFERENCE_MONO, RANSAC keys frame_id + 0, 1, 2: the
               initialization frame, the frames tracked, the Sim3-aligned
               ATE, the keyframe count); the initialization on the card
               against the CPU with the same draws (SearchForInitialization,
               K4 at its gate and K9 at C = 2 bit for bit, R and t within
               1e-4); a depth-3 stream of the first 240 frames (against
               three JAX stream runs, REFERENCE_STREAMS). Timed:
               track_monocular, the initialization's search, RANSAC and
               CheckRT, the two-view BA, K4 at the init gate and K9 at
               C = 2 beside their bounds;
10. multi    — after [loop], on its renders and its final map: the
               tracking / mapping split (SlamSystem(pipeline_depth=3,
               mapping_device=the card): each keyframe's mapping pass on a
               second CUDA stream, issued by a worker thread, adopted at the
               next retire) beside the stream without it, both with loop
               closing on (frames tracked, the ATE within 3x [loop]'s
               synchronous lap's, keyframes against REFERENCE_SPLIT's
               split, every pass adopted, the map on the card); the
               sharded solvers at one NCCL rank against the unsharded ones
               bit for bit on the final map's global BA problem and the
               closure's essential graph; two ranks spawned on the one card
               over gloo, each K9 on its half of the points (shuffled, so
               both halves hold live points), against one rank: within
               1e-4 after one LM iteration, within [loop]'s PCG bounds
               after ten. Timed: both laps' frames per second and ms per
               call (plain, keyframe, adoption), the solves and their
               collectives, the all-reduces, K9 at the shard's shape beside
               its bound;
11. files    — after [mono]: sequences written to disk in the datasets'
               layouts (stdlib PNG writer with libpng's adaptive row
               filters, a settings YAML each) and run through the port's
               example scripts (`orb_slam2_tpu_torch/examples/`,
               `main(argv, device)`: SlamSystem as a user constructs it,
               loop closing on, the vocabulary trained on the fly):
               tum-rgbd ([system]'s 31 frames, depth as 16-bit PNG at
               x5000, DepthMapFactor 5000), tum-rgbd-distorted (the same
               poses through TUM1's fr1 lens), kitti-stereo and
               euroc-stereo (block-stereo's first 60 pairs; EuRoC with
               identity rectification blocks, so StereoRectifier runs),
               tum-mono (fig8-mono's first 90 frames). Checked: every
               image each driver read equals what was written (gray
               exactly, depth to its 16-bit value); the decoder named
               (the native library or the port's own); tum-rgbd,
               kitti-stereo and tum-mono bit for bit a lap on the decoded
               arrays held in memory; tum-rgbd, tum-rgbd-distorted and
               kitti-stereo against the JAX reference on the same decoded
               frames (REFERENCE_FILES: states, keyframes of the TUM laps
               within 2, ATE within 2x + 1 cm); euroc-stereo's poses bit
               for bit kitti-stereo's; tum-mono initialized and tracking
               95 % of the frames after; the three trajectory files against
               get_trajectory(); the vocabulary trained and holding the
               keyframes; save_map / load_map on the card bit for bit, a
               resume in localization mode within 5 cm with no keyframe
               inserted, and a relocalization on the loaded map; every
               kernel but K7 and K4's node form launched by the drivers'
               mains (counted from 0 around each), K4's node form by the
               phase (the resume's relocalization). Timed: the decoder on
               one file of each kind (as written and with filter None), the
               share of each frame waiting on the loader, track_* from
               files against in memory, the vocabulary's training;
12. eval     — after [files]: EVAL.md's torture-forward-rgbd row
               (`eval_synthetic_hard.row`: exposure amplitude 0.25, 0.12 m
               a frame, 256 keyframes and 32,768 points), its first 150
               frames (the gain falls to 0.75 at frame 135), rendered on
               threads ahead of the tracker, through SlamSystem.track_rgbd
               with loop closing on, then flush(); checked against the JAX
               reference's SlamSystem on the same frames (REFERENCE_EVAL:
               the states of frames 0-30, 95 % tracked, keyframes inserted
               within 20 %, the ATE within 2x + 1 cm, its closures and any
               other genuine), a finite map, every kernel of the path
               launched; logged: the frames that took the wide-window retry
               and the reference-keyframe fallback, track_rgbd per frame.
The second-to-last line is the kernels' JSON record (K4's two forms apart:
best_two the window form, best_two_node the node form); the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import dataclasses
import inspect
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from contextlib import contextmanager

import numpy as np

# cuBLAS is deterministic on one stream only with a fixed workspace; the
# main phase runs the sequence under torch.use_deterministic_algorithms,
# which asks for it. Set before torch starts cuBLAS.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch

from orb_slam2_tpu_torch.bow.vocabulary import synth_vocabulary
from orb_slam2_tpu_torch.examples import eval_synthetic_hard as ev
from orb_slam2_tpu_torch.geometry import se3
from orb_slam2_tpu_torch.geometry.camera import Camera
from orb_slam2_tpu_torch.mapstate import map as mapstate
from orb_slam2_tpu_torch.ops import _build, launch
from orb_slam2_tpu_torch.ops import cuda_ba as cb
from orb_slam2_tpu_torch.ops import cuda_extract as ce
from orb_slam2_tpu_torch.ops import cuda_match as cm
from orb_slam2_tpu_torch.ops import cuda_pose as cp
from orb_slam2_tpu_torch.ops import extractor as ex
from orb_slam2_tpu_torch.ops import matching, orient_brief, select
from orb_slam2_tpu_torch.ops import stereo as stereo_ops
from orb_slam2_tpu_torch.parallel import distributed, sharded_ba, sharded_pose_graph
from orb_slam2_tpu_torch.pipeline import loop_closing, mapping_ops, system, tracking_step
from orb_slam2_tpu_torch.pipeline.frame import make_frame_rgbd, make_frame_stereo
from orb_slam2_tpu_torch.solvers import initializer, pcg_ba, pose_graph, schur_ba
from orb_slam2_tpu_torch.utils import trajectory
from orb_slam2_tpu_torch.utils.config import (SlamConfig, SENSOR_MONOCULAR, SENSOR_RGBD,
                                              SENSOR_STEREO)
from orb_slam2_tpu_torch.utils.synthetic import ImperfectCamera, PlateWorld, loop_trajectory

# What the reference package (orb_slam2_tpu, XLA path, use_pallas=0) gives on
# the frames below, rendered and quantized exactly as here, with the same
# initialization, forced keyframe rule (keyframe_pass) and state chaining as
# run_sequence. Measured with jax 0.9.0 on the CPU by
# scripts/chip_smoke_reference.py.
REFERENCE_VALID = [1000] * 12          # valid keypoints, frames 0-11
REFERENCE_LOCAL_INLIERS = [           # local-map inliers, frames 1-30
    586, 598, 520, 633, 594, 505, 548, 455, 411, 514, 449, 390, 459, 393, 356,
    456, 405, 353, 445, 415, 394, 461, 426, 388, 463, 417, 374, 472, 456, 397]
REFERENCE_TRANS_ERR_M = [             # camera-centre error vs ground truth (m), frames 1-30
    0.00326, 0.00239, 0.00328, 0.00421, 0.00403, 0.00389, 0.00835, 0.00378, 0.00611, 0.00197,
    0.00299, 0.01011, 0.02443, 0.02128, 0.02158, 0.03221, 0.03416, 0.0348, 0.03009, 0.03335,
    0.03077, 0.03138, 0.02937, 0.03004, 0.01985, 0.02094, 0.02213, 0.02454, 0.02672, 0.02652]
# The reference SlamSystem (loop closing off, synth_vocabulary(10, 6), the
# natural keyframe policy) over the same frames, by the same script: the
# state after every call (1 = OK), the keyframe frames and ATE of the
# synchronous lap and of the stream at depth 3, and the kidnap's
# relocalized keyframe and camera-centre error.
REFERENCE_SYSTEM = {
    "sync_states": [1] * 31, "sync_kf_frames": [8, 9, 12, 15, 19, 26], "sync_ate_m": 0.011371,
    "kidnap_kf": 3, "kidnap_err_m": 0.014985, "stream_states": [1] * 31,
    "stream_kf_frames": [11, 15, 25], "stream_ate_m": 0.017852}
# per keyframe event (frames 3, 6, ..., 30): points triangulated, points
# replaced by fusion, BA outlier observations erased, keyframes culled, then
# valid points and valid keyframes after the event
# The reference SlamSystem with its defaults (loop closing on, 4 amortized GBA
# chunks, the natural keyframe policy, synth_vocabulary(10, 6)) over the
# [loop] phase's figure eight (render_loop_frames), handed the port's frames,
# then flush(): the loops closed and each closure's keyframe sequence number,
# frames of its keyframe and candidate and of the candidate's covisible
# keyframes; the frames tracked, the keyframes inserted and the ATE.
# `scripts/chip_smoke_reference.py --loop-only`.
REFERENCE_LOOP = {'loops': 1, 'closures': [{'kf_seq': 16, 'kf_frame': 315, 'cand_frame': 16,
                                            'cand_neighbour_frames': [0, 11, 12, 22, 29, 38, 51,
                                                                      70, 91]}],
                  'tracked': 560, 'keyframes_inserted': 27, 'keyframes': 27, 'points': 3027,
                  'loop_edge_frames': [[315, 16]], 'ate_m': 0.034936}
# the [multi] phase's numbers: scripts/chip_smoke_reference.py --split-only
# (the same lap at depth STREAM_DEPTH as the stream and as the tracking /
# mapping split: the loops closed, each closure's keyframe sequence number and
# frames, the frames tracked, the keyframes inserted and the ATE)
REFERENCE_SPLIT = {
    'stream': {'loops': 1, 'closures': [{'kf_seq': 19, 'kf_frame': 537, 'cand_frame': 0}],
               'tracked': 560, 'keyframes_inserted': 19, 'ate_m': 0.082113},
    'split': {'loops': 2, 'closures': [{'kf_seq': 20, 'kf_frame': 232, 'cand_frame': 0},
                                       {'kf_seq': 39, 'kf_frame': 537, 'cand_frame': 0}],
              'tracked': 560, 'keyframes_inserted': 40, 'ate_m': 0.082278}}
# the [stereo] and [mono] phases' numbers: scripts/chip_smoke_reference.py
# --stereo-only / --mono-only (the reference SlamSystem handed the port's
# CPU-extracted frames; [stereo] the row's first BLOCK_LAP pairs; the mono runs with
# RANSAC keys frame_id + k, k < 3)
REFERENCE_STEREO = {'loops': 0, 'closures': [], 'tracked': 390, 'keyframes_inserted': 31,
                    'keyframes': 31, 'states': [1] * 31, 'ate_m': 0.110659,   # states: frames 0-30
                    'kf_frames': [8, 9, 16, 22, 31, 42, 60, 89, 119, 136, 150, 160, 167, 178,
                                  185, 196, 206, 216, 233, 256, 288, 305, 318, 330, 337, 346,
                                  354, 364, 374, 384]}
REFERENCE_MONO = [   # RANSAC keys frame_id + 0, 1, 2
    {'loops': 0, 'closures': [], 'tracked': 559, 'keyframes_inserted': 89, 'keyframes': 76,
     'init_frame': 2, 'ate_m': 0.08022},
    {'loops': 2, 'closures': [{'kf_seq': 46, 'kf_frame': 240, 'cand_frame': 1},
                              {'kf_seq': 82, 'kf_frame': 493, 'cand_frame': 219}],
     'tracked': 559, 'keyframes_inserted': 91, 'keyframes': 79, 'init_frame': 2,
     'ate_m': 0.068624},
    {'loops': 0, 'closures': [], 'tracked': 559, 'keyframes_inserted': 92, 'keyframes': 85,
     'init_frame': 2, 'ate_m': 0.03826}]
# the depth-3 stream laps of [stereo] and [mono] (their first STREAM_LAP
# frames): scripts/chip_smoke_reference.py --stream-only (the reference
# SlamSystem streaming the port's CPU frames; stereo: the states of frames
# 0-30; mono: RANSAC keys frame_id + k, k < 3)
REFERENCE_STREAMS = {
    'stereo': {'loops': 0, 'tracked': 240, 'keyframes_inserted': 16, 'keyframes': 16,
               'kf_frames': [11, 15, 26, 37, 53, 75, 107, 129, 147, 161, 172, 184, 197, 209,
                             225], 'states': [1] * 31, 'ate_m': 0.047787},
    'mono': [{'loops': 0, 'tracked': 239, 'keyframes_inserted': 29, 'keyframes': 28,
              'init_frame': 2, 'ate_m': 0.021792},
             {'loops': 0, 'tracked': 239, 'keyframes_inserted': 28, 'keyframes': 27,
              'init_frame': 2, 'ate_m': 0.012717},
             {'loops': 0, 'tracked': 239, 'keyframes_inserted': 29, 'keyframes': 28,
              'init_frame': 2, 'ate_m': 0.014529}]}
REFERENCE_EVENTS = [
    [3, 186, 0, 0, 1186, 2], [2, 295, 136, 0, 1138, 3], [3, 331, 150, 0, 1193, 4],
    [5, 341, 226, 0, 1247, 5], [3, 345, 274, 0, 1365, 6], [4, 331, 293, 0, 1514, 7],
    [6, 337, 280, 0, 1598, 8], [4, 399, 316, 0, 1630, 9], [9, 398, 331, 0, 1696, 10],
    [9, 422, 409, 0, 1734, 11]]
EVENT_NAMES = ("triangulated", "replaced by fusion", "BA outliers erased", "keyframes culled",
               "valid points", "valid keyframes")
# Allowed distance (absolute floor, relative) of each event statistic from
# the reference's (and of the twin path's from the kernel path's):
# triangulated max(1, 25 %), so an event that triangulates nothing fails
# (the reference makes 2-9 per event); replaced by fusion max(10, 5 %) and
# BA outliers max(10, 15 %), each a threshold decision over hundreds of
# points once the port's float32 order has parted its map from the
# reference's; culls and valid keyframes exact (no keyframe is culled on
# this arc); valid points 2 %.
EVENT_TOL = [(1, 0.25), (10, 0.05), (10, 0.15), (0, 0.0), (0, 0.02), (0, 0.0)]
TWIN_TCW_TOL = 1e-3         # kernel vs twin path, per entry of Tcw, until the maps part
TWIN_TCW_PARTED = 1e-2      # the same after the maps part
TWIN_SAME_FLOOR = 0.99      # matches bound to the same map point, until the maps part
KEYPOINT_FLOOR = 0.95       # fraction of REFERENCE_VALID each frame must reach
DEPTH_FLOOR = 0.5           # fraction of valid keypoints that must have depth
INLIER_FLOOR = 0.90         # fraction of the reference's local-map inliers
N_FRONT = 12                # frames of the front-end checks
N_FRAMES = 31               # frames of the sequence (10 keyframe events)
KF_EVERY = 3                # a keyframe forced on every 3rd frame (bench.py:118-124)
N_RECORD = 7                # frames of the recording run (events at 3 and 6, BA on 6)
KIDNAP_POSE = 12            # the [system] phase's kidnap: the render of this mapped pose
STREAM_DEPTH = 3            # the [system] phase's stream lap (bench.py's default depth)
SEQ_FRAMES_CHECKED = 31     # [stereo]: the first frames, whose states must equal the reference's
BLOCK_LAP = 390             # [stereo]: its first frames, driven (cut for the time limit)
STREAM_LAP = 240            # [stereo], [mono]: the stream lap's frames (the same cut)
BLOCK_BASELINE = 0.5        # m: bf = 0.5 fx, KITTI-flavoured
EVAL_FRAMES = 150           # [eval]: torture-forward-rgbd's first frames (gain 0.75 at 135)
RENDER_AHEAD = 48           # frames rendered ahead of the tracker (a bounded queue)
STEREO_TIMED = 60           # [stereo]: frames timed again with no renderer running
LOOP_KF_SLACK = 3           # keyframes a closure may move from the reference's (covis_consistency_th)
LOOP_TRACKED_FLOOR = 0.95   # fraction of the frames the [loop] lap must track
GENUINE_LOOP_M = 4.0        # a closure's two views: true camera centres at most 4 m apart
GENUINE_LOOP_DEG = 45.0     # and optical axes at most 45 degrees apart
PCG_LM_ITERS = 10           # LM iterations of the PCG / dense comparison (run_global_ba's)
PCG_POSE_TOL = 5e-3         # their poses, per entry of Tcw (tests/test_pcg_ba.py:13-22)
PCG_POINT_TOL = 1e-2        # their points' median distance, m (the same test)
PCG_STEP_CG = 200           # CG iterations of the one-step comparison
PCG_STEP_RTOL = 1e-3        # one LM step: each solver's camera step against the exact one
SYSTEM_KF_SLACK = 2         # frames a keyframe may move from the reference's: the maps part
                            # by <= 0.23 cm from the forced run's event 6 on (K6's float32 sums)
POSE_TOL = 1e-4             # K6 against its twin, per entry of Tcw
FX, W, H = 517.3, 640, 480
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_MS = 3.35e9   # H100 SXM: 3.35 TB/s
FP32_OPS_PER_MS = 67e9      # H100 SXM: 67 TFLOP/s float32 outside the tensor cores
SOURCES = {   # kernel: (CUDA source, the TPU kernel's pallas_call it replaces)
    "pyramid": ("orb_slam2_tpu_torch/csrc/pyramid.cu",
                "orb_slam2_tpu/ops/pallas_extract.py:263"),
    "dense_stage": ("orb_slam2_tpu_torch/csrc/dense_stage.cu",
                    "orb_slam2_tpu/ops/pallas_extract.py:157"),
    "brief": ("orb_slam2_tpu_torch/csrc/brief.cu",
              "orb_slam2_tpu/ops/pallas_extract.py:360"),
    "best_two": ("orb_slam2_tpu_torch/csrc/best_two.cu",
                 "orb_slam2_tpu/ops/pallas_kernels.py:74"),
    "best_two_node": ("orb_slam2_tpu_torch/csrc/best_two.cu",
                      "orb_slam2_tpu/ops/pallas_kernels.py:74"),
    "proj_match": ("orb_slam2_tpu_torch/csrc/proj_match.cu",
                   "orb_slam2_tpu/ops/pallas_kernels.py:174"),
    "pose_lm": ("orb_slam2_tpu_torch/csrc/pose_lm.cu",
                "orb_slam2_tpu/ops/pallas_kernels.py:807"),
    "pose_normal_eqs": ("orb_slam2_tpu_torch/csrc/pose_lm.cu",
                        "orb_slam2_tpu/ops/pallas_kernels.py:301"),
    "epi_match": ("orb_slam2_tpu_torch/csrc/epi_match.cu",
                  "orb_slam2_tpu/ops/pallas_kernels.py:559"),
    "ba_edge": ("orb_slam2_tpu_torch/csrc/ba_edge.cu",
                "orb_slam2_tpu/ops/pallas_kernels.py:466"),
}
WRAPPERS = {  # kernel (K4's two forms apart): (module, wrapper, twin)
    "pyramid": (ce, "pyramid", ce.pyramid_plain),
    "dense_stage": (ce, "dense_stage_levels", ce.dense_stage_levels_plain),
    "brief": (ce, "brief_levels", ce.brief_levels_plain),
    "best_two": (cm, "window_best_two", cm.window_best_two_plain),
    "best_two_node": (cm, "node_best_two", cm.node_best_two_plain),
    "proj_match": (cm, "projection_best_two", cm.projection_best_two_plain),
    "pose_lm": (cp, "pose_lm", cp.pose_lm_plain),
    "pose_normal_eqs": (cp, "pose_normal_eqs", cp.pose_normal_eqs_plain),
    "epi_match": (cm, "epi_match_keyframes", cm.epi_match_keyframes_plain),
    "ba_edge": (cb, "ba_assemble", cb.ba_assemble_plain),
}
RECORDED = ("best_two", "best_two_node", "proj_match", "pose_lm", "epi_match", "ba_edge")
HAND_KERNELS = ("pyramid_kernel", "dense_stage_kernel", "brief_kernel", "window_best_two_kernel",
                "node_best_two_kernel", "proj_match_kernel", "pose_lm_kernel",
                "pose_normal_eqs_kernel", "epi_match_kernel",
                "ba_assemble_kernel")   # their __global__ names in csrc/
PHASE = ["track"]           # "event" while run_sequence is inside keyframe_pass
FRONT_KERNELS = ("pyramid", "dense_stage", "brief")


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


def render_loop_clean(n=None):
    """The figure eight of the fig8-rgbd row (`eval_synthetic_hard.row`:
    PlateWorld with z0 5, extent 14, 400 plates, seed 5, and
    figure_eight_trajectory(560, radius=3.2)), the first `n` poses (all by
    default), rendered clean on a few threads. Returns (world, poses,
    [(gray, depth)])."""
    from concurrent.futures import ThreadPoolExecutor
    r = ev.row("fig8-rgbd")
    world, poses = r.cam.world, r.gt[:n]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        clean = list(pool.map(world.render_with_depth, poses))
    return world, poses, clean


def render_loop_frames(n=None, clean=None):
    """The fig8-rgbd sequence: the figure eight (`render_loop_clean`'s, or
    `clean` when given) through ImperfectCamera(noise_sigma=3.0), the noise
    drawn in frame order, as a sequential render draws it. Gray stays
    float32, as the evaluation hands it to the system (quantized to uint8
    the sequence drifts less and closes no loop, PERF.md section 4).
    Returns (poses, [(gray, depth)])."""
    world, poses, clean = render_loop_clean(n) if clean is None else clean
    cam = ImperfectCamera(world, noise_sigma=3.0)
    return poses, [(cam.degrade(img, i), depth) for i, (img, depth) in enumerate(clean)]


def mono_config():
    """The fig8-mono row's config (`examples/eval_synthetic_hard.py:250-254`):
    the bench's, monocular."""
    return dataclasses.replace(bench_config(), sensor=SENSOR_MONOCULAR, bf=0.0)


def render_mono_frames(clean=None):
    """The fig8-mono sequence: the figure eight (`render_loop_clean`'s, or
    `clean` when given) through ImperfectCamera(noise_sigma=2.0), the noise
    drawn in frame order. Returns (poses, [gray])."""
    world, poses, clean = render_loop_clean() if clean is None else clean
    cam = ImperfectCamera(world, noise_sigma=2.0)
    return poses, [cam.degrade(img, i) for i, (img, _) in enumerate(clean)]


def block_config():
    """The block-stereo row's config (`examples/eval_synthetic_hard.py:255-272`):
    the bench's, stereo with a 0.5 m baseline."""
    return dataclasses.replace(bench_config(), sensor=SENSOR_STEREO, bf=FX * BLOCK_BASELINE)


def render_block_frames(n=None):
    """The block-stereo sequence of the reference's evaluation
    (`eval_synthetic_hard.row`: BlockWorld, city_block_trajectory(780,
    corner_radius=6.0, speed=0.15, overshoot=0.12) and
    ImperfectCamera(noise_sigma=3.0, exposure_amp=0.15)), the first `n`
    poses (all by default). Returns (poses, a generator of (left, right)
    float32 pairs in frame order): the clean pairs render on a few threads
    at most RENDER_AHEAD frames ahead of the consumer, and the camera's
    noise is drawn in frame order, left before right, as a sequential
    render draws it (`row_frames`)."""
    r = ev.row("block-stereo")
    return r.gt[:n], ((a, b) for _, a, b in ev.row_frames(r, n, ahead=RENDER_AHEAD))


@contextmanager
def twins(keep=()):
    """Route every wrapper but those of `keep` to its plain twin (with no
    `keep`, the twin path)."""
    routed = {k: v for k, v in WRAPPERS.items() if k not in keep}
    saved = {k: getattr(mod, name) for k, (mod, name, _) in routed.items()}
    for mod, name, twin in routed.values():
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for k, (mod, name, _) in routed.items():
            setattr(mod, name, saved[k])


@contextmanager
def recording(calls):
    """Record the arguments the main path hands K4 (both forms), K5, K6, K8
    and K9 (by WRAPPERS key; a call inside a keyframe event also under
    "<key>@event")."""
    saved = {k: getattr(WRAPPERS[k][0], WRAPPERS[k][1]) for k in RECORDED}

    def recorder(k):
        def call(*args):
            calls.setdefault(k, []).append(args)
            if PHASE[0] == "event":
                calls.setdefault(f"{k}@event", []).append(args)
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
    stage and BRIEF: (level image, blur, ys, xs, angles), built by the
    twins; and K3's arguments for the frame (`brief_levels`: the blurred
    levels, the levels' ys and xs one after another, the angles' cosine
    and sine, the pattern, the budgets)."""
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
        levels.append((pyr[lvl], blur, ys, xs, orient_brief.ic_angles(pyr[lvl], ys, xs)))
    ca, sa = orient_brief.angle_cos_sin(torch.cat([lv[4] for lv in levels]))
    brief = ([lv[1] for lv in levels], torch.cat([lv[2] for lv in levels]),
             torch.cat([lv[3] for lv in levels]), ca, sa, ext.brief_points, list(ext.budgets))
    return ext, pyr, levels, brief


def _dense_args(cfg, levels, ext):
    """What the extractor hands K2 for a frame: every level, the
    thresholds, the levels' detection regions and the Gaussian taps."""
    return ([lv for lv, *_ in levels], cfg.ini_th_fast, cfg.min_th_fast,
            [_region(*lv.shape) for lv, *_ in levels], ext.gauss)


def _max_abs(a, b):
    """Max |a - b| over two tensors, equal values (infinities too) as 0."""
    a, b = a.double(), b.double()
    return float(torch.where(a == b, torch.zeros_like(a), (a - b).abs()).max())


def _require_equal(what, a, b):
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: kernel differs from its twin "
                             f"(max |diff| {_max_abs(a, b):.3g})")


def front_image_parity(cfg, img, dev, errs, what):
    """K1, K2 and K3, each one launch over the levels of one image, against
    their twins on every level, bit for bit, on the inputs the main path
    hands them. Returns (the pyramid's levels, K3's arguments)."""
    ext, pyr_twin, levels, brief = kernel_inputs(cfg, img, dev)
    launch.reset_launches()
    pyr = ce.pyramid(img, ext.pyramid_taps())
    dense_args = _dense_args(cfg, levels, ext)
    dense = ce.dense_stage_levels(*dense_args)
    desc = ce.brief_levels(*brief)
    torch.cuda.synchronize()
    once = {k: launch.LAUNCHES[k] for k in FRONT_KERNELS}
    if once != dict.fromkeys(once, 1):
        raise AssertionError(f"{what}: front-end kernels launched {once}, once each expected")
    for lvl, (a, b) in enumerate(zip(pyr, pyr_twin)):
        errs["pyramid"] = max(errs["pyramid"], _max_abs(a, b))
        _require_equal(f"pyramid {what} level {lvl}", a, b)
    for lvl, (got, want) in enumerate(zip(dense, ce.dense_stage_levels_plain(*dense_args))):
        for name, a, b in zip(("score_nms", "hi", "blur"), got, want):
            errs["dense_stage"] = max(errs["dense_stage"], _max_abs(a, b))
            _require_equal(f"dense_stage {what} level {lvl} {name}", a, b)
    want = ce.brief_levels_plain(*brief)
    errs["brief"] = max(errs["brief"], _max_abs(desc, want))
    for lvl, (k0, k1) in enumerate(zip(*_spans(brief[6]))):
        _require_equal(f"brief {what} level {lvl}", desc[k0:k1], want[k0:k1])
    return pyr, brief


def front_parity(cfg, frames, dev, errs):
    """`front_image_parity` on the N_FRONT front-end frames."""
    for i, (gray, _) in enumerate(frames[:N_FRONT]):
        img = torch.from_numpy(gray).to(dev).to(torch.float32)
        pyr, brief = front_image_parity(cfg, img, dev, errs, f"frame {i}")
        if i == 0:
            log(f"[parity] frame 0: pyramid {len(pyr) - 1} levels {[tuple(p.shape) for p in pyr[1:]]}"
                f", dense_stage {len(pyr)} levels, brief {brief[1].shape[0]} keypoints over "
                f"{len(pyr)} levels, one launch each: bit-exact")
    log(f"[parity] pyramid, dense_stage, brief: frames 0-{N_FRONT - 1}, every level bit-exact, "
        f"one launch each per frame")


def _spans(counts):
    """The first and end keypoint of each level of a frame's budgets."""
    ends = list(itertools.accumulate(counts))
    return [e - c for e, c in zip(ends, counts)], ends


def _random_desc(rng, n, dev):
    return torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
                            .view(np.int32)).to(dev)


def _synthetic_proj_tiles(rng, dev, p=8192, n=16384):
    """K5's arguments at P points x N keypoints (by default an 8,000-feature
    setting's max_keypoints: two tiles of `cm.PROJ_TILE` staged keypoints;
    K4's window form takes the same sources and targets): keypoints across
    a 640x480 frame on 8 octaves, points near them. For points 0-63 a
    keypoint in tile 1 (in the one tile's last columns where N is one tile;
    at N = 8193 point 0 alone) equal to the point, and one in tile 0 at the
    same place and octave that is equal too (even points: a tie, which tile
    0's lower column wins, the second best 0 in tile 1) or one bit off
    (odd: the best moves to tile 1 and tile 0's becomes the second best,
    1). Returns the arguments and each forced point's (best, index,
    second)."""
    kp_xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], 1).astype(np.float32)
    kp_level = rng.integers(0, 8, n).astype(np.int32)
    kp_ur = np.where(rng.random(n) < 0.5, kp_xy[:, 0] - rng.uniform(1, 30, n), -1).astype(np.float32)
    kp_desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32)
    src = rng.integers(0, n, p)
    uv = (kp_xy[src] + rng.normal(0, 5, (p, 2))).astype(np.float32)
    radius = rng.uniform(5, 40, p).astype(np.float32)
    pred = np.clip(kp_level[src] + rng.integers(0, 2, p), 0, 7).astype(np.int32)
    p_ur = np.where(rng.random(p) < 0.5, uv[:, 0] - rng.uniform(1, 30, p), -1).astype(np.float32)
    p_desc = kp_desc[src] ^ (rng.integers(0, 2 ** 32, (p, 8), dtype=np.uint32)
                             & np.uint32(0x01010101)).view(np.int32)
    p_valid, kp_valid = rng.random(p) < 0.9, rng.random(n) < 0.9
    expect = {}
    base = cm.PROJ_TILE if n > cm.PROJ_TILE else n - 64      # the first column of "tile 1"
    for row in range(min(64, n - base)):
        first, other = 64 + row, base + row
        kp_xy[[first, other]], kp_level[[first, other]] = uv[row], pred[row]
        kp_ur[[first, other]], kp_valid[[first, other]] = -1.0, True
        kp_desc[[first, other]] = p_desc[row]
        kp_desc[first, 0] ^= row % 2
        radius[row], p_valid[row] = 6.0, True
        expect[row] = (0, first, 0) if row % 2 == 0 else (0, other, 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return tuple(t(a) for a in (uv, radius, pred, p_ur, p_valid, p_desc, kp_xy, kp_level,
                                kp_ur, kp_valid, kp_desc)), expect


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
    synthetic ones (K4's window form under each octave rule with empty rows
    and past one tile, its node form with every node 0 and with many nodes
    and -1; P=8192 local maps, stereo and mono pose problems with 20 %
    outliers, and the degenerate pose problems of
    `degenerate_pose_parity`)."""
    rng = np.random.default_rng(0)
    window = [("motion-model search, frame 1", recorded["best_two"][0], {})]
    for rule in ((-1, 1), (0, cm.OPEN), (cm.OPEN, 0)):
        args, expect = _synthetic_proj_tiles(rng, dev, p=2048, n=2048)
        args[1][100::9] = 0.0                                  # empty rows
        window.append((f"synthetic 2048x2048, octaves {rule}, empty rows", args + (rule,), expect))
    for n in (cm.PROJ_TILE + 1, 2 * cm.PROJ_TILE):
        args, expect = _synthetic_proj_tiles(rng, dev, p=2048, n=n)
        window.append((f"synthetic 2048x{n} (two tiles), best and second in different tiles",
                       args + ((-1, 1),), expect))
    for what, args, expect in window:
        got, want = cm.window_best_two(*args), cm.window_best_two_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "idx", "second"), got, want):
            errs["best_two"] = max(errs["best_two"], _max_abs(a, b))
            _require_equal(f"best_two window form, {what} {name}", a, b)
        if any(tuple(int(t[r]) for t in got) != e for r, e in expect.items()):
            raise AssertionError(f"best_two window form, {what}: the forced rows are not {expect}")
        log(f"[parity] best_two window form, {what} ({args[0].shape[0]}x{args[6].shape[0]}, "
            f"{int((got[0] < cm.BIG).sum())} rows with a candidate): bit-exact")
    node = [(f"tracking fallback, frame {i}", a) for i, a in
            enumerate(recorded.get("best_two_node", [])[:2])]
    node += [(f"synthetic 2048x2048, {what}", _synthetic_node(rng, 2048, 2048, nodes, dev))
             for what, nodes in (("every node 0 (the tracking fallback)", 1),
                                 ("64 nodes and -1", 64))]
    for what, args in node:
        got, want = cm.node_best_two(*args), cm.node_best_two_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "idx", "second"), got, want):
            errs["best_two_node"] = max(errs["best_two_node"], _max_abs(a, b))
            _require_equal(f"best_two node form, {what} {name}", a, b)
        log(f"[parity] best_two node form, {what} ({args[1].shape[0]}x{args[4].shape[0]}, "
            f"{int((got[0] < cm.BIG).sum())} rows with a candidate): bit-exact")

    rec = recorded["proj_match"][0]
    uv, radius, pred, p_ur, p_valid, p_desc, kp_xy, kp_level, kp_ur, kp_valid, kp_desc = rec
    P = 8192
    src = torch.from_numpy(rng.integers(0, kp_xy.shape[0], P)).to(dev)
    synth = ((kp_xy[src] + torch.randn(P, 2, device=dev) * 5).contiguous(),
             torch.full((P,), 12.0, device=dev), kp_level[src].contiguous(),
             kp_ur[src].contiguous(), torch.ones(P, dtype=torch.bool, device=dev),
             (kp_desc[src] ^ (_random_desc(rng, P, dev) & 0x00110011)).contiguous(),
             kp_xy, kp_level, kp_ur, kp_valid, kp_desc)
    tiles, expect = _synthetic_proj_tiles(rng, dev)
    for what, args in (("local map, frame 1", rec), ("synthetic P=8192", synth),
                       ("synthetic N=16384 (two tiles), ties across the tile border", tiles)):
        got, want = cm.projection_best_two(*args), cm.projection_best_two_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "idx", "second"), got, want):
            _require_equal(f"proj_match {what} {name}", a, b)
        if args is tiles and any(tuple(int(t[r]) for t in got) != e for r, e in expect.items()):
            raise AssertionError(f"proj_match {what}: the forced rows are not {expect}")
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


def _synthetic_node(rng, n, m, nodes, dev):
    """K4's node-form arguments at N x M: 5 % of each side invalid;
    vocabulary nodes in [0, nodes), a tenth of the sources with node -1
    (nodes = 1: the tracking fallback's, node 0 for every valid feature and
    -1 for every other); half the targets near-duplicates of sources, and
    pairs of equal targets (ties)."""
    desc_a = _random_desc(rng, n, dev)
    desc_b = _random_desc(rng, m, dev)
    k = min(n, m) // 2
    desc_b[:k] = desc_a[:k] ^ _random_desc(rng, k, dev) & 0x00100010
    desc_b[k:k + 64] = desc_b[:64]
    valid_a, valid_b = (torch.from_numpy(rng.random(c) < 0.95).to(dev) for c in (n, m))
    node_a = torch.from_numpy(rng.integers(0, nodes, n).astype(np.int32)).to(dev)
    node_b = torch.from_numpy(rng.integers(0, nodes, m).astype(np.int32)).to(dev)
    if nodes == 1:
        node_a, node_b = (torch.where(v, t, t - 1) for v, t in ((valid_a, node_a), (valid_b, node_b)))
    else:
        node_a[torch.from_numpy(rng.random(n) < 0.1).to(dev)] = -1
    return node_a, desc_a, valid_a, node_b, desc_b, valid_b


def _synthetic_epi(rng, b, n, dev, bound_kf1=False):
    """K8's arguments (`epi_match_keyframes`) for B neighbours x N features,
    from a synthetic map of B + 1 keyframes (row 0 the new keyframe, rows
    1..B its neighbours) with random fundamental matrices and epipoles: a
    third of kf1's features bound (rows with no candidate; all of them with
    bound_kf1) and a fifth of each neighbour's; in each neighbour, two equal
    features on the line of each of a quarter of kf1's unbound features that
    resemble it (a tie, which the lower column wins); neighbour 1 with every
    feature near its epipole (no candidate column), neighbour 2 with a NaN F
    (NaN lines), neighbour 3 with la = lb = 0 (den clamped to 1e-12, every
    unbound far feature a candidate)."""
    cfg = bench_config()
    k = b + 1
    obs = np.where(rng.random((k, n)) < 0.2, 5, -1).astype(np.int32)
    obs[0] = np.where((np.arange(n) % 3 == 0) | bound_kf1, 7, -1)
    xy = np.stack([rng.uniform(0, W, (k, n)), rng.uniform(0, H, (k, n))], -1)
    desc = rng.integers(0, 2 ** 32, (k, n, 8), dtype=np.uint32)
    F = rng.normal(0, 1e-3, (b, 3, 3)).astype(np.float32)
    F[:, 2, 2] = rng.normal(0, 1, b)
    epi = np.stack([rng.uniform(0, W, b), rng.uniform(0, H, b)], -1).astype(np.float32)
    rows = np.flatnonzero(obs[0] < 0)[: n // 4]
    x1 = xy[0, rows].astype(np.float32).astype(np.float64)
    for j in range(b):
        la, lb, lc = (F[j, r, 0] * x1[:, 0] + F[j, r, 1] * x1[:, 1] + F[j, r, 2] for r in range(3))
        ok = np.abs(lb) > 1e-6
        tgt = rng.permutation(n)[: 2 * len(rows)].reshape(2, -1)[:, ok]
        x2 = rng.uniform(0, W, ok.sum())
        y2 = -(la[ok] * x2 + lc[ok]) / lb[ok] + rng.normal(0, 0.3, ok.sum())
        flips = rng.integers(0, 2 ** 32, (ok.sum(), 8), dtype=np.uint32) & \
            rng.integers(0, 2 ** 32, (ok.sum(), 8), dtype=np.uint32)
        for t in tgt:
            xy[j + 1, t] = np.stack([x2, y2], -1)
            desc[j + 1, t] = desc[0, rows[ok]] ^ flips
    if b >= 3:
        xy[1] = epi[0] + rng.uniform(-2, 2, (n, 2))
        F[1] = np.nan
        F[2, :2] = 0.0
        F[2, 2] = (1e-9, 1e-9, 1e-7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(obs), t(rng.random((k, n)) < 0.95), t(xy.astype(np.float32)),
            t(desc.view(np.int32)), t(rng.integers(0, 8, (k, n)).astype(np.int32)),
            torch.zeros((), dtype=torch.int64, device=dev),
            torch.arange(1, b + 1, dtype=torch.int64, device=dev), t(F), t(epi),
            tuple(cfg.level_sigma2), tuple(cfg.scale_factors))


def _synthetic_ba(rng, q, o, c, dev, robust, drop_cam=None):
    """K9's arguments at E = q * o edges, as `schur_ba._assemble` hands them:
    16 random cameras in c slots (slots 0-15, or every 32nd from slot 7
    where c > 64; the rest empty) around points 4-15 m in front, 5 % of the
    points behind their camera, 2 % of the edges padded (camera -1), 1 %
    masked, 30 % stereo; camera drop_cam's edges padded with weight 1 (they
    must join no camera's sums)."""
    T = se3.exp(torch.from_numpy(rng.normal(0, 0.1, (c, 6)).astype(np.float32)))
    X = np.stack([rng.uniform(-3, 3, q), rng.uniform(-2, 2, q), rng.uniform(4, 15, q)], -1)
    X[: q // 20, 2] = -rng.uniform(0.5, 3, q // 20)
    slots = np.arange(min(c, 16)) if c <= 64 else 7 + 32 * np.arange(16)
    obs_cam = slots[rng.integers(0, len(slots), (q, o))].astype(np.int32)
    obs_cam[rng.random((q, o)) < 0.02] = -1
    mask = rng.random((q, o)) > 0.01
    if drop_cam is not None:
        mask |= obs_cam == drop_cam
        obs_cam[obs_cam == drop_cam] = -1
    uvr = np.stack([rng.uniform(0, W, (q, o)), rng.uniform(0, H, (q, o)),
                    np.where(rng.random((q, o)) < 0.3, rng.uniform(0, W, (q, o)), -1.0)], -1)
    t = lambda a, dt=np.float32: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    prob = schur_ba.BAProblem(
        poses=T.to(dev), cam_valid=torch.ones(c, dtype=torch.bool, device=dev),
        cam_fixed=torch.zeros(c, dtype=torch.bool, device=dev), points=t(X),
        pt_valid=torch.ones(q, dtype=torch.bool, device=dev), obs_cam=t(obs_cam, np.int32),
        obs_uvr=t(uvr), obs_level=t(rng.integers(0, 8, (q, o)), np.int32))
    edges = schur_ba._edges(prob, t(1.0 / 1.44 ** rng.integers(0, 8, (q, o))))
    cam = Camera.make(FX, FX, W / 2, H / 2, bf=FX * 0.25, device=dev)
    return cam, prob.poses, prob.points, prob.pt_valid, edges, t(mask), robust


def _lin_equal(what, got, want, errs):
    """K9 against its twin: every `schur_ba.Lin` field equal bit for bit,
    NaN where the twin has NaN."""
    for name, a, b in zip(schur_ba.Lin._fields, got, want):
        if a.is_floating_point():
            if not torch.equal(torch.isnan(a), torch.isnan(b)):
                raise AssertionError(f"ba_assemble {what} {name}: NaN entries differ from its twin")
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
            errs["ba_edge"] = max(errs["ba_edge"], _max_abs(a, b))
        _require_equal(f"ba_assemble {what} {name}", a, b)


def map_parity(recorded, dev, errs):
    """K8, K9 and K5 (fusion's calls) against their twins: on the inputs
    two real keyframe events handed them (frames 3 and 6 of the recording
    run; local BA on 6) and on synthetic ones at full width with the
    degenerate cases: rows with no candidate, no candidate column, NaN
    lines, a clamped den, every edge masked, a NaN point."""
    rng = np.random.default_rng(1)
    cases = [(f"keyframe event {i + 1}", a) for i, a in enumerate(recorded["epi_match"])]
    cases += [("synthetic B=10 N=2048, ties, no candidate column, NaN lines, den 1e-12",
               _synthetic_epi(rng, 10, 2048, dev)),
              ("synthetic, every kf1 feature bound", _synthetic_epi(rng, 10, 2048, dev, True)),
              ("synthetic B=10 N=4096 (two column chunks)", _synthetic_epi(rng, 10, 4096, dev))]
    for what, args in cases:
        got, want = cm.epi_match_keyframes(*args), cm.epi_match_keyframes_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "idx"), got, want):
            errs["epi_match"] = max(errs["epi_match"], _max_abs(a, b))
            _require_equal(f"epi_match {what} {name}", a, b)
        log(f"[parity] epi_match {what} (B={args[6].shape[0]} x N={args[0].shape[1]}, "
            f"{int((got[0] < cm.BIG).sum())} rows with a candidate): bit-exact")

    ba = recorded["ba_edge@event"]
    cases = [("keyframe event 2, first pass", ba[0]), ("keyframe event 2, last pass", ba[-1])]
    for robust in (True, False):
        cases.append((f"synthetic E=49152 robust={robust}",
                      _synthetic_ba(rng, 4096, 12, 64, dev, robust)))
    masked = _synthetic_ba(rng, 4096, 12, 64, dev, True)
    cases.append(("synthetic, every edge masked", masked[:5] + (torch.zeros_like(masked[5]),
                                                                True)))
    poisoned = _synthetic_ba(rng, 4096, 12, 64, dev, True)
    poisoned[2][100] = float("nan")                         # point 100, all 12 edges
    cases.append(("synthetic, a NaN point", poisoned))
    cases.append(("synthetic, camera 3's edges padded with weight 1, slots 16-63 empty",
                  _synthetic_ba(rng, 4096, 12, 64, dev, True, drop_cam=3)))
    cases.append(("synthetic, 16 cameras in 512 slots (global BA's C)",
                  _synthetic_ba(rng, 4096, 12, 512, dev, True)))
    for what, args in cases:
        got, again = cb.ba_assemble(*args), cb.ba_assemble(*args)
        want = cb.ba_assemble_plain(*args)
        torch.cuda.synchronize()
        _lin_equal(what, got, want, errs)
        _lin_equal(f"{what}, a second launch", again, got, {"ba_edge": 0.0})
        lin = schur_ba.Lin(*got)
        nan_cams = int(torch.isnan(lin.Hcc).any(dim=(1, 2)).sum())
        if "NaN" in what and not (bool(lin.err.isnan()) and 0 < nan_cams < lin.Hcc.shape[0]):
            raise AssertionError(f"ba_assemble {what}: err {float(lin.err)}, {nan_cams} cameras "
                                 f"with a NaN Hcc (err must be NaN, the NaN confined to the "
                                 f"point's cameras)")
        if "masked" in what and (float(lin.err) != 0.0 or bool(lin.Hcc.any())):
            raise AssertionError(f"ba_assemble {what}: err {float(lin.err)}, Hcc not zero")
        if "padded" in what and (bool(lin.Hcc[3].any()) or bool(lin.Hcc[16:].any())):
            raise AssertionError(f"ba_assemble {what}: an empty camera's Hcc is not zero")
        if "512" in what and int(lin.Hcc.any(dim=(1, 2)).sum()) != 16:
            raise AssertionError(f"ba_assemble {what}: not 16 cameras with a nonzero Hcc")
        log(f"[parity] ba_assemble {what} (Q={args[2].shape[0]} x O={args[5].shape[1]}, "
            f"C={args[1].shape[0]}): every field bit-exact, a second launch identical; err "
            f"{float(lin.err):.6g}, {nan_cams} cameras with a NaN Hcc")

    fusion = recorded["proj_match@event"]
    into = max(fusion[:-1], key=lambda a: int(a[4].sum()))      # the most points in view
    for what, args in (("fusion into a target", into), ("fusion of the union", fusion[-1])):
        got, want = cm.projection_best_two(*args), cm.projection_best_two_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "idx", "second"), got, want):
            _require_equal(f"proj_match {what} {name}", a, b)
        log(f"[parity] proj_match {what} ({args[0].shape[0]} points x {args[6].shape[0]} "
            f"keypoints, {int((got[0] < cm.BIG).sum())} with a candidate): bit-exact")


def run_sequence(cfg, uploads, count_syncs=False):
    """Initialization on frame 0, then frames 1.. through the tracking step
    with a keyframe event (keyframe_pass) forced on every KF_EVERY-th frame,
    chaining the state as SlamSystem._set_last/_track_frame do (the
    keyframe's next points by `system.last_points`, as `_set_last`). Returns the
    step results, the inputs of each step (for re-timing), the host syncs
    per frame and the source lines that synced (with count_syncs), and one
    record per keyframe event: its frame, inputs, summary (on the card), map
    after, and host syncs."""
    dev = uploads[0][0].device
    N = cfg.max_keypoints
    eye = torch.eye(4, device=dev)
    f0 = make_frame_rgbd(*uploads[0], cfg)
    m = mapstate.empty(cfg.max_keyframes, cfg.max_map_points, N, device=dev)
    m, kf = mapping_ops.insert_keyframe(cfg, m, f0, eye,
                                        torch.full((N,), -1, dtype=torch.int32, device=dev),
                                        0, 0.0, all_depth=True)
    lm = mapstate.take(m.kf_obs, kf)
    lp, lpv = system.last_points(cfg, m, f0, eye, lm)
    last, T_last, vel, has_vel, ref = f0, eye, eye, False, kf
    results, inputs, syncs, where, events = [], [], [], Counter(), []
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
                    ev_args = (cfg, m, r.frame, r.Tcw, r.matched_pt, i, i / cfg.fps)
                    n0 = len(caught)
                    PHASE[0] = "event"
                    try:
                        m, culled, summary = mapping_ops.keyframe_pass(*ev_args)
                    finally:
                        PHASE[0] = "track"
                    ev_syncs = sum("synchroniz" in str(w.message) for w in caught[n0:])
                    events.append(dict(frame=i, args=ev_args, summary=summary, m=m,
                                       culled=culled, syncs=ev_syncs))
                    kf = summary[0]
                    lm = mapstate.take(m.kf_obs, kf)
                    lp, lpv = system.last_points(cfg, m, r.frame, r.Tcw, lm)
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
    return results, inputs, syncs, where, events


def _event_stats(ev):
    """[triangulated, replaced, BA outliers, culled, valid points, valid
    keyframes] of one event record (host values)."""
    sm = ev["summary"].tolist()
    return sm[4:8] + [int(ev["m"].n_points), sm[1]]


def _stats_close(a, b):
    """Whether event statistics a lie within EVENT_TOL of b."""
    return all(abs(x - y) <= max(lo, rel * abs(y)) for x, y, (lo, rel) in zip(a, b, EVENT_TOL))


def _map_finite(m):
    """No NaN or infinity in the live rows of the map's float fields."""
    kv, pv = m.kf_valid, m.pt_valid
    for name, t in (("kf_pose", m.kf_pose[kv]), ("kf_xy", m.kf_xy[kv]),
                    ("kf_timestamp", m.kf_timestamp[kv]), ("pt_pos", m.pt_pos[pv]),
                    ("pt_normal", m.pt_normal[pv]), ("pt_min_dist", m.pt_min_dist[pv]),
                    ("pt_max_dist", m.pt_max_dist[pv])):
        if not bool(torch.isfinite(t).all()):
            return name
    return None


def _same_map(a, b):
    """The names of the fields in which two maps differ (bit for bit)."""
    return [f for f in mapstate.MapState._fields if not torch.equal(getattr(a, f), getattr(b, f))]


def _run_diff(results, events, other):
    """What differs, bit for bit, between a sequence run (its step results
    and event records) and another `run_sequence` result: each frame's Tcw,
    each event's summary, the final map's fields."""
    diff = [f"Tcw of frame {i}" for i, (a, b) in enumerate(zip(results, other[0]), start=1)
            if not torch.equal(a.Tcw, b.Tcw)]
    diff += [f"summary of the event at frame {a['frame']}" for a, b in zip(events, other[4])
             if not torch.equal(a["summary"], b["summary"])]
    return diff + [f"map field {f}" for f in _same_map(other[4][-1]["m"], events[-1]["m"])]


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
    per_frame = {"pyramid": 1, "dense_stage": 1, "brief": int(sum(cfg.features_per_level()) > 0)}
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

    # the sequence: tracking (K1-K6) and keyframe events (K5, K8, K9)
    log(f"[main] {N_FRAMES - 1} frames after the RGB-D initialization, a keyframe event "
        f"(keyframe_pass: insertion, point culling, triangulation, fusion, local BA, "
        f"keyframe culling) forced on every {KF_EVERY}rd frame")
    tracking_step.HOST_READS["count"] = 0
    mapping_ops.HOST_READS["count"] = 0
    launch.reset_launches()
    results, inputs, syncs, where, events = run_sequence(cfg, uploads, count_syncs=True)
    torch.cuda.synchronize()
    launches = dict(launch.LAUNCHES)
    reads = tracking_step.HOST_READS["count"]
    ev_reads = mapping_ops.HOST_READS["count"]
    sc = torch.stack([r.scalars for r in results]).cpu().numpy()
    summ = [e["summary"].tolist() for e in events]
    n_track, n_ev = len(results), len(events)
    ba_iters = (1 + cfg.ba_iters_a) + (1 + cfg.ba_iters_b)       # K9 launches per local BA
    n_ba = sum(1 for sm in summ if sm[1] + sm[7] > 2)            # keyframes before culling
    expected = {k: v * N_FRAMES for k, v in per_frame.items()}
    expected.update(best_two=int(n_track + sc[:, 10].sum()), best_two_node=int(sc[:, 7].sum()),
                    proj_match=int(n_track + sum(sm[8] + 1 for sm in summ)),
                    pose_lm=int(2 * n_track + sc[:, 7].sum()), pose_normal_eqs=0,
                    epi_match=n_ev, ba_edge=ba_iters * n_ba)
    log(f"[main] launches {launches}, expected from the frames' and events' branches "
        f"{expected} ({n_ev} events, {n_ba} with local BA)")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != expected {expected}")
    ev_syncs = [e["syncs"] for e in events]
    log(f"[main] host syncs per frame (sync debug mode, events included): {syncs}; the "
        f"step's own reads {reads} ({reads / n_track:.1f} per frame); per keyframe event "
        f"{ev_syncs} syncs, {ev_reads / n_ev:.1f} reads of its own; by source line over the "
        f"{n_track} frames: {dict(where.most_common())}")
    if ev_reads != 2 * n_ev:
        raise AssertionError(f"{ev_reads} host reads in {n_ev} events, expected 2 each")

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
    for k, (e, ref_ev) in enumerate(zip(events, REFERENCE_EVENTS)):
        got = _event_stats(e)
        bad = _map_finite(e["m"])
        log(f"[main] keyframe event at frame {e['frame']}: " + ", ".join(
            f"{n} {g} (reference {w})" for n, g, w in zip(EVENT_NAMES, got, ref_ev)))
        if bad:
            raise AssertionError(f"event at frame {e['frame']}: non-finite {bad} in the map")
        if not _stats_close(got, ref_ev):
            raise AssertionError(f"event at frame {e['frame']}: statistics {got} outside "
                                 f"{EVENT_TOL} of the reference's {ref_ev}")
    m = events[-1]["m"]
    log(f"[main] the map after the last event: {int(m.n_keyframes)} keyframes, "
        f"{int(m.n_points)} points, finite")

    # the same sequence again on the kernel path, under PyTorch's
    # deterministic algorithms: the same poses and map bit for bit, and no
    # operation without a deterministic implementation
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            again = run_sequence(cfg, uploads)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    offenders = Counter(str(w.message).split(".")[0][:90] for w in caught
                        if "determinis" in str(w.message))
    diff = _run_diff(results, events, again)
    if diff or offenders:
        raise AssertionError(f"a second kernel-path run under torch.use_deterministic_algorithms"
                             f" differs in {diff[:8]} ({len(diff)} items); operations without "
                             f"a deterministic implementation: {dict(offenders)}")
    log(f"[main] a second kernel-path run, under torch.use_deterministic_algorithms: every Tcw, "
        f"every event's summary and the final map ({len(m)} fields) identical bit for bit; no "
        f"operation without a deterministic implementation")

    # every kernel but K6/K7 on its twin: the twins of K1-K5, K8 and K9
    # repeat their kernels bit for bit on this path, so this run is the
    # kernel path's, and K6's float32 summation order is all that parts the
    # twin path from the kernel path below
    with twins(keep=("pose_lm", "pose_normal_eqs")):
        launch.reset_launches()
        k6_only = run_sequence(cfg, uploads)
        torch.cuda.synchronize()
        others = {k: v for k, v in launch.LAUNCHES.items() if v and k != "pose_lm"}
    diff = _run_diff(results, events, k6_only)
    if diff or others:
        raise AssertionError(f"twins with K6/K7 alone on the card: differs from the kernel "
                             f"path in {diff[:8]} ({len(diff)} items); other kernels launched: "
                             f"{others}")
    log(f"[main] twins with K6/K7 alone on the card ({launch.LAUNCHES['pose_lm']} K6 "
        f"launches): every Tcw, every event's summary and the final map identical to the "
        f"kernel path's bit for bit")

    with twins():
        launch.reset_launches()
        twin = run_sequence(cfg, uploads)
        torch.cuda.synchronize()
        if any(launch.LAUNCHES.values()):
            raise AssertionError(f"the twin path launched kernels: {launch.LAUNCHES}")
    # Until the two paths' maps part (an event whose integer outcome
    # differs), every Tcw within TWIN_TCW_TOL and each frame binding the same
    # map points; after that, point ids are allocated differently, and each
    # frame is held to TWIN_TCW_PARTED and the bounds the reference
    # comparison uses (on an H100 the parted Tcw grew to 3.7e-3 by frame 30).
    ev_frames = {e["frame"]: (e, t) for e, t in zip(events, twin[4])}
    parted, worst_same, dTs = None, 1.0, []
    for i, (a, b) in enumerate(zip(results, twin[0]), start=1):
        dT = float((a.Tcw - b.Tcw).abs().max())
        dTs.append(dT)
        if parted is None:
            bound = (a.matched_pt >= 0) | (b.matched_pt >= 0)
            same = float((a.matched_pt == b.matched_pt)[bound].float().mean())
            worst_same = min(worst_same, same)
            if dT > TWIN_TCW_TOL or same < TWIN_SAME_FLOOR:
                raise AssertionError(f"frame {i}: kernel path vs twin path: Tcw max diff "
                                     f"{dT:.3g}, {same:.4f} of the matches the same")
        else:
            n_k, n_t = int(a.scalars[3]), int(b.scalars[3])
            e_k = _centre_error(a.Tcw, poses[0], poses[i])
            e_t = _centre_error(b.Tcw, poses[0], poses[i])
            if not bool(b.scalars[0]) or n_t < INLIER_FLOOR * n_k or e_t > 2 * e_k + 0.01 \
                    or dT > TWIN_TCW_PARTED:
                raise AssertionError(f"frame {i}: twin path {n_t} inliers, centre error "
                                     f"{e_t:.4f} m, Tcw max diff {dT:.3g}; kernel path {n_k}, "
                                     f"{e_k:.4f} m")
        if i in ev_frames:
            ea, eb = ev_frames[i]
            ga, gb = _event_stats(ea), _event_stats(eb)
            if not _stats_close(gb, ga):
                raise AssertionError(f"event at frame {i}: twin path {gb} vs kernel path {ga}")
            if parted is None and ea["summary"].tolist() != eb["summary"].tolist():
                parted = i
    log(f"[main] kernel path vs twin path on the card, {n_track} frames: Tcw max diff "
        f"{max(dTs):.3g}, by frame {[float(f'{d:.2g}') for d in dTs]}; the maps part at the "
        f"event of frame {parted} (before it >= {worst_same:.4f} of the matched keypoints "
        f"bound to the same map point); event "
        f"statistics kernel {[_event_stats(e) for e in events]}, twin "
        f"{[_event_stats(e) for e in twin[4]]}")
    return launches, uploads, inputs, results, syncs, reads / n_track, events


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


def _profile(fn, reps):
    """The device rows of torch.profiler's key_averages over `reps` calls of
    fn. Late in this script's process the profiler drops a share of the
    device activities anywhere in its window (a third to a half of short
    queued kernels, torch's own included, where a fresh process,
    scripts/probe_torch_profiler.py, records every one), so its sums are
    lower bounds; the durations it does record agree with `_queued_ms`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def _device_ms(fn, reps=20):
    """Device time per call: the GPU activity the profiler records over
    `reps` calls (host overhead excluded), divided by reps; and the device
    activities it recorded per call."""
    fn()
    torch.cuda.synchronize()
    evs = _profile(fn, reps)
    return (sum(e.self_device_time_total for e in evs) / 1e3 / reps,
            sum(e.count for e in evs) / reps)


def _queued_ms(fn, reps=20):
    """Device time per call of a kernel wrapper: `reps` calls issued while
    the device runs a sleeping kernel, so they run back to back once it
    ends, timed by CUDA events around them (the host's issue hidden, the
    device's gaps between queued launches included). The calls must not
    sync. This clock does not depend on the profiler (`_profile`)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    cycles = 1 << 24
    for _ in range(6):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        ev[2].record()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - h0) * 1e3
        ev[3].record()
        torch.cuda.synchronize()
        if host_ms < 0.5 * ev[0].elapsed_time(ev[1]):
            return ev[2].elapsed_time(ev[3]) / reps
        cycles *= 4
    raise AssertionError(f"{reps} calls took {host_ms:.1f} ms to issue, longer than the "
                         f"sleeping kernel they queue behind")


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
    res["kernel_device_ms"] = _device_ms(lambda: fn(items[0]), reps=5)[0]
    with twins():
        res["twin_device_ms"] = _device_ms(lambda: fn(items[0]), reps=5)[0]
    log(f"[timing] {card}: {name} median {res['kernel_ms']:.3f} ms per call kernel path, "
        f"{res['twin_ms']:.3f} ms per call twin path ({len(k_ms)} calls each); device "
        f"(profiler, a lower bound) {res['kernel_device_ms']:.3f} ms per call kernel path "
        f"({1 - res['kernel_device_ms'] / res['kernel_ms']:.1%} of the call idle), "
        f"{res['twin_device_ms']:.3f} ms per call twin path "
        f"({1 - res['twin_device_ms'] / res['twin_ms']:.1%} idle)")
    return res


def _nbytes(*ts):
    """Bytes of the tensors among ts (nested tuples and lists included)."""
    n = 0
    for t in ts:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            n += _nbytes(*t)
    return n


def _bound(n_bytes, ops):
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the operations over the float32 rate (integer and compare
    operations counted at the same rate). Returns (ms, "bytes" or
    "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_MS, ops / FP32_OPS_PER_MS
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _sampled_pixels(brief):
    """The distinct pixels K3's samples read over a frame's levels."""
    blurs, ys, xs, ca, sa, points, counts = brief
    n = 0
    for blur, k0, k1 in zip(blurs, *_spans(counts)):
        h, w = blur.shape
        dx, dy = ce.rotate_pattern(ca[k0:k1], sa[k0:k1], points)
        gy = torch.clamp(ys[k0:k1, None].long() + dy.long(), 0, h - 1)
        gx = torch.clamp(xs[k0:k1, None].long() + dx.long(), 0, w - 1)
        n += torch.unique(gy * w + gx).numel()
    return n


def _brief_bytes(brief, tables=False):
    """The bytes K3's function must move over a frame: the distinct pixels
    its samples read (not the whole levels), per keypoint its position,
    cosine and sine in (16) and its words out (32), the pattern once; with
    `tables`, the parent's function instead, which read (N, 512) offset
    tables dx and dy (4 KB a keypoint) in place of the cosine, sine and
    pattern."""
    n = brief[1].shape[0]
    ins = 8 * n + (2 * 4 * 512 * n if tables else 8 * n + _nbytes(brief[5]))
    return 4 * _sampled_pixels(brief) + ins + 32 * n


def _proj_match_bytes(args, cand):
    """The bytes K5's function must move: both validity masks; each valid
    point's projection, radius, octave and right x (20 bytes); each valid
    keypoint's position, octave and right x (16); the descriptors of the
    points with a candidate and of the keypoints that are one; best, index
    and second out for every point. `cand` is the (P, N) candidate mask."""
    p_valid, kp_valid = args[4], args[9]
    return (p_valid.numel() + kp_valid.numel() + 20 * int(p_valid.sum())
            + 16 * int(kp_valid.sum()) + 32 * int(cand.any(1).sum())
            + 32 * int(cand.any(0).sum()) + 12 * p_valid.numel())


def _node_bytes(args, cand):
    """The bytes K4's node form must move: each source's and target's node
    and validity (5); the descriptors of the sources with a candidate and
    of the targets that are one; best, index and second out for every
    source. `cand` is the (N, M) candidate mask."""
    n, m = args[1].shape[0], args[4].shape[0]
    return 5 * (n + m) + 32 * int(cand.any(1).sum()) + 32 * int(cand.any(0).sum()) + 12 * n


def _epi_match_bytes(args, rows, cands):
    """The bytes K8's function must move, from the map's rows: kf1's and
    each neighbour's row of the bound and valid masks (5 bytes a feature);
    each unbound kf1 feature's position (8) and the descriptor of each that
    has a candidate (32); each unbound neighbour feature's position and
    octave (12) and the descriptor of each that is a candidate (32); each
    neighbour's F, epipole and row (52), kf1's row (8); best and index out
    for every row. `rows` is `cm.epi_rows(*args)`, `cands` each
    neighbour's (N, N) candidate mask."""
    un1, un2 = rows[1], rows[7]
    b, n = un2.shape
    has = torch.stack([c.any(1) for c in cands]).any(0) if cands else un1 & False
    return (5 * n * (b + 1) + 8 * int(un1.sum()) + 32 * int(has.sum()) + 12 * int(un2.sum())
            + 32 * sum(int(c.any(0).sum()) for c in cands) + 52 * b + 8 + 8 * b * n)


def _ba_assemble_bytes(args):
    """The bytes K9's function must move: per edge the observation (u, v,
    uR), inv_sigma2, stereo, mask and a camera index in (28) and We, chi2
    and depth_ok out (77); per point its position and validity in (13) and
    Hpp's 6 entries, bp and pt_on out (37); per camera its pose's 12
    entries in (48) and Hcc's 21 entries and bc out (108); err out."""
    poses, points, edge_mask = args[1], args[2], args[5]
    return 105 * edge_mask.numel() + 50 * points.shape[0] + 156 * poses.shape[0] + 4


def _front_calls(cfg, img, dev, what=f"{H}x{W}"):
    """K1, K2 and K3 on one image, as the timing phase times them: (the
    pyramid, K3's arguments, {kernel: (shapes, kernel call, twin call,
    inputs or bytes, operations)}), each one launch a frame. K1: the image and its packed
    taps in, the levels 1.. out, 3 operations per tap pass; K2: 124 per
    pixel; K3: 512 x (4 products, 2 sums, 2 roundings) for the rotation
    and 1,024 for the samples and compares per keypoint."""
    ext, pyr, levels, brief = kernel_inputs(cfg, img, dev)
    taps, dense_args = ext.pyramid_taps(), _dense_args(cfg, levels, ext)
    resize_ops = sum(3 * h * pw + 3 * h * w for (ph, pw), (h, w) in
                     zip([p.shape for p in pyr[:-1]], [p.shape for p in pyr[1:]]))
    return pyr, brief, {
        "pyramid": (f"{what} -> {cfg.n_levels - 1} levels, call (one launch)",
                    lambda: ce.pyramid(img, taps), lambda: ce.pyramid_plain(img, taps),
                    _nbytes(img, taps.itaps, taps.ftaps, pyr[1:]), resize_ops),
        "dense_stage": (f"{what} pyramid, {len(levels)} levels, frame (one launch)",
                        lambda: ce.dense_stage_levels(*dense_args),
                        lambda: ce.dense_stage_levels_plain(*dense_args),
                        (dense_args[0], ext.gauss), 124 * sum(lv.numel() for lv in pyr)),
        "brief": (f"{brief[1].shape[0]} keypoints over {len(levels)} levels of {what}, frame "
                  f"(one launch)",
                  lambda: ce.brief_levels(*brief), lambda: ce.brief_levels_plain(*brief),
                  _brief_bytes(brief), (8 * 512 + 1024) * brief[1].shape[0])}


def timing_phase(cfg, frames, uploads, inputs, results, recorded, syncs, reads, events, dev,
                 card):
    front = _paths_ms("make_frame_rgbd 640x480/1000", lambda gd: make_frame_rgbd(*gd, cfg),
                      uploads[:6], card)
    track_items = [a for i, a in enumerate(inputs, start=1) if i % KF_EVERY][:6]
    step = _paths_ms("tracking step (full_tracking_step_from_images, front end included)",
                     lambda a: tracking_step.full_tracking_step_from_images(*a),
                     track_items, card)
    # the same steps on the frames already extracted: the tracking alone
    given = [a[:2] + (r.frame,) + a[3:12] for a, r in zip(inputs, results)]
    track = _paths_ms("tracking alone (full_tracking_step, frame given)",
                      lambda a: tracking_step.full_tracking_step(*a), given[:6], card)
    ev_items = [e["args"] for e in events[1:6]]          # events with local BA
    event = _paths_ms("keyframe event (keyframe_pass)", lambda a: mapping_ops.keyframe_pass(*a),
                      ev_items, card)
    mapping_ops.HOST_READS["count"] = 0
    launch.reset_launches()
    for a in ev_items:
        mapping_ops.keyframe_pass(*a)
    torch.cuda.synchronize()
    event.update(hand_kernel_launches_per_event=sum(launch.LAUNCHES.values()) / len(ev_items),
                 host_reads_per_event=mapping_ops.HOST_READS["count"] / len(ev_items),
                 host_syncs_per_event=statistics.mean(e["syncs"] for e in events))
    launch.reset_launches()
    for a in inputs:
        tracking_step.full_tracking_step_from_images(*a)
    torch.cuda.synchronize()
    n_launch = sum(launch.LAUNCHES.values()) / len(inputs)
    for name, fn in (("tracking step", lambda: tracking_step.full_tracking_step_from_images(
            *inputs[0])), ("keyframe event", lambda: mapping_ops.keyframe_pass(*ev_items[0]))):
        launch.reset_launches()
        evs = _profile(fn, 1)
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:10]
        hand = sum(e.count for e in evs
                   if any(f"{k}(" in e.key or f"{k}<" in e.key for k in HAND_KERNELS))
        log(f"[timing] {card}: device time of one {name} by kernel (profiler): "
            f"{sum(e.count for e in evs)} device activities, {hand} of the "
            f"{sum(launch.LAUNCHES.values())} hand-kernel launches among them; " +
            "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top))
        if name == "tracking step":
            step.update(device_launches_per_frame=sum(e.count for e in evs))
        else:
            event.update(device_launches_per_event=sum(e.count for e in evs))
    step.update(hand_kernel_launches_per_frame=n_launch,
                host_syncs_per_frame=statistics.mean(syncs), step_reads_per_frame=reads)
    log(f"[timing] {card}: tracking step: {n_launch:.1f} hand-kernel launches per frame, "
        f"{step['host_syncs_per_frame']:.2f} host syncs per frame; keyframe event: "
        f"{event['hand_kernel_launches_per_event']:.1f} hand-kernel launches, "
        f"{event['host_reads_per_event']:.1f} host reads, "
        f"{event['host_syncs_per_event']:.1f} host syncs per event")
    log(f"[result] {card}: " + json.dumps({"frame_ms": front, "step_ms": step,
                                           "track_ms": track, "event_ms": event}))

    # the two device clocks on a torch kernel the profiler does record
    big = torch.ones(1 << 24, device=dev)
    q_ms, (p_ms, p_n) = _queued_ms(lambda: big.mul_(1.0)), _device_ms(lambda: big.mul_(1.0))
    log(f"[timing] {card}: a 64 MB in-place multiply: {q_ms:.4f} ms queued behind a sleeping "
        f"kernel, {p_ms:.4f} ms by the profiler ({p_n:.1f} device activities per call)")

    img = torch.from_numpy(frames[0][0]).to(dev).to(torch.float32)
    pyr, brief, front = _front_calls(cfg, img, dev)
    k4 = recorded["best_two"][0]
    k4n = _synthetic_node(np.random.default_rng(3), 2048, 2048, 1, dev)
    k5 = recorded["proj_match"][0]
    k6 = recorded["pose_lm"][0]
    k7 = k6[:6] + (k6[6].to(torch.float32), True)
    k8 = recorded["epi_match"][-1]
    k9 = recorded["ba_edge@event"][0]
    # the bytes and operations each kernel's function needs on these inputs:
    # the gates of K4, K5 and K8 only on the pairs whose row and column masks
    # hold (one mask test per row and per column; K8 also its lines, 15 a
    # row and neighbour, and its epipole test, 5 a feature), the Hamming
    # distance only for the candidates (the data-dependent counts from the
    # twins' masks); K3, K4, K5, K8 and K9 count the bytes of `_*_bytes`,
    # the rest every input once and every output once (K1-K3: `_front_calls`)
    cand4 = cm.window_candidates(*k4[:5], *k4[6:10], k4[11])
    n4, pairs4 = int(cand4.sum()), int(k4[4].sum()) * int(k4[9].sum())
    cand4n = cm.node_candidates(k4n[0], k4n[2], k4n[3], k4n[5])
    cand5 = cm.projection_candidates(*k5[:5], *k5[6:10])
    n5 = int(cand5.sum())
    pairs5 = int(k5[4].sum()) * int(k5[9].sum())
    rows8 = cm.epi_rows(*k8)
    cand8 = [cm.epi_candidates(rows8[1], *(t[b] for t in rows8[2:5]),
                               *(t[b] for t in rows8[6:])) for b in range(k8[6].shape[0])]
    n8 = sum(int(c.sum()) for c in cand8)
    r8, pairs8 = int(rows8[1].sum()), int(rows8[1].sum()) * int((rows8[7] & rows8[9]).sum())
    e6, e9 = k6[2].shape[0], k9[5].numel()
    calls = {   # kernel: (shapes, kernel call, twin call, inputs or bytes, operations)
        **front,
        "best_two": (f"{k4[0].shape[0]}x{k4[6].shape[0]}, the motion-model search of frame 1 "
                     f"(gate and best-two, one launch)",
                     lambda: cm.window_best_two(*k4), lambda: cm.window_best_two_plain(*k4),
                     _proj_match_bytes(k4, cand4),
                     k4[4].numel() + k4[9].numel() + 12 * pairs4 + 24 * n4),
        "best_two_node": ("2048x2048, every node 0 (the tracking fallback's and "
                          "relocalization's gate), synthetic (gate and best-two, one launch)",
                          lambda: cm.node_best_two(*k4n), lambda: cm.node_best_two_plain(*k4n),
                          _node_bytes(k4n, cand4n),
                          int((k4n[2] & (k4n[0] >= 0)).sum()) * k4n[3].shape[0]
                          + 24 * int(cand4n.sum())),
        "proj_match": (f"{k5[0].shape[0]} local points x {k5[6].shape[0]} keypoints, frame 1",
                       lambda: cm.projection_best_two(*k5),
                       lambda: cm.projection_best_two_plain(*k5),
                       _proj_match_bytes(k5, cand5),
                       k5[4].numel() + k5[9].numel() + 12 * pairs5 + 24 * n5),
        "pose_lm": (f"E={e6}, 4x10, frame 1", lambda: cp.pose_lm(*k6),
                    lambda: cp.pose_lm_plain(*k6), k6, 44 * 250 * e6),
        "pose_normal_eqs": (f"E={e6}, frame 1", lambda: cp.pose_normal_eqs(*k7),
                            lambda: cp.pose_normal_eqs_plain(*k7), k7, 250 * e6),
        "epi_match": (f"B={k8[6].shape[0]} x N={k8[0].shape[1]}, the keyframe event's search "
                      f"from the map's rows (one launch)",
                      lambda: cm.epi_match_keyframes(*k8),
                      lambda: cm.epi_match_keyframes_plain(*k8),
                      _epi_match_bytes(k8, rows8, cand8),
                      rows8[1].numel() + rows8[7].numel() + 15 * r8 * k8[6].shape[0]
                      + 5 * int(rows8[7].sum()) + 9 * pairs8 + 24 * n8),
        "ba_edge": (f"the whole assembly (schur_ba._assemble), E={e9} ({k9[2].shape[0]} points "
                    f"x {k9[5].shape[1]}), C={k9[1].shape[0]}, keyframe event",
                    lambda: cb.ba_assemble(*k9), lambda: cb.ba_assemble_plain(*k9),
                    _ba_assemble_bytes(k9), 600 * e9),
    }
    # one PyTorch call of the same function, where there is one: K1's taps are
    # cv::resize INTER_LINEAR with pixel centres and clamped taps, which is
    # F.interpolate's bilinear without corner alignment or antialiasing
    # (one call per level of the cascade)
    sizes = [tuple(p.shape) for p in pyr[1:]]
    libraries = {"pyramid": lambda: _interpolate_pyramid(img, sizes)}
    per_call = {}
    for name, (shapes, kernel, twin, ins, ops) in calls.items():
        reps = 10 if name == "pose_lm" else 50
        ms, plain_ms = _event_ms(kernel, reps), _event_ms(twin, reps)
        launch.reset_launches()
        kernel()
        launched = sum(launch.LAUNCHES.values())
        dev_k = _queued_ms(kernel)
        (prof_k, prof_n), (dev_t, _) = _device_ms(kernel, 10), _device_ms(twin, 10)
        n_bytes = ins if isinstance(ins, int) else _nbytes(ins) + _nbytes(kernel())
        bound_ms, bound_by = _bound(n_bytes, ops)
        per_call[name] = dict(ms=ms, plain_ms=plain_ms, device_ms=dev_k, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=None, launches_per_call=launched)
        lib = ""
        if name in libraries:
            lib_ms, lib_dev = _event_ms(libraries[name], reps), _queued_ms(libraries[name])
            diff = max(_max_abs(a, b) for a, b in zip(libraries[name](), kernel()[1:]))
            per_call[name].update(library_ms=lib_ms, library_device_ms=lib_dev)
            lib = (f"; the library call {lib_ms:.4f} ms per call, device time {lib_dev:.4f} ms "
                   f"(queued), max |diff| from the kernel {diff:.3g}")
        log(f"[timing] {card}: {name} ({shapes}): per call (CUDA events, back to "
            f"back) kernel {ms:.4f} ms, twin {plain_ms:.4f} ms; device time kernel "
            f"{dev_k:.4f} ms (calls queued behind a sleeping kernel; the profiler reads "
            f"{prof_k:.4f} from {prof_n:.1f} device activities per call of {launched} "
            f"launches), twin {dev_t:.4f} ms (profiler); bound {bound_ms:.4f} ms by "
            f"{bound_by} ({n_bytes} bytes, {ops:.3g} operations){lib}")
        if dev_k < bound_ms:
            raise AssertionError(f"{name}: device time {dev_k:.4f} ms below its bound "
                                 f"{bound_ms:.4f} ms: the bound counts work the function "
                                 f"does not need")
    fusion = recorded["proj_match@event"][-1]
    union_ms = _queued_ms(lambda: cm.projection_best_two(*fusion))
    per_call["proj_match"]["fusion_union_device_ms"] = union_ms
    log(f"[timing] {card}: proj_match at fusion's union ({fusion[0].shape[0]} points x "
        f"{fusion[6].shape[0]} keypoints): kernel {_event_ms(lambda: cm.projection_best_two(*fusion)):.4f}"
        f" ms, twin {_event_ms(lambda: cm.projection_best_two_plain(*fusion), 10):.4f} ms per call; "
        f"device time kernel {union_ms:.4f} ms (queued)")
    tiles = _synthetic_proj_tiles(np.random.default_rng(2), dev)[0]
    cand_t = cm.projection_candidates(*tiles[:5], *tiles[6:10])
    t_ms, t_dev = _event_ms(lambda: cm.projection_best_two(*tiles)), \
        _queued_ms(lambda: cm.projection_best_two(*tiles))
    t_bound, t_by = _bound(_proj_match_bytes(tiles, cand_t),
                           tiles[4].numel() + tiles[9].numel()
                           + 12 * int(tiles[4].sum()) * int(tiles[9].sum()) + 24 * int(cand_t.sum()))
    # the same points against the set's first tile alone: what the second tile adds
    one = tiles[:6] + tuple(t[:cm.PROJ_TILE].contiguous() for t in tiles[6:])
    one_dev = _queued_ms(lambda: cm.projection_best_two(*one))
    per_call["proj_match"].update(n16384_ms=t_ms, n16384_device_ms=t_dev,
                                  n16384_bound_ms=t_bound, n8192_same_points_device_ms=one_dev)
    log(f"[timing] {card}: proj_match at N=16384 keypoints (two tiles) x P=8192 points, "
        f"synthetic: per call {t_ms:.4f} ms, device time {t_dev:.4f} ms (queued), bound "
        f"{t_bound:.4f} ms by {t_by}; the set's first 8192 keypoints alone (one tile): device "
        f"time {one_dev:.4f} ms")
    if t_dev < t_bound:
        raise AssertionError(f"proj_match at N=16384: device time {t_dev:.4f} ms below its "
                             f"bound {t_bound:.4f} ms")
    table_bound = _bound(_brief_bytes(brief, tables=True), 1024 * brief[1].shape[0])[0]
    per_call["brief"]["table_bound_ms"] = table_bound
    log(f"[timing] {card}: brief's bound with the parent's (N, 512) offset tables in place of "
        f"the rotation's inputs: {table_bound:.4f} ms (this function: "
        f"{per_call['brief']['bound_ms']:.4f} ms)")
    per_call["pose_lm"]["split"] = k6_split(k6, card)
    per_call["best_two"]["split"], per_call["epi_match"]["split"] = search_split(k4, k8, card)
    return per_call


def search_split(k4, k8, card):
    """K4's window form and K8 split on the queued clock by what their
    inputs ask of them: K4 with every source invalid is the launch, the
    staging and the sort of the targets alone; K8 with every kf1 feature
    bound is the launch and the row compaction, with every neighbour feature
    bound it adds the column compaction (no gate, no row)."""
    no_rows = k4[:4] + (torch.zeros_like(k4[4]),) + k4[5:]
    k4_split = {"staging_and_sort_ms": _queued_ms(lambda: cm.window_best_two(*no_rows)),
                "whole_ms": _queued_ms(lambda: cm.window_best_two(*k4))}
    bound1, bound2 = k8[0].clone(), k8[0].clone()
    bound1.index_fill_(0, k8[5].reshape(1), 0)
    bound2.index_fill_(0, k8[6], 0)
    k8_split = {"rows_only_ms": _queued_ms(lambda: cm.epi_match_keyframes(bound1, *k8[1:])),
                "rows_and_columns_ms": _queued_ms(lambda: cm.epi_match_keyframes(bound2,
                                                                                 *k8[1:])),
                "whole_ms": _queued_ms(lambda: cm.epi_match_keyframes(*k8))}
    log(f"[timing] {card}: best_two window form split (device time, queued): every source "
        f"invalid (launch, staging, sort) {k4_split['staging_and_sort_ms']:.4f} ms, the search "
        f"{k4_split['whole_ms']:.4f} ms; epi_match split: every kf1 feature bound (launch, row "
        f"compaction) {k8_split['rows_only_ms']:.4f} ms, every neighbour feature bound (+ the "
        f"column compaction) {k8_split['rows_and_columns_ms']:.4f} ms, the search "
        f"{k8_split['whole_ms']:.4f} ms")
    return k4_split, k8_split


def k6_split(k6, card):
    """K6's time split by its schedule (rounds x iterations), on the queued
    clock: 1x0 is the launch, one sweep and the reclassification; 2x0 adds a
    sweep (with its reduction and barriers) and a reclassification; the
    slope from 1x0 to 1x10 is one LM iteration, a sweep plus the 6x6 solve,
    the retract and the accept test."""
    split = {f"{r}x{i}_ms": _queued_ms(lambda r=r, i=i: cp.pose_lm(*k6[:7], r, i))
             for r, i in ((1, 0), (2, 0), (1, 10), (4, 10))}
    split["per_iteration_ms"] = (split["1x10_ms"] - split["1x0_ms"]) / 10
    split["per_sweep_ms"] = split["2x0_ms"] - split["1x0_ms"]
    split["solve_ms"] = split["per_iteration_ms"] - split["per_sweep_ms"]
    log(f"[timing] {card}: pose_lm split (E={k6[2].shape[0]}, device time, queued): " +
        ", ".join(f"{k[:-3]} {v:.4f} ms" for k, v in split.items() if "x" in k) +
        f"; one LM iteration {split['per_iteration_ms'] * 1e3:.2f} us = a sweep "
        f"{split['per_sweep_ms'] * 1e3:.2f} us + the solve, retract and accept "
        f"{split['solve_ms'] * 1e3:.2f} us")
    return split


def _interpolate_pyramid(img, sizes):
    """K1's function by PyTorch's own resize: each level from the one before
    by F.interpolate (bilinear, pixel centres, no antialiasing)."""
    out = [img]
    for h, w in sizes:
        out.append(torch.nn.functional.interpolate(
            out[-1][None, None], size=(h, w), mode="bilinear", align_corners=False,
            antialias=False)[0, 0])
    return out[1:]


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


def _system_lap(cfg, voc, frames, depth, dev, times=None):
    """A fresh SlamSystem over the frames (host arrays, as a camera hands
    them over) with the natural keyframe policy, then flush(). Returns the
    system and the tracking state after each call; with `times`, the wall
    ms of each call (a synchronous call returns with its pose on the host)."""
    s = system.SlamSystem(cfg, vocabulary=voc, enable_loop_closing=False, pipeline_depth=depth,
                          device=dev)
    states = []
    for i, (gray, depth_img) in enumerate(frames):
        t0 = time.perf_counter()
        s.track_rgbd(gray, depth_img, i / cfg.fps)
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
        states.append(s.state)
    s.flush()
    torch.cuda.synchronize()
    return s, states


def _check_lap(name, s, states, poses, cfg, ref):
    """A lap against the reference's: the same state after every call,
    as many keyframes, each within SYSTEM_KF_SLACK frames of the reference's,
    ATE at most 2x the reference's + 1 cm, a finite map. Returns (keyframe
    frames, ATE)."""
    kf = sorted(e["frame"] for e in s.metrics if e.get("kf"))
    gt = [(i / cfg.fps, T) for i, T in enumerate(poses)]
    ate = trajectory.ate_rmse(s.get_trajectory(), gt)
    ref_kf, ref_ate = ref[f"{name}_kf_frames"], ref[f"{name}_ate_m"]
    log(f"[system] {name} lap: states {states}; keyframes at frames {kf} (reference {ref_kf}); "
        f"{int(s.m.n_keyframes)} keyframes, {int(s.m.n_points)} points; ATE {ate * 100:.3f} cm "
        f"(reference {ref_ate * 100:.3f} cm)")
    if states != ref[f"{name}_states"]:
        raise AssertionError(f"{name} lap: states {states} != the reference's "
                             f"{ref[f'{name}_states']}")
    if len(kf) != len(ref_kf) or any(abs(a - b) > SYSTEM_KF_SLACK for a, b in zip(kf, ref_kf)):
        raise AssertionError(f"{name} lap: keyframes at {kf}, the reference's at {ref_kf} "
                             f"(each within {SYSTEM_KF_SLACK} frames required)")
    if not ate <= 2 * ref_ate + 0.01:
        raise AssertionError(f"{name} lap: ATE {ate:.4f} m > 2 x the reference's {ref_ate:.4f} "
                             f"m + 1 cm")
    bad = _map_finite(s.m)
    if bad:
        raise AssertionError(f"{name} lap: non-finite {bad} in the map")
    return kf, ate


def system_phase(cfg, poses, frames, voc, dev, card):
    """The port's entry point as a user calls it: SlamSystem.track_rgbd over
    the sequence's frames with the natural keyframe policy and the 10^6-word
    vocabulary (a synchronous lap), a kidnap (state LOST, then the render of
    a mapped pose must relocalize: BoW candidates, K4's node form, EPnP
    RANSAC, K6, K4's window form in the rescue rounds; twice, the second
    timed warm), a fresh system with
    the pipelined stream at depth 3, and the trajectory through save_tum /
    load_tum. Counts set to 0 before, read after. Returns the launches and
    the phase's timings."""
    launch.reset_launches()
    times = []
    s, states = _system_lap(cfg, voc, frames, 0, dev, times)
    kf, ate = _check_lap("sync", s, states, poses, cfg, REFERENCE_SYSTEM)

    s.state = system.LOST
    gray, depth_img = frames[KIDNAP_POSE]
    t0 = time.perf_counter()
    T = s.track_rgbd(gray, depth_img, 99.0)
    reloc_ms = (time.perf_counter() - t0) * 1e3
    err = None if T is None else _centre_error(torch.from_numpy(T), poses[0], poses[KIDNAP_POSE])
    log(f"[system] kidnap: state LOST, then the render of pose {KIDNAP_POSE}: "
        f"{'relocalized' if T is not None else 'not relocalized'} to keyframe {s.ref_kf} "
        f"(reference {REFERENCE_SYSTEM['kidnap_kf']}), camera-centre error "
        f"{'-' if err is None else f'{err * 100:.3f}'} cm (reference "
        f"{REFERENCE_SYSTEM['kidnap_err_m'] * 100:.3f} cm), state {s.state}")
    if T is None or s.state != system.OK or not err < 0.05:
        raise AssertionError(f"kidnap: relocalization failed (pose {T is not None}, state "
                             f"{s.state}, centre error {err})")
    # the same kidnap again: the first relocalization of the process also
    # pays the first use of what only relocalization calls (the batched
    # eigh / SVD / solves of EPnP RANSAC)
    s.state = system.LOST
    t0 = time.perf_counter()
    T2 = s.track_rgbd(gray, depth_img, 100.0)
    reloc2_ms = (time.perf_counter() - t0) * 1e3
    err2 = None if T2 is None else _centre_error(torch.from_numpy(T2), poses[0],
                                                 poses[KIDNAP_POSE])
    if T2 is None or not err2 < 0.05:
        raise AssertionError(f"second kidnap: relocalization failed (centre error {err2})")

    t0 = time.perf_counter()
    st, st_states = _system_lap(cfg, voc, frames, STREAM_DEPTH, dev)
    stream_s = time.perf_counter() - t0
    _, st_ate = _check_lap("stream", st, st_states, poses, cfg, REFERENCE_SYSTEM)
    if not st_ate <= max(3 * ate, 0.03):
        raise AssertionError(f"stream lap: ATE {st_ate:.4f} m > max(3 x the sync lap's "
                             f"{ate:.4f} m, 3 cm)")
    torch.cuda.synchronize()
    launches = dict(launch.LAUNCHES)

    path = os.path.join(ROOT, "_scratch", "system_trajectory.tum")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    traj = st.get_trajectory()
    trajectory.save_tum(path, traj)
    back = trajectory.load_tum(path)
    dT = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(traj, back))
    if len(back) != len(traj) or [round(t, 6) for t, _ in traj] != [t for t, _ in back] \
            or dT > 1e-5:
        raise AssertionError(f"save_tum / load_tum: {len(back)} of {len(traj)} poses back, "
                             f"max |diff| {dT:.3g}")
    log(f"[system] save_tum / load_tum: {len(back)} poses back, max |diff| {dT:.2g}")
    missing = [k for k, v in launches.items() if v == 0 and k != "pose_normal_eqs"]
    log(f"[system] launches over the phase (sync lap, kidnap, stream lap): {launches}")
    if missing:
        raise AssertionError(f"[system] phase: kernels never launched: {missing}")

    is_kf = set(kf)
    plain = [t for i, t in enumerate(times) if i and i not in is_kf]
    at_kf = [t for i, t in enumerate(times) if i in is_kf]
    res = {"sync_track_ms_median": statistics.median(plain),
           "sync_keyframe_track_ms_median": statistics.median(at_kf),
           "sync_init_ms": times[0], "stream_fps": (len(frames) - 1) / stream_s,
           "stream_depth": STREAM_DEPTH, "reloc_ms": reloc_ms, "reloc_again_ms": reloc2_ms,
           "sync_ate_m": ate,
           "stream_ate_m": st_ate, "kidnap_err_m": err, "keyframes_sync": len(kf)}
    log(f"[system] {card}: track_rgbd median {res['sync_track_ms_median']:.2f} ms per frame "
        f"({len(plain)} frames without a keyframe), {res['sync_keyframe_track_ms_median']:.2f} "
        f"ms per keyframe frame ({len(at_kf)}), initialization {times[0]:.1f} ms; stream "
        f"(depth {STREAM_DEPTH}) {res['stream_fps']:.2f} frames per second over "
        f"{len(frames) - 1} frames and the flush; the kidnap frame's relocalization "
        f"{reloc_ms:.1f} ms, the same kidnap again {reloc2_ms:.1f} ms")
    return launches, res


# ---------------------------------------------------------------------------
# [loop]: loop closing through SlamSystem on the figure eight
# ---------------------------------------------------------------------------

LOOP_STAGES = (("detect", "detect_loop_dispatch"), ("bow_gate", "bow_gate"),
               ("compute_sim3", "compute_sim3"),
               ("correct_loop", "correct_loop"), ("propagate", "_propagate_and_fuse"),
               ("fuse", "fuse_loop_points"), ("essential_graph", "_essential_graph"),
               ("gba_chunk", "run_global_ba"))
LOOP_RECORDED = ("window_open", "window_loop_projection", "node_all_pairs", "proj_loop_fusion",
                 "ba_gba")


def _named(fn, args):
    """A kernel wrapper's positional arguments by parameter name."""
    return inspect.signature(fn).bind(*args).arguments


@contextmanager
def loop_instruments(cfg, stages, rec, k9_gba):
    """Time each loop-closing stage (synchronized wall ms, in `stages` as
    (name, closures so far, ms)), record the first inputs the loop path
    hands K4 (window form with open octaves, its loop-projection count, the
    node form on all pairs), K5 (the loop fusion) and K9 at C = capacity_kf,
    and the first essential-graph problem, into `rec`, and count K9's launches inside run_global_ba (the launch
    counter's growth over each call) in `k9_gba`. The stages inside
    compute_sim3 / correct_loop / run_global_ba mark where a kernel call
    comes from; a kernel's arguments are read by name."""
    where = []
    closures = [0]
    saved = {name: getattr(loop_closing, fn) for name, fn in LOOP_STAGES}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            where.append(name)
            k9_before = launch.LAUNCHES["ba_edge"]
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            finally:
                where.pop()
            if name == "gba_chunk":
                k9_gba[0] += launch.LAUNCHES["ba_edge"] - k9_before
            stages.append((name, closures[0], (time.perf_counter() - t0) * 1e3))
            if name == "correct_loop":
                closures[0] += 1
            return out
        return call

    kernels = {"window": (cm, "window_best_two"), "node": (cm, "node_best_two"),
               "proj": (cm, "projection_best_two"), "k9": (cb, "ba_assemble")}
    k_saved = {k: getattr(mod, name) for k, (mod, name) in kernels.items()}

    def keep(key, args):
        if key not in rec:
            rec[key] = args

    def window(*args):
        if _named(k_saved["window"], args)["octaves"] == (cm.OPEN, cm.OPEN):
            keep("window_open", args)
        elif where and where[-1] == "compute_sim3":
            keep("window_loop_projection", args)
        return k_saved["window"](*args)

    def node(*args):
        if where and where[-1] == "compute_sim3":
            keep("node_all_pairs", args)
        return k_saved["node"](*args)

    def proj(*args):
        if "fuse" in where:
            keep("proj_loop_fusion", args)
        return k_saved["proj"](*args)

    def k9(*args):
        if "gba_chunk" in where:
            C = _named(k_saved["k9"], args)["poses"].shape[0]
            if C != cfg.max_keyframes:
                raise AssertionError(f"[loop] global BA assembled at C={C}")
            keep("ba_gba", args)
        return k_saved["k9"](*args)

    essential = loop_closing.essential_problem

    def essential_recorded(*args, **kw):
        prob = essential(*args, **kw)
        keep("essential", prob)
        return prob

    for name, fn in LOOP_STAGES:
        setattr(loop_closing, fn, timed(name, saved[name]))
    for k, f in (("window", window), ("node", node), ("proj", proj), ("k9", k9)):
        setattr(kernels[k][0], kernels[k][1], f)
    loop_closing.essential_problem = essential_recorded
    try:
        yield
    finally:
        loop_closing.essential_problem = essential
        for name, fn in LOOP_STAGES:
            setattr(loop_closing, fn, saved[name])
        for k, (mod, name) in kernels.items():
            setattr(mod, name, k_saved[k])


def _track_frame(s, frame, t):
    """One frame through the entry point of the system's sensor: (gray,
    depth) RGB-D, (left, right) stereo, a gray image monocular."""
    if s.cfg.sensor == SENSOR_STEREO:
        return s.track_stereo(*frame, t)
    if s.cfg.sensor == SENSOR_MONOCULAR:
        return s.track_monocular(frame, t)
    return s.track_rgbd(*frame, t)


def _loop_lap(cfg, voc, frames, dev, times=None, syncs=None, closure_nb=None, depth=0,
              states=None, front=None, enable_loops=True):
    """A fresh SlamSystem with its defaults (loop closing on, 4 amortized
    GBA chunks) over the frames (any iterable, through `_track_frame`), then
    flush(). With `times`, each call's wall ms; with `syncs`, each call's
    host syncs (torch's sync debug mode); with `closure_nb`, each closure's
    candidate's covisible keyframes' frames; with `states`, the state after
    each call; with `front`, each call's K1, K2 and K3 launches. `depth`:
    the pipelined stream's depth; `enable_loops=False` turns loop closing
    off."""
    s = system.SlamSystem(cfg, vocabulary=voc, pipeline_depth=depth, device=dev,
                          enable_loop_closing=enable_loops)
    saved = loop_closing.correct_loop
    if closure_nb is not None:
        def correct(cfg_, m, kf_id, cand_id, Scm, **kw):
            nb = ((m.covis[cand_id] > 0) & m.kf_valid).cpu().numpy()
            fid = m.kf_frame_id.cpu().numpy()
            closure_nb.append(sorted(int(f) for f in fid[np.nonzero(nb)[0]]))
            return saved(cfg_, m, kf_id, cand_id, Scm, **kw)
        loop_closing.correct_loop = correct
    try:
        for i, frame in enumerate(frames):
            before = [launch.LAUNCHES[k] for k in FRONT_KERNELS]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if syncs is not None:
                    torch.cuda.set_sync_debug_mode(1)
                t0 = time.perf_counter()
                try:
                    _track_frame(s, frame, i / cfg.fps)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if times is not None:
                    times.append((time.perf_counter() - t0) * 1e3)
            if syncs is not None:
                syncs.append(sum("synchroniz" in str(w.message) for w in caught))
            if states is not None:
                states.append(s.state)
            if front is not None:
                front.append(tuple(launch.LAUNCHES[k] - b for k, b in zip(FRONT_KERNELS, before)))
        s.flush()
        torch.cuda.synchronize()
    finally:
        loop_closing.correct_loop = saved
    return s


def _genuine(poses, closure):
    """A closure joins two views of one place: the true camera centres of
    its keyframe's and its candidate's frames within GENUINE_LOOP_M, their
    optical axes within GENUINE_LOOP_DEG (poses camera-to-world)."""
    a, b = poses[closure["kf_frame"]], poses[closure["cand_frame"]]
    return bool(np.linalg.norm(a[:3, 3] - b[:3, 3]) <= GENUINE_LOOP_M and
                a[:3, 2] @ b[:3, 2] >= np.cos(np.radians(GENUINE_LOOP_DEG)))


def closure_misses(n_loops, got, closure_nb, ref, poses, extra_loops=False):
    """A run's closures (`got`, each with its keyframe sequence number and
    frames; `closure_nb`, each one's candidate's covisible keyframes'
    frames) against the reference's record: each of the reference's
    closures matched by one of the run's at its keyframe sequence number
    within LOOP_KF_SLACK with the reference's candidate or one of its
    covisible keyframes; as many closures as the reference's, or with
    `extra_loops` more where each extra one is genuine (`_genuine`).
    Returns what is wrong, in that order (empty when nothing is)."""
    misses = []
    if n_loops < ref["loops"] or (not extra_loops and n_loops != ref["loops"]):
        misses.append(f"{n_loops} loops closed, the reference {ref['loops']}")
    matched = []
    for r in ref["closures"]:
        hit = [i for i, (c, nb) in enumerate(zip(got, closure_nb)) if i not in matched and
               abs(c["kf_seq"] - r["kf_seq"]) <= LOOP_KF_SLACK and
               (c["cand_frame"] == r["cand_frame"] or c["cand_frame"] in
                r["cand_neighbour_frames"] or r["cand_frame"] in nb)]
        if not hit:
            misses.append(f"no closure within {LOOP_KF_SLACK} keyframes of the reference's at "
                          f"keyframe {r['kf_seq']} with its candidate (frame {r['cand_frame']}) "
                          f"or one covisible with it: "
                          f"{[(c['kf_seq'], c['cand_frame']) for c in got]}")
            continue
        matched.append(hit[0])
    extra = [c for i, c in enumerate(got) if i not in matched]
    if any(not _genuine(poses, c) for c in extra):
        misses.append(f"a closure the reference did not make joins two places: "
                      f"{[(c['kf_frame'], c['cand_frame']) for c in extra]}")
    return misses


def check_row(rec, ref, poses):
    """An evaluation row's record (`rec`: frames, tracked, keyframes_inserted,
    loops, closures each with its candidate's covisible frames under
    cand_neighbour_frames, ate_m) against the reference's (`ref`; a list of
    runs for loop-mono), poses the row's ground truth (camera-to-world):
    LOOP_TRACKED_FLOOR of the frames tracked (above the evaluation's 90 %
    "ok"), the keyframes inserted within KF_COUNT_SLACK of the reference's
    (of its runs' range), the reference's closures with any other genuine
    (`closure_misses`; against several runs: at least the fewest runs'
    loops, each genuine), the ATE at most 2x the reference's (its runs'
    largest) + 1 cm. Returns what is wrong (empty when nothing is)."""
    misses = []
    n = rec["frames"]
    if rec["tracked"] < LOOP_TRACKED_FLOOR * n:
        misses.append(f"{rec['tracked']} of {n} frames tracked")
    runs = ref if isinstance(ref, list) else [ref]
    kf = [r["keyframes_inserted"] for r in runs]
    if not (1 - KF_COUNT_SLACK) * min(kf) <= rec["keyframes_inserted"] <= \
            (1 + KF_COUNT_SLACK) * max(kf):
        misses.append(f"{rec['keyframes_inserted']} keyframes inserted, the reference {kf}")
    if isinstance(ref, list):
        if rec["loops"] < min(r["loops"] for r in runs):
            misses.append(f"{rec['loops']} loops closed, the reference runs "
                          f"{[r['loops'] for r in runs]}")
        if any(not _genuine(poses, c) for c in rec["closures"]):
            misses.append(f"a closure joins two places: "
                          f"{[(c['kf_frame'], c['cand_frame']) for c in rec['closures']]}")
    else:
        misses += closure_misses(rec["loops"], rec["closures"],
                                 [c["cand_neighbour_frames"] for c in rec["closures"]], ref,
                                 poses, extra_loops=True)
    worst = max(r["ate_m"] for r in runs)
    if not rec["ate_m"] <= 2 * worst + 0.01:
        misses.append(f"ATE {rec['ate_m']:.4f} m > 2 x the reference's {worst:.4f} m + 1 cm")
    return misses


def _loop_check(cfg, s, poses, closure_nb, ref, tag="[loop]", extra_loops=False):
    """The run against the reference's: its closures (`closure_misses`),
    the frames tracked, the ATE, a finite map, the loop edges. Returns (the
    ATE, the frames tracked)."""
    gt = [(i / cfg.fps, T) for i, T in enumerate(poses)]
    traj = s.get_trajectory()
    ate = trajectory.ate_rmse(traj, gt)
    got = s.loop_closures
    log(f"{tag} {len(traj)} of {len(poses)} frames tracked, {s._kf_seq_host} keyframes "
        f"inserted, {int(s.m.n_keyframes)} in the map, {int(s.m.n_points)} points; "
        f"{s.n_loops_closed} loops closed at "
        f"{[(c['kf_seq'], c['kf_frame'], c['cand_frame']) for c in got]} (keyframe sequence "
        f"number, frame, candidate's frame; reference {ref['loops']} at "
        f"{[(c['kf_seq'], c['kf_frame'], c['cand_frame']) for c in ref['closures']]}); ATE "
        f"{ate * 100:.3f} cm (reference {ref['ate_m'] * 100:.3f} cm)")
    misses = closure_misses(s.n_loops_closed, got, closure_nb, ref, poses, extra_loops)
    if misses:
        raise AssertionError(f"{tag} {misses[0]}")
    if len(traj) < LOOP_TRACKED_FLOOR * len(poses):
        raise AssertionError(f"{tag} {len(traj)} of {len(poses)} frames tracked")
    if not ate <= 2 * ref["ate_m"] + 0.01:
        raise AssertionError(f"{tag} ATE {ate:.4f} m > 2 x the reference's {ref['ate_m']:.4f} "
                             f"m + 1 cm")
    bad = _map_finite(s.m)
    if bad:
        raise AssertionError(f"{tag} non-finite {bad} in the map")
    edges = {tuple(e) for e in s.m.loop_edges.cpu().tolist()}
    if any((c["kf"], c["cand"]) not in edges for c in got):
        raise AssertionError(f"{tag} loop_edges {sorted(edges)} lack a closure's pair")
    return ate, len(traj)


def _loop_kernel_parity(rec, errs):
    """The loop path's kernel inputs against the twins, bit for bit: K4's
    window form with open octaves (SearchBySim3) and at the loop projection
    count, its node form on all pairs (SearchByBoW), K5 in the loop fusion,
    every field of K9's assembly at C = capacity_kf."""
    missing = [k for k in LOOP_RECORDED if k not in rec]
    if missing:
        raise AssertionError(f"[loop] the loop path handed no input to {missing}")
    for key, kernel, twin, name in (
            ("window_open", cm.window_best_two, cm.window_best_two_plain, "best_two"),
            ("window_loop_projection", cm.window_best_two, cm.window_best_two_plain, "best_two"),
            ("node_all_pairs", cm.node_best_two, cm.node_best_two_plain, "best_two_node"),
            ("proj_loop_fusion", cm.projection_best_two, cm.projection_best_two_plain,
             "proj_match")):
        args = rec[key]
        for a, b, what in zip(kernel(*args), twin(*args), ("best", "index", "second")):
            _require_equal(f"[loop] {name} {key} {what}", a, b)
    k9 = rec["ba_gba"]
    got, want = cb.ba_assemble(*k9), cb.ba_assemble_plain(*k9)
    a9 = _named(cb.ba_assemble, k9)
    C9, E9 = a9["poses"].shape[0], a9["edge_mask"].numel()
    _lin_equal(f"[loop] K9 at C={C9}, E={E9}, robust off", schur_ba.Lin(*got),
               schur_ba.Lin(*want), errs)

    def sizes(key, fn, src, dst):
        a = _named(fn, rec[key])
        return f"{a[src].shape[0]} x {a[dst].shape[0]}"
    log(f"[loop] K4 (window form, open octaves: "
        f"{sizes('window_open', cm.window_best_two, 'uv', 'kp_xy')}; the loop projection count "
        f"{sizes('window_loop_projection', cm.window_best_two, 'uv', 'kp_xy')}), K4's node "
        f"form on all pairs ({sizes('node_all_pairs', cm.node_best_two, 'desc_a', 'desc_b')}), "
        f"K5 in the loop fusion "
        f"({sizes('proj_loop_fusion', cm.projection_best_two, 'uv', 'kp_xy')}) and K9 at "
        f"C={C9}, E={E9} (every field) equal their twins bit for bit")


def _ba_error(cfg, cam, prob, poses, points):
    """The global BA objective (sum of chi2 over the problem's edges, robust
    kernel off) at (poses, points), by one assembly."""
    sigma2 = torch.tensor(cfg.level_sigma2, dtype=torch.float32, device=points.device)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(prob.obs_level, 0, len(cfg.level_sigma2) - 1).long()]
    C = prob.poses.shape[0]
    mask = (prob.obs_cam >= 0) & prob.pt_valid[:, None] & \
        prob.cam_valid[torch.clamp(prob.obs_cam, 0, C - 1).long()]
    edges = schur_ba._edges(prob, inv_sigma2)
    return float(schur_ba._assemble(cam, prob, edges, poses, points, mask.to(torch.float32),
                                     False).err)


def _gba_step(cfg, cam, prob, lam):
    """One LM step of the global BA at the problem's state with damping
    lam: the camera step of the dense Schur solve, of PCG at 50 (as
    run_global_ba runs it) and at PCG_STEP_CG iterations, each against the
    exact step of the same linearization (the reduced camera system formed
    explicitly in float64 from K9's pieces, with exact 3x3 inverses).
    Returns the relative distances, each step's, and the extreme
    eigenvalues of that system."""
    C = prob.poses.shape[0]
    dev = prob.points.device
    sigma2 = torch.tensor(cfg.level_sigma2, dtype=torch.float32, device=dev)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(prob.obs_level, 0, len(cfg.level_sigma2) - 1).long()]
    mask = (prob.obs_cam >= 0) & prob.pt_valid[:, None] & \
        prob.cam_valid[torch.clamp(prob.obs_cam, 0, C - 1).long()]
    edges = schur_ba._edges(prob, inv_sigma2)
    lin = schur_ba._assemble(cam, prob, edges, prob.poses, prob.points,
                             mask.to(torch.float32), False)
    lam32 = torch.full((), lam, dtype=torch.float32, device=dev)
    free = prob.cam_valid & ~prob.cam_fixed
    f6 = free.repeat_interleave(6)

    Q, O = lin.chi2.shape
    lin64 = schur_ba.Lin(*(a.double() if a.is_floating_point() else a for a in lin))
    lam64 = lam32.double()
    Hpp = torch.where(lin.pt_on[:, None, None], schur_ba._damped(lin64.Hpp, lam64),
                      torch.eye(3, dtype=torch.float64, device=dev))
    W = torch.einsum("qoc,qoij->ciqj", edges.onehot.double().reshape(Q, O, C), lin64.We)
    WH = torch.einsum("ciqj,qjk->ciqk", W, torch.linalg.inv(Hpp)).reshape(C * 6, Q * 3)
    S = torch.block_diag(*schur_ba._damped(lin64.Hcc, lam64)) - WH @ W.reshape(C * 6, Q * 3).T
    b = lin64.bc.reshape(-1) - WH @ lin64.bp.reshape(-1)
    S, b = S[f6][:, f6], b[f6]
    exact = torch.linalg.solve(S, b)
    eig = torch.linalg.eigvalsh(S)
    del W, WH

    pre = pcg_ba._precompute(lin, lam32)
    rhs = pcg_ba._reduced_rhs(pre, edges, free)
    steps = {"dense": schur_ba._solve_step(prob, edges, lin, lam32)[0],
             "pcg_50": pcg_ba._pcg(pre, edges, rhs, free, 50),
             f"pcg_{PCG_STEP_CG}": pcg_ba._pcg(pre, edges, rhs, free, PCG_STEP_CG)}
    steps = {k: v.reshape(-1)[f6].double() for k, v in steps.items()}
    rel = {k: float((v - exact).norm() / exact.norm()) for k, v in steps.items()}
    rel[f"pcg_{PCG_STEP_CG}_vs_dense"] = float(
        (steps[f"pcg_{PCG_STEP_CG}"] - steps["dense"]).norm() / steps["dense"].norm())
    return rel, steps, (float(eig[0]), float(eig[-1]))


def _pcg_against_dense(cfg, m, dev, card):
    """PCG on the implicit Schur complement (`pcg_ba.solve_ba_pcg`) against
    the dense Schur solve (`schur_ba.solve_ba`) on the global BA problem of
    map m (the bench's capacities keep run_global_ba on the dense branch,
    so this puts pcg_ba on the card):
    - one LM step at LM's first damping (1e-4): both solvers' steps within
      PCG_STEP_RTOL of the exact step of the same linearization (PCG at
      PCG_STEP_CG iterations), i.e. the same reduced system;
    - the same at LM's least damping (1e-9), where the point blocks of
      points seen once without depth are singular in float32: the dense
      step finite (the distances reported);
    - run_global_ba's PCG_LM_ITERS LM iterations each (PCG at its 50 CG
      iterations a step): the poses within PCG_POSE_TOL and the points'
      median distance below PCG_POINT_TOL (tests/test_pcg_ba.py:13-22).
    Returns the numbers."""
    prob = loop_closing.global_ba_problem(cfg, m)
    cam = cfg.camera(dev)
    free = prob.cam_valid & ~prob.cam_fixed
    res = {}
    for lam in (1e-4, 1e-9):
        rel, steps, eig = _gba_step(cfg, cam, prob, lam)
        finite = bool(torch.isfinite(steps["dense"]).all())
        res[f"step_lam_{lam:g}"] = {**rel, "dense_finite": finite, "eig_min": eig[0],
                                    "eig_max": eig[1]}
        log(f"[loop] {card}: one global BA step at lambda {lam:g} (the float64 reduced system's "
            f"eigenvalues {eig[0]:.4g} .. {eig[1]:.4g}), each camera step's distance from the "
            f"exact one, relative: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
        if not finite:
            raise AssertionError(f"[loop] the dense global BA step at lambda {lam:g} is not "
                                 f"finite: {rel}")
        if lam == 1e-4 and not (rel["dense"] <= PCG_STEP_RTOL and
                                rel[f"pcg_{PCG_STEP_CG}"] <= PCG_STEP_RTOL):
            raise AssertionError(f"[loop] PCG and the dense solve part on one global BA step "
                                 f"(<= {PCG_STEP_RTOL} of the exact step required): {rel}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = schur_ba.solve_ba(cam, prob, cfg.level_sigma2, iters_a=PCG_LM_ITERS, iters_b=0,
                              robust=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pcg = pcg_ba.solve_ba_pcg(cam, prob, cfg.level_sigma2, n_iters=PCG_LM_ITERS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cam_diff = (pcg.poses - dense.poses)[free].abs().amax(dim=(1, 2))
    res.update({"dense_ms": (t1 - t0) * 1e3, "pcg_ms": (t2 - t1) * 1e3,
                "err_start": _ba_error(cfg, cam, prob, prob.poses, prob.points),
                "err_dense": _ba_error(cfg, cam, prob, dense.poses, dense.points),
                "err_pcg": _ba_error(cfg, cam, prob, pcg.poses, pcg.points),
                "pose_diff": float(cam_diff.max()),
                "point_diff_median_m": float(
                    (pcg.points - dense.points)[prob.pt_valid].norm(dim=-1).median()),
                "dense_moved": float((dense.poses - prob.poses)[free].abs().max())})
    log(f"[loop] {card}: PCG (50 CG iterations a step) against the dense Schur solve on the "
        f"final map's global BA (C={prob.poses.shape[0]}, {int(free.sum())} free cameras, "
        f"{int(prob.pt_valid.sum())} points, {PCG_LM_ITERS} LM iterations each): objective "
        f"{res['err_start']:.2f} -> dense {res['err_dense']:.3f}, PCG {res['err_pcg']:.3f}; "
        f"poses max |diff| {res['pose_diff']:.3e} (<= {PCG_POSE_TOL} required; the dense solve "
        f"moved them by up to {res['dense_moved']:.3f}); points median distance "
        f"{res['point_diff_median_m']:.3e} m (< {PCG_POINT_TOL} required); dense "
        f"{res['dense_ms']:.1f} ms, PCG {res['pcg_ms']:.1f} ms")
    if not (res["pose_diff"] <= PCG_POSE_TOL and res["point_diff_median_m"] < PCG_POINT_TOL):
        raise AssertionError(f"[loop] PCG parts from the dense solve: {res}")
    return res


def _median(xs):
    return statistics.median(xs) if xs else None


def loop_phase(cfg, voc, dev, card, errs, clean):
    """The port's loop closing through SlamSystem.track_rgbd on the
    figure eight: a timed lap (counts set to 0 before, read after), the
    checks against REFERENCE_LOOP, the loop path's kernel inputs against
    the twins, a second lap (its stages timed: the closure warm) and a
    third under torch's deterministic algorithms (both the same poses and
    map bit for bit), the per-frame host syncs against a lap with loop
    closing off, and PCG against the dense Schur solve on the final map's
    global BA problem. Returns (launches, K9's GBA-shape timing, the
    phase's results, what [multi] reuses: the poses, frames, the first
    lap's final map and ATE, the closure's essential problem)."""
    poses, frames = render_loop_frames(clean=clean)
    stages, rec, k9_gba, times, syncs, closure_nb = [], {}, [0], [], [], []
    launch.reset_launches()
    t0 = time.perf_counter()
    with loop_instruments(cfg, stages, rec, k9_gba):
        s = _loop_lap(cfg, voc, frames, dev, times, syncs, closure_nb)
    lap_s = time.perf_counter() - t0
    launches = dict(launch.LAUNCHES)
    ate, _ = _loop_check(cfg, s, poses, closure_nb, REFERENCE_LOOP)
    log(f"[loop] launches over the lap: {launches}; K9 at C={cfg.max_keyframes}: "
        f"{k9_gba[0]}")
    missing = [k for k in ("best_two", "best_two_node", "proj_match", "pose_lm", "ba_edge")
               if not launches[k]]
    if missing:
        raise AssertionError(f"[loop] kernels never launched: {missing}")
    if k9_gba[0] < cfg.gba_async_chunks * s.n_loops_closed:
        raise AssertionError(f"[loop] K9 at C={cfg.max_keyframes} launched {k9_gba[0]} times "
                             f"for {s.n_loops_closed} closures (at least "
                             f"{cfg.gba_async_chunks} each required)")
    _loop_kernel_parity(rec, errs)

    # the lap again, its stages timed: the process's second closure, warm
    # (and the same trajectory and map bit for bit)
    stages2 = []
    with loop_instruments(cfg, stages2, {}, [0]):
        warm = _loop_lap(cfg, voc, frames, dev)
    if _same_map(warm.m, s.m) or warm.loop_closures != s.loop_closures:
        raise AssertionError(f"[loop] a second lap differs in {_same_map(warm.m, s.m)}")
    del warm

    # the lap again under torch's deterministic algorithms: the same
    # trajectory, closures and map bit for bit, and no operation without a
    # deterministic implementation
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            again = _loop_lap(cfg, voc, frames, dev)
    finally:
        torch.use_deterministic_algorithms(False)
    offenders = Counter(str(w.message).split(".")[0][:90] for w in caught
                        if "determinis" in str(w.message))
    diff = _same_map(again.m, s.m)
    ta, tb = s.get_trajectory(), again.get_trajectory()
    if len(ta) != len(tb) or any(not np.array_equal(a, b) for (_, a), (_, b) in zip(ta, tb)):
        diff.append("trajectory")
    if again.loop_closures != s.loop_closures:
        diff.append("loop closures")
    if diff or offenders:
        raise AssertionError(f"[loop] a second lap under torch.use_deterministic_algorithms "
                             f"differs in {diff}; operations without a deterministic "
                             f"implementation: {dict(offenders)}")
    log(f"[loop] a second lap under torch.use_deterministic_algorithms: the trajectory, the "
        f"closures and the map ({len(s.m)} fields) identical bit for bit; no operation "
        f"without a deterministic implementation")

    # no new host sync on the per-frame path: a lap with loop closing off,
    # up to the first closure, syncs as often on each frame without a keyframe
    kf_frames = {e["frame"] for e in s.metrics if e.get("kf")}
    first = min([c["kf_frame"] for c in s.loop_closures] + [len(frames)])
    off_syncs = []
    off = system.SlamSystem(cfg, vocabulary=voc, enable_loop_closing=False, device=dev)
    for i, (gray, depth_img) in enumerate(frames[:first]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                off.track_rgbd(gray, depth_img, i / cfg.fps)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        off_syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    off_kf = {e["frame"] for e in off.metrics if e.get("kf")}
    plain = [i for i in range(1, first) if i not in kf_frames and i not in off_kf]
    moved = [i for i in plain if syncs[i] != off_syncs[i]]
    log(f"[loop] host syncs per frame without a keyframe, loop closing on / off, frames "
        f"1-{first - 1}: median {_median([syncs[i] for i in plain])} / "
        f"{_median([off_syncs[i] for i in plain])}, max {max(syncs[i] for i in plain)} / "
        f"{max(off_syncs[i] for i in plain)} over {len(plain)} frames; keyframe frames "
        f"{sorted(kf_frames & set(range(first)))} / {sorted(off_kf)}")
    if moved:
        raise AssertionError(f"[loop] loop closing changed the host syncs of frames without a "
                             f"keyframe: {[(i, syncs[i], off_syncs[i]) for i in moved[:8]]}")

    # timings
    closure_frames = {c["kf_frame"] for c in s.loop_closures}
    at = {"plain": [t for i, t in enumerate(times) if i and i not in kf_frames],
          "keyframe": [t for i, t in enumerate(times) if i in kf_frames - closure_frames],
          "closure": [times[f] for f in sorted(closure_frames)]}

    def stage(name, closure=None, lap=stages):
        return [ms for n, c, ms in lap if n == name and (closure is None or c == closure)]

    chunks = stage("gba_chunk")
    res = {"track_ms_median": _median(at["plain"]),
           "keyframe_track_ms_median": _median(at["keyframe"]),
           "closure_track_ms": at["closure"], "lap_s": lap_s,
           "detect_ms_median": _median(stage("detect")), "detections": len(stage("detect")),
           "compute_sim3_ms": stage("compute_sim3"),
           "correct_loop_ms": stage("correct_loop"),
           "propagate_and_fuse_ms": [a + b for a, b in zip(stage("propagate"), stage("fuse"))],
           "essential_graph_ms": stage("essential_graph"), "gba_chunk_ms": chunks,
           "loops": s.n_loops_closed, "ate_m": ate, "k9_gba_launches": k9_gba[0], "keyframes_inserted": s._kf_seq_host,
           "plain_frame_syncs": [syncs[i] for i in plain]}
    for k in range(s.n_loops_closed):
        res[f"closure_{k + 1}_stages_ms"] = {n: sum(stage(n, k)) for n, _ in LOOP_STAGES
                                            if n not in ("detect", "gba_chunk")}
        res[f"closure_{k + 1}_warm_stages_ms"] = {
            n: sum(stage(n, k, stages2)) for n, _ in LOOP_STAGES
            if n not in ("detect", "gba_chunk")}
    res["warm_gba_chunk_ms"] = stage("gba_chunk", lap=stages2)
    res["warm_detect_ms_median"] = _median(stage("detect", lap=stages2))
    log(f"[loop] {card}: track_rgbd median {res['track_ms_median']:.2f} ms per frame "
        f"({len(at['plain'])} frames without a keyframe), {res['keyframe_track_ms_median']:.2f} "
        f"ms per keyframe frame without a closure ({len(at['keyframe'])}), closure frames "
        f"{[round(t, 1) for t in at['closure']]} ms; the lap {lap_s:.1f} s; loop detection "
        f"median {res['detect_ms_median']:.2f} ms per keyframe ({res['detections']}); "
        f"compute_sim3 {[round(t, 1) for t in res['compute_sim3_ms']]} ms per candidate; "
        f"correct_loop {[round(t, 1) for t in res['correct_loop_ms']]} ms (propagation and "
        f"fusion {[round(t, 1) for t in res['propagate_and_fuse_ms']]}, essential graph "
        f"{[round(t, 1) for t in res['essential_graph_ms']]}); GBA chunks "
        f"{[round(t, 1) for t in chunks]} ms; " +
        "; ".join(f"closure {k + 1}: " + ", ".join(f"{n} {v:.1f}" for n, v in
                                                  res[f'closure_{k + 1}_stages_ms'].items()) +
                  " ms; the same closure in the second lap (the process's next, warm): " +
                  ", ".join(f"{n} {v:.1f}" for n, v in
                            res[f'closure_{k + 1}_warm_stages_ms'].items()) + " ms"
                  for k in range(s.n_loops_closed)) +
        f"; the second lap's GBA chunks {[round(t, 1) for t in res['warm_gba_chunk_ms']]} ms, "
        f"its detection median {res['warm_detect_ms_median'] or 0:.2f} ms")

    # K9 at the global BA's shape: device time (queued clock) beside its bound
    k9 = rec["ba_gba"]
    a9 = _named(cb.ba_assemble, k9)
    e9 = a9["edge_mask"].numel()
    gba_bound, gba_by = _bound(_ba_assemble_bytes(k9), 600 * e9)
    k9_res = {"shape": f"E={e9} ({a9['points'].shape[0]} points x "
                       f"{a9['edge_mask'].shape[1]}), C={a9['poses'].shape[0]}, robust off",
              "device_ms": _queued_ms(lambda: cb.ba_assemble(*k9)),
              "ms": _event_ms(lambda: cb.ba_assemble(*k9), 20),
              "plain_ms": _event_ms(lambda: cb.ba_assemble_plain(*k9), 5),
              "plain_device_ms": _device_ms(lambda: cb.ba_assemble_plain(*k9), reps=3)[0],
              "bound_ms": gba_bound, "bound_by": gba_by, "launches": k9_gba[0]}
    log(f"[loop] {card}: K9 at the global BA's shape ({k9_res['shape']}): device "
        f"{k9_res['device_ms'] * 1e3:.1f} us queued, {k9_res['ms']:.3f} ms per call, twin "
        f"{k9_res['plain_ms']:.3f} ms ({k9_res['plain_device_ms'] * 1e3:.1f} us device, "
        f"profiler), bound {gba_bound * 1e3:.2f} us ({gba_by}), "
        f"{k9_gba[0]} launches in the lap")
    res["pcg"] = _pcg_against_dense(cfg, s.m, dev, card)
    return launches, k9_res, res, dict(poses=poses, frames=frames, m=s.m, ate=ate,
                                       essential=rec["essential"])


# ---------------------------------------------------------------------------
# [multi]: the tracking / mapping split and the sharded solvers
# ---------------------------------------------------------------------------

MULTI_KF_SLACK = 0.2        # the split's keyframes against the reference split's, a share
SHARD_TOL = 1e-4            # two ranks against one after one LM step (tests/test_parallel.py:36-39)
RANKS_TIMEOUT_S = 300       # the two spawned ranks, start to end


def _multi_lap(cfg, voc, frames, dev, mapping_device=None):
    """A fresh system with its defaults streaming the frames at depth
    STREAM_DEPTH (with `mapping_device`, the split), then flush(). Returns
    the system, the wall ms of each call and its kind: "dispatch" where the
    call inserted a keyframe (the split: dispatched its pass), "adopt"
    where the split adopted a pass, else "plain"; and the lap's seconds."""
    s = system.SlamSystem(cfg, vocabulary=voc, pipeline_depth=STREAM_DEPTH,
                          mapping_device=mapping_device, device=dev)
    times, kinds = [], []
    t_lap = time.perf_counter()
    for i, (gray, depth_img) in enumerate(frames):
        seq, adopted = s._kf_seq_host, s.n_mapping_adopted
        t0 = time.perf_counter()
        s.track_rgbd(gray, depth_img, i / cfg.fps)
        times.append((time.perf_counter() - t0) * 1e3)
        kinds.append("adopt" if s.n_mapping_adopted > adopted else
                     "dispatch" if s._kf_seq_host > seq else "plain")
    s.flush()
    torch.cuda.synchronize()
    return s, times, kinds, time.perf_counter() - t_lap


def _kind_ms(times, kinds, kind):
    return _median([t for i, (t, k) in enumerate(zip(times, kinds)) if i and k == kind])


def _gloo_rank(rank, tmp, device):
    """One of two ranks on `device` over gloo: the sharded global BA of
    the problem [multi] saved in tmp after one LM iteration and after
    PCG_LM_ITERS (timed on a second run), and the wall ms of the LM
    iteration's all-reduce at its shape through gloo."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    d = torch.load(os.path.join(tmp, "problem.pt"), weights_only=False)
    cfg = d["cfg"]
    prob = schur_ba.BAProblem(*(t.to(dev) for t in d["prob"]))
    mesh = distributed.init_distributed(init_method=f"file://{tmp}/init", world_size=2,
                                        rank=rank, device="cpu")
    try:
        def solve(n_iters):
            return sharded_ba.solve_global_ba_sharded(cfg.camera(dev), prob, cfg.level_sigma2,
                                                      mesh, n_iters=n_iters)
        first = solve(1)
        solve(PCG_LM_ITERS)
        ms = _wall_ms(lambda _: solve(PCG_LM_ITERS), [None])[0]
        res = solve(PCG_LM_ITERS)
        C = prob.poses.shape[0]
        pack = torch.ones((36 * C * C + 6 * C,), device=dev)
        ar_ms = _wall_ms(lambda _: distributed.all_reduce_sum(mesh.get_group(), pack),
                         [None] * 10)
        if rank == 0:
            torch.save({"res": {1: [t.cpu() for t in first],
                                PCG_LM_ITERS: [t.cpu() for t in res]}, "solve_ms": ms,
                        "all_reduce_ms": statistics.median(ar_ms)},
                       os.path.join(tmp, "out.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _two_ranks(cfg, prob, dev):
    """The sharded global BA over two processes on the one card (gloo):
    their result and timings. The problem goes by torch.save to a
    temporary directory; the ranks are stopped if they outlast
    RANKS_TIMEOUT_S."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"cfg": cfg, "prob": [t.cpu() for t in prob]},
                   os.path.join(tmp, "problem.pt"))
        ctx = mp.start_processes(_gloo_rank, args=(tmp, str(dev)), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.perf_counter() + RANKS_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    raise AssertionError(f"[multi] the two gloo ranks ran past "
                                         f"{RANKS_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        return torch.load(os.path.join(tmp, "out.pt"), weights_only=False)


def _require_same(what, got, want):
    """Every tensor of two results equal bit for bit; returns the largest
    difference of their floats (0.0)."""
    diff = 0.0
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            d = float((a.double() - b.double()).abs().max()) if a.is_floating_point() else -1
            raise AssertionError(f"[multi] {what} parts from the unsharded solve (max |diff| "
                                 f"{d})")
        if a.is_floating_point():
            diff = max(diff, float((a - b).abs().max()))
    return diff


COLLECTIVES = ("all_reduce_sum", "broadcast_first", "all_gather_rows")


@contextmanager
def _counted_collectives():
    """The calls of the sharded solvers' collectives (`distributed`'s
    three functions) while the block runs, by name."""
    calls, saved = Counter(), {name: getattr(distributed, name) for name in COLLECTIVES}

    def counted(name):
        def call(*args):
            calls[name] += 1
            return saved[name](*args)
        return call
    try:
        for name in COLLECTIVES:
            setattr(distributed, name, counted(name))
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(distributed, name, fn)


def _sharded_solvers(cfg, m, essential, dev, card, errs):
    """The sharded solvers on the final map of [loop]: at one NCCL rank
    against the unsharded solves bit for bit (the global BA, dense and
    PCG, and the closure's essential graph), each timed beside the other
    and its collectives counted, the LM iteration's all-reduce timed on the
    card and on the host; K9 at the shape of one of two landmark blocks
    beside its bound; two gloo ranks on the card against one rank, on the problem with its
    points in a fixed shuffled order (so both blocks hold live points):
    within SHARD_TOL after one LM iteration, and after PCG_LM_ITERS within
    the bounds [loop] holds two float32 solves of this problem to
    (PCG_POSE_TOL, PCG_POINT_TOL: each block damps its cameras by its own
    diagonal, so the result depends on the rank count, and ten iterations
    at low damping magnify the rounding of another summation order, as
    between PCG and the dense solve)."""
    cam = cfg.camera(dev)
    prob = loop_closing.global_ba_problem(cfg, m)
    fix_scale = cfg.sensor != SENSOR_MONOCULAR
    mesh = distributed.init_distributed()
    res = {"backend": torch.distributed.get_backend(), "ranks": mesh.size()}
    try:
        solves = {
            "gba": (lambda: sharded_ba.solve_global_ba_sharded(cam, prob, cfg.level_sigma2, mesh,
                                                               n_iters=PCG_LM_ITERS),
                    lambda: schur_ba.solve_ba(cam, prob, cfg.level_sigma2, iters_a=PCG_LM_ITERS,
                                              iters_b=0, robust=False)),
            "pcg": (lambda: pcg_ba.solve_ba_pcg_sharded(cam, prob, cfg.level_sigma2, mesh,
                                                        n_iters=PCG_LM_ITERS),
                    lambda: pcg_ba.solve_ba_pcg(cam, prob, cfg.level_sigma2,
                                                n_iters=PCG_LM_ITERS)),
            "essential_graph": (
                lambda: sharded_pose_graph.optimize_pose_graph_sharded(essential, mesh, 20,
                                                                       fix_scale),
                lambda: pose_graph.optimize_pose_graph(essential, 20, fix_scale))}
        out = {}
        for name, (sharded, plain) in solves.items():
            with _counted_collectives() as calls:
                got = sharded()
            want = plain()
            torch.cuda.synchronize()
            res[f"{name}_max_abs_diff"] = _require_same(name, got, want)
            res[f"{name}_collectives"] = dict(calls)
            times = {sharded: [], plain: []}
            for _ in range(3):
                for fn in times:
                    times[fn] += _wall_ms(lambda _: fn(), [None])
            res[f"{name}_sharded_ms"] = statistics.median(times[sharded])
            res[f"{name}_ms"] = statistics.median(times[plain])
            out[name] = got
        C = prob.poses.shape[0]
        group = mesh.get_group()
        pack = (torch.ones((6 * C, 6 * C), device=dev), torch.ones((6 * C,), device=dev))
        res["all_reduce_nccl_ms"] = _event_ms(lambda: distributed.all_reduce_sum(group, *pack),
                                              20)
        # the host's time per collective, issued back to back: each of the
        # solves' collectives costs at least this much wall time
        for key, ts in (("all_reduce_wall_ms", pack), ("all_reduce_one_float_wall_ms",
                                                        (pack[1][:1],))):
            res[key] = _wall_ms(lambda _: [distributed.all_reduce_sum(group, *ts)
                                           for _ in range(50)], [None])[0] / 50
    finally:
        torch.distributed.destroy_process_group()
    log(f"[multi] {card}: the sharded solvers at one NCCL rank equal the unsharded ones bit for "
        f"bit on [loop]'s final map (C={prob.poses.shape[0]}, {int(prob.pt_valid.sum())} points, "
        f"{PCG_LM_ITERS} LM iterations; the closure's essential graph, "
        f"E={essential.edge_i.shape[0]}, 20 iterations): global BA "
        f"{res['gba_sharded_ms']:.1f} ms sharded / {res['gba_ms']:.1f} ms, PCG "
        f"{res['pcg_sharded_ms']:.1f} / {res['pcg_ms']:.1f} ms, essential graph "
        f"{res['essential_graph_sharded_ms']:.1f} / {res['essential_graph_ms']:.1f} ms; the "
        f"all-reduce of (S, b_red), {36 * C * C + 6 * C} floats, {res['all_reduce_nccl_ms']:.3f} "
        f"ms on the card, {res['all_reduce_wall_ms']:.3f} ms of host time a call back to back "
        f"({res['all_reduce_one_float_wall_ms']:.3f} ms for one float); collectives a solve: "
        + "; ".join(f"{name} {res[f'{name}_collectives']}" for name in solves))

    # K9 on one of two landmark blocks: its shape in the two-rank solve
    Q = prob.points.shape[0]
    half = schur_ba.BAProblem(prob.poses, prob.cam_valid, prob.cam_fixed,
                              *(t[: Q // 2] for t in prob[3:]))
    inv_sigma2, base_mask, _ = schur_ba._weights(half, cfg.level_sigma2)
    k9 = (cam, half.poses, half.points, half.pt_valid, schur_ba._edges(half, inv_sigma2),
          base_mask.float(), False)
    _lin_equal(f"[multi] K9 at the shard's shape", schur_ba.Lin(*cb.ba_assemble(*k9)),
               schur_ba.Lin(*cb.ba_assemble_plain(*k9)), errs)
    e9 = k9[5].numel()
    bound, by = _bound(_ba_assemble_bytes(k9), 600 * e9)
    shard = {"shape": f"E={e9} ({Q // 2} points x {k9[5].shape[1]}), C={C}, robust off",
             "device_ms": _queued_ms(lambda: cb.ba_assemble(*k9)),
             "ms": _event_ms(lambda: cb.ba_assemble(*k9), 20),
             "plain_ms": _event_ms(lambda: cb.ba_assemble_plain(*k9), 5),
             "plain_device_ms": _device_ms(lambda: cb.ba_assemble_plain(*k9), reps=3)[0],
             "bound_ms": bound, "bound_by": by}
    log(f"[multi] {card}: K9 at the shard's shape ({shard['shape']}): device "
        f"{shard['device_ms'] * 1e3:.1f} us queued, {shard['ms']:.3f} ms per call, twin "
        f"{shard['plain_ms']:.3f} ms ({shard['plain_device_ms'] * 1e3:.1f} us device, "
        f"profiler), bound {bound * 1e3:.2f} us ({by}); equal to its twin "
        f"bit for bit")

    # the map's live points fill the first rows of the point axis (all of
    # them lie in the first of two blocks), so the ranks get the points in a
    # fixed shuffled order: each block holds about half of them, and a lost
    # or partial reduction of either rank's part moves the result
    perm = torch.randperm(Q, generator=torch.Generator().manual_seed(0)).to(dev)
    shuffled = schur_ba.BAProblem(prob.poses, prob.cam_valid, prob.cam_fixed,
                                  *(t[perm] for t in prob[3:]))
    pv = shuffled.pt_valid.cpu()
    res["live_points_per_block"] = [int(pv[: Q // 2].sum()), int(pv[Q // 2:].sum())]
    two = _two_ranks(cfg, shuffled, dev)
    ones = {n: schur_ba.solve_ba(cam, shuffled, cfg.level_sigma2, iters_a=n, iters_b=0,
                                 robust=False) for n in (1, PCG_LM_ITERS)}
    for n, one in ones.items():
        got = two["res"][n]
        res[f"two_rank_{n}_iters"] = {
            "pose_diff": float((got[0] - one.poses.cpu()).abs().max()),
            "point_diff": float((got[1] - one.points.cpu())[pv].abs().max()),
            "point_diff_median_m": float((got[1] - one.points.cpu())[pv].norm(dim=-1).median())}
    d1, d10 = res["two_rank_1_iters"], res[f"two_rank_{PCG_LM_ITERS}_iters"]
    res.update({"two_rank_gba_ms": two["solve_ms"], "all_reduce_gloo_ms": two["all_reduce_ms"],
                "k9_shard": shard})
    log(f"[multi] {card}: two ranks on the card over gloo (K9 on {Q // 2} points each, the "
        f"points shuffled: {res['live_points_per_block']} live in the two blocks): the "
        f"global BA {two['solve_ms']:.1f} ms; against one rank after one LM iteration, poses "
        f"max |diff| {d1['pose_diff']:.3e}, points {d1['point_diff']:.3e} (<= {SHARD_TOL} "
        f"required); after {PCG_LM_ITERS}, poses {d10['pose_diff']:.3e} (<= {PCG_POSE_TOL}), "
        f"points max {d10['point_diff']:.3e}, median {d10['point_diff_median_m']:.3e} m (< "
        f"{PCG_POINT_TOL}); gloo's all-reduce of (S, b_red) {two['all_reduce_ms']:.2f} ms")
    if not (d1["pose_diff"] <= SHARD_TOL and d1["point_diff"] <= SHARD_TOL and
            d10["pose_diff"] <= PCG_POSE_TOL and d10["point_diff_median_m"] < PCG_POINT_TOL):
        raise AssertionError(f"[multi] two ranks part from one: {d1}, {d10}")
    return res


def multi_phase(cfg, voc, dev, card, errs, lap):
    """[loop]'s figure eight through the tracking / mapping split at depth
    STREAM_DEPTH (counts set to 0 before, read after) and through the
    stream without it, then the sharded solvers (`_sharded_solvers`) on
    [loop]'s final map. The split: at least LOOP_TRACKED_FLOOR of the
    frames tracked, the ATE within max(3x [loop]'s synchronous lap's, 3 cm)
    (the band of tests/test_pipeline_split.py), the keyframes inserted
    within MULTI_KF_SLACK of the reference split's on the same frames
    (REFERENCE_SPLIT: a frame tracked before an adoption sees the map
    without the pass's points and may ask for another keyframe, so the
    split inserts more than the stream), every pass adopted, a finite map
    on the card. Returns (launches, the phase's results)."""
    poses, frames = lap["poses"], lap["frames"]
    gt = [(i / cfg.fps, T) for i, T in enumerate(poses)]
    plain, p_times, p_kinds, p_s = _multi_lap(cfg, voc, frames, dev)
    launch.reset_launches()
    split, s_times, s_kinds, s_s = _multi_lap(cfg, voc, frames, dev, mapping_device=dev)
    launches = dict(launch.LAUNCHES)
    res = {}
    for name, s, times, kinds, lap_s in (("stream", plain, p_times, p_kinds, p_s),
                                         ("split", split, s_times, s_kinds, s_s)):
        traj = s.get_trajectory()
        res[name] = {"fps": len(frames) / lap_s, "tracked": len(traj),
                     "ate_m": trajectory.ate_rmse(traj, gt), "keyframes": s._kf_seq_host,
                     "loops": s.n_loops_closed,
                     "closures": [(c["kf_seq"], c["kf_frame"], c["cand_frame"])
                                  for c in s.loop_closures],
                     "plain_ms": _kind_ms(times, kinds, "plain"),
                     "keyframe_ms": _kind_ms(times, kinds, "dispatch"),
                     "adopt_ms": _kind_ms(times, kinds, "adopt"),
                     "calls": dict(Counter(kinds))}
    r, q = res["split"], res["stream"]
    ref = REFERENCE_SPLIT
    ref_kf = ref["split"]["keyframes_inserted"]
    r.update({"dispatched": split.n_mapping_dispatched, "adopted": split.n_mapping_adopted,
              "mapping_adopt_wall_ms": split.stage_ms.get("mapping_adopt_wall")})
    log(f"[multi] {card}: the split (depth {STREAM_DEPTH}, the mapping pass on a second stream) "
        f"against the stream without it, loop closing on, {len(frames)} frames: "
        f"{r['fps']:.2f} / {q['fps']:.2f} frames per second; ms per call without a keyframe "
        f"{_fmt(r['plain_ms'])} / {_fmt(q['plain_ms'])}, inserting one {_fmt(r['keyframe_ms'])} "
        f"/ {_fmt(q['keyframe_ms'])}, adopting a pass {_fmt(r['adopt_ms'])}; tracked "
        f"{r['tracked']} / {q['tracked']}, ATE {r['ate_m'] * 100:.3f} / {q['ate_m'] * 100:.3f} "
        f"cm ([loop]'s synchronous lap {lap['ate'] * 100:.3f} cm), keyframes {r['keyframes']} / "
        f"{q['keyframes']}, loops {r['loops']} / {q['loops']} (closures (keyframe sequence, "
        f"frame, candidate frame) {r['closures']} / {q['closures']}; the reference's split / "
        f"stream: "
        f"ATE {ref['split']['ate_m'] * 100:.3f} / {ref['stream']['ate_m'] * 100:.3f} cm, "
        f"keyframes {ref_kf} / {ref['stream']['keyframes_inserted']}, loops "
        f"{ref['split']['loops']} / {ref['stream']['loops']}); {r['dispatched']} passes "
        f"dispatched, {r['adopted']} adopted; launches over the split lap {launches}")
    bad = _map_finite(split.m)
    fails = [what for what, ok in (
        ("tracked", r["tracked"] >= LOOP_TRACKED_FLOOR * len(frames)),
        ("ATE", r["ate_m"] <= max(3 * lap["ate"], 0.03)),
        ("keyframes", abs(r["keyframes"] - ref_kf) <= MULTI_KF_SLACK * ref_kf),
        ("passes adopted", 0 < r["adopted"] == r["dispatched"]),
        ("mapping_adopt_wall", r["mapping_adopt_wall_ms"] is not None),
        ("map on the card", split.m.kf_pose.device == dev and split.m.pt_pos.device == dev),
        ("finite map", bad is None)) if not ok]
    missing = [k for k in PATH_KERNELS if not launches[k]]
    if fails or missing:
        raise AssertionError(f"[multi] the split fails {fails}; kernels never launched "
                             f"{missing}: {res}")
    del plain, split
    res["solvers"] = _sharded_solvers(cfg, lap["m"], lap["essential"], dev, card, errs)
    return launches, res


# ---------------------------------------------------------------------------
# [stereo] and [mono]: the other two sensors through SlamSystem
# ---------------------------------------------------------------------------

TRACKED_SLACK = 0.01        # [stereo]: frames tracked below the reference's, a share of all
KF_COUNT_SLACK = 0.2        # keyframes in the map against the reference's (runs')
MONO_INIT_SLACK = 3         # [mono]: frames the initialization may move from the reference runs'
UR_TOL = 1e-3               # px: u_right where a SAD sum may round (tests/test_torch_stereo.py)
UR_FLIP_FLOOR = 0.005       # rows matched on one side only
INIT_POSE_TOL = 1e-4        # [mono]: initialize on the card against the CPU, per entry of R, t
INIT_GOOD_FLOOR = 0.99      # rows of `good` that must agree
PATH_KERNELS = ("pyramid", "dense_stage", "brief", "best_two", "proj_match", "pose_lm",
                "epi_match", "ba_edge")


def _input_timing(tag, name, shapes, kernel, twin, n_bytes, ops, card):
    """A kernel at an input of this phase's path: ms per call (CUDA events
    over back-to-back calls), device ms (queued), the twin's ms, the bound
    (the smoke fails if the device time is below it)."""
    ms, plain_ms, dev_ms = _event_ms(kernel, 20), _event_ms(twin, 5), _queued_ms(kernel)
    bound_ms, bound_by = _bound(n_bytes, ops)
    log(f"{tag} {card}: {name} at {shapes}: {ms:.4f} ms per call, device "
        f"{dev_ms * 1e3:.1f} us queued, twin {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by})")
    if dev_ms < bound_ms:
        raise AssertionError(f"{tag} {name}: device time {dev_ms:.5f} ms below its bound "
                             f"{bound_ms:.5f} ms")
    return dict(shapes=shapes, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _front_timing(tag, cfg, img, dev, card):
    """K1, K2 and K3 on one image of a stereo pair (`_front_calls`)."""
    _, _, front = _front_calls(cfg, img, dev, f"the right image, {H}x{W}")
    return {name: _input_timing(tag, name, shapes, kernel, twin,
                                ins if isinstance(ins, int) else _nbytes(ins) + _nbytes(kernel()),
                                ops, card)
            for name, (shapes, kernel, twin, ins, ops) in front.items()}


def _stereo_matches_parity(cfg, pair, dev, what):
    """The stereo coarse search and SAD (`ops/stereo.compute_stereo_matches`)
    on the card against their run on the CPU on the same tensors (the
    card's keypoints and pyramids): the rows matched on one side only at
    most UR_FLIP_FLOOR, u_right and the disparity bf / depth bit for bit on
    the level-0 rows of an integer-valued pair, within UR_TOL px elsewhere.
    Returns the card's arguments."""
    left, right = (torch.from_numpy(x).to(dev).to(torch.float32) for x in pair)
    kl, pl = ex.extract_with_pyramid(left, cfg)
    kr, pr = ex.extract_with_pyramid(right, cfg)
    args = (kl.xy, kl.level, kl.desc, kl.valid, kr.xy, kr.level, kr.desc, kr.valid, pl, pr,
            cfg.scale_factors, cfg.bf, cfg.fx)
    ur, depth = (t.cpu() for t in stereo_ops.compute_stereo_matches(*args))
    host = [a.cpu() for a in args[:8]] + [[lv.cpu() for lv in pyr] for pyr in args[8:10]]
    ur_c, depth_c = stereo_ops.compute_stereo_matches(*host, *args[10:])
    on, on_c = ur >= 0, ur_c >= 0
    flips = int((on != on_c).sum())
    both = on & on_c
    integer = all(bool((x == np.round(x)).all()) for x in pair)
    exact = both & (kl.level.cpu() == 0) if integer else torch.zeros_like(both)
    disp, disp_c = cfg.bf / depth[both], cfg.bf / depth_c[both]
    err = max(float((ur[both] - ur_c[both]).abs().max()), float((disp - disp_c).abs().max()))
    log(f"[stereo] compute_stereo_matches on the card against the CPU, {what}: {int(on.sum())} "
        f"/ {int(on_c.sum())} rows matched, {flips} on one side only; max |u_right diff| and "
        f"|disparity diff| {err:.3g} px; {int(exact.sum())} level-0 rows of an integer-valued "
        f"pair bit for bit")
    if flips > UR_FLIP_FLOOR * ur.numel() or not err <= UR_TOL or int(both.sum()) < 50:
        raise AssertionError(f"[stereo] compute_stereo_matches {what}: {flips} rows flipped, "
                             f"max diff {err:.3g} px, {int(both.sum())} rows on both sides")
    if not (torch.equal(ur[exact], ur_c[exact]) and torch.equal(depth[exact], depth_c[exact])):
        raise AssertionError(f"[stereo] compute_stereo_matches {what}: level-0 rows of an "
                             f"integer-valued pair differ from the CPU's")
    return args


def _stream_lap(tag, cfg, voc, frames, poses, dev, sync_ate, ref):
    """A fresh system streaming the frames at depth STREAM_DEPTH, then
    flush(), held to the JAX stream on the same frames (`ref`, from
    REFERENCE_STREAMS) as [system]'s stream is: a stereo lap the same
    states over the first SEQ_FRAMES_CHECKED frames and its keyframes there
    within SYSTEM_KF_SLACK, the frames tracked, the keyframe count, the ATE
    within 2x the reference's + 1 cm; a monocular lap (a list of the
    reference's runs, RANSAC keys apart) its initialization frame, keyframe
    count and ATE (Sim3-aligned) against the runs'. Besides, as before, at
    least LOOP_TRACKED_FLOOR of the frames tracked, the ATE within max(3x
    the synchronous lap's, 3 cm), a finite map. Returns its records."""
    states = []
    t0 = time.perf_counter()
    st = _loop_lap(cfg, voc, frames, dev, depth=STREAM_DEPTH, states=states)
    stream_s = time.perf_counter() - t0
    traj = st.get_trajectory()
    mono = cfg.sensor == SENSOR_MONOCULAR
    ate = trajectory.ate_rmse(traj, [(i / cfg.fps, T) for i, T in enumerate(poses)],
                              with_scale=mono)
    kf = sorted(e["frame"] for e in st.metrics if e.get("kf"))
    n_kf = int(st.m.n_keyframes)
    res = {"stream_depth": STREAM_DEPTH, "stream_fps": len(poses) / stream_s,
           "stream_tracked": len(traj), "stream_ate_m": ate, "stream_loops": st.n_loops_closed,
           "stream_keyframes": n_kf}
    refs = ref if mono else [ref]
    log(f"{tag} stream (depth {STREAM_DEPTH}): {len(traj)} of {len(poses)} frames tracked, "
        f"{st.n_loops_closed} loops closed, {n_kf} keyframes (the JAX stream "
        f"{[r['keyframes'] for r in refs]}), ATE {ate * 100:.3f} cm (the JAX stream "
        f"{[round(r['ate_m'] * 100, 3) for r in refs]} cm), keyframes at {kf[:12]}"
        f"{'...' if len(kf) > 12 else ''} (the JAX stream "
        f"{[r['kf_frames'][:12] for r in refs] if not mono else '-'}), "
        f"{res['stream_fps']:.2f} frames per second over the lap and the flush")
    bad = _map_finite(st.m)
    if bad or len(traj) < LOOP_TRACKED_FLOOR * len(poses) or not ate <= max(3 * sync_ate, 0.03):
        raise AssertionError(f"{tag} stream: {len(traj)} frames tracked, ATE {ate:.4f} m (the "
                             f"synchronous lap's {sync_ate:.4f} m), non-finite {bad}")
    r_kf = [r["keyframes"] for r in refs]
    if not (1 - KF_COUNT_SLACK) * min(r_kf) <= n_kf <= (1 + KF_COUNT_SLACK) * max(r_kf):
        raise AssertionError(f"{tag} stream: {n_kf} keyframes, the JAX stream {r_kf}")
    if not ate <= 2 * max(r["ate_m"] for r in refs) + 0.01:
        raise AssertionError(f"{tag} stream: ATE {ate:.4f} m > 2 x the JAX stream's "
                             f"{max(r['ate_m'] for r in refs):.4f} m + 1 cm")
    if mono:
        init = states.index(system.OK) if system.OK in states else None
        r_init = [r["init_frame"] for r in refs]
        res["stream_init_frame"] = init
        if init is None or not min(r_init) - MONO_INIT_SLACK <= init <= \
                max(r_init) + MONO_INIT_SLACK:
            raise AssertionError(f"{tag} stream: initialized at {init}, the JAX stream at "
                                 f"{r_init}")
    else:
        n = SEQ_FRAMES_CHECKED
        kf_n, ref_kf_n = [k for k in kf if k < n], [k for k in ref["kf_frames"] if k < n]
        if states[:n] != ref["states"][:n] or len(kf_n) != len(ref_kf_n) or any(
                abs(a - b) > SYSTEM_KF_SLACK for a, b in zip(kf_n, ref_kf_n)):
            raise AssertionError(f"{tag} stream: frames 0-{n - 1} states {states[:n]}, "
                                 f"keyframes {kf_n}; the JAX stream's {ref['states'][:n]}, "
                                 f"{ref_kf_n}")
        if len(traj) < ref["tracked"] - TRACKED_SLACK * len(poses):
            raise AssertionError(f"{tag} stream: {len(traj)} frames tracked, the JAX stream "
                                 f"{ref['tracked']}")
    return res


def _fmt(ms):
    return "-" if ms is None else f"{ms:.2f}"


def _split_kf(times, metrics, closures=()):
    """Median wall ms of the calls without a keyframe, with one (no closure),
    and the closure frames' ms."""
    kf = {e["frame"] for e in metrics if e.get("kf")}
    cl = set(closures)
    return (_median([t for i, t in enumerate(times) if i and i not in kf]),
            _median([t for i, t in enumerate(times) if i in kf - cl]),
            [times[f] for f in sorted(cl)])


def stereo_phase(voc, dev, card, errs, rgbd_syncs):
    """EVAL.md's block-stereo row through SlamSystem.track_stereo with its
    defaults (`block_config`, the row's first BLOCK_LAP pairs rendered on a
    thread pool while the system tracks them), then flush(): checked
    against REFERENCE_STEREO (the same states over the first frames and
    keyframes there within SYSTEM_KF_SLACK, the frames tracked, the ATE,
    the loop closures, the keyframe count, a finite map); each frame's K1,
    K2 and K3 launches (two each: the left and the right image); its host
    syncs against the RGB-D [loop] lap's; a stream lap at depth
    STREAM_DEPTH over the first STREAM_LAP pairs; the stereo matcher on the
    card against the CPU and K1-K3 of a right image against their twins.
    Counts set to 0 before the lap, read after. Returns (launches, results)."""
    cfg = block_config()
    poses, pairs = render_block_frames(BLOCK_LAP)
    kept = []

    def keep(gen):
        for pair in gen:
            kept.append(pair)
            yield pair

    times, syncs, closure_nb, states, front = [], [], [], [], []
    launch.reset_launches()
    t0 = time.perf_counter()
    s = _loop_lap(cfg, voc, keep(pairs), dev, times, syncs, closure_nb, states=states,
                  front=front)
    lap_s = time.perf_counter() - t0
    launches = dict(launch.LAUNCHES)
    ref = REFERENCE_STEREO
    log(f"[stereo] rendered and tracked {len(kept)} stereo pairs {W}x{H} in {lap_s:.1f} s; "
        f"launches over the lap: {launches}")
    # the reference's CPU run closes no loop on this row (its ATE 30 cm);
    # EVAL.md's run on a TPU closed one: a genuine extra closure passes
    ate, tracked = _loop_check(cfg, s, poses, closure_nb, ref, tag="[stereo]", extra_loops=True)
    n = SEQ_FRAMES_CHECKED
    kf = sorted(e["frame"] for e in s.metrics if e.get("kf"))
    kf_n, ref_kf_n = [k for k in kf if k < n], [k for k in ref["kf_frames"] if k < n]
    log(f"[stereo] frames 0-{n - 1}: states {states[:n]}, keyframes at {kf_n} (reference "
        f"{ref_kf_n}); {int(s.m.n_keyframes)} keyframes in the map (reference "
        f"{ref['keyframes']}), {tracked} frames tracked (reference {ref['tracked']})")
    if states[:n] != ref["states"][:n]:
        raise AssertionError(f"[stereo] states {states[:n]} != the reference's {ref['states'][:n]}")
    if len(kf_n) != len(ref_kf_n) or any(abs(a - b) > SYSTEM_KF_SLACK
                                         for a, b in zip(kf_n, ref_kf_n)):
        raise AssertionError(f"[stereo] keyframes at {kf_n}, the reference's at {ref_kf_n}")
    if tracked < ref["tracked"] - TRACKED_SLACK * len(poses):
        raise AssertionError(f"[stereo] {tracked} frames tracked, the reference {ref['tracked']}")
    if abs(int(s.m.n_keyframes) - ref["keyframes"]) > KF_COUNT_SLACK * ref["keyframes"]:
        raise AssertionError(f"[stereo] {int(s.m.n_keyframes)} keyframes, the reference "
                             f"{ref['keyframes']}")
    missing = [k for k in PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"[stereo] kernels never launched: {missing}")
    per_frame = Counter(front)
    if set(per_frame) != {(2, 2, 2)}:
        raise AssertionError(f"[stereo] K1, K2, K3 launches per frame: {dict(per_frame)}; two "
                             f"each expected")
    kf_frames = {e["frame"] for e in s.metrics if e.get("kf")}
    plain = [syncs[i] for i in range(1, len(syncs)) if i not in kf_frames]
    log(f"[stereo] K1, K2, K3 launches per frame: {dict(per_frame)}; host syncs per frame "
        f"without a keyframe: median {_median(plain)}, max {max(plain)} over {len(plain)} "
        f"frames (the RGB-D [loop] lap's: median {_median(rgbd_syncs)}, max {max(rgbd_syncs)})")
    if _median(plain) > _median(rgbd_syncs):
        raise AssertionError(f"[stereo] host syncs per frame: median {_median(plain)} against "
                             f"RGB-D's {_median(rgbd_syncs)}")

    stream = _stream_lap("[stereo]", cfg, voc, kept[:STREAM_LAP], poses[:STREAM_LAP], dev, ate,
                         REFERENCE_STREAMS["stereo"])
    # the lap's per-frame times share the host with the renderers: the
    # first STEREO_TIMED pairs again, alone
    alone = []
    timed = _loop_lap(cfg, voc, kept[:STEREO_TIMED], dev, alone)
    alone_ms, alone_kf_ms, _ = _split_kf(alone, timed.metrics)
    del timed

    # the card against the CPU and the twins, and timings, at the lap's pairs
    pair = kept[1]
    args = _stereo_matches_parity(cfg, pair, dev, "frame 1 (float32)")
    _stereo_matches_parity(cfg, tuple(np.clip(np.round(x), 0, 255).astype(np.uint8)
                                      for x in kept[-1]),
                           dev, f"frame {len(kept) - 1} quantized to uint8")
    right = torch.from_numpy(pair[1]).to(dev)
    front_image_parity(cfg, right, dev, errs, "[stereo] frame 1's right image")
    log("[stereo] K1, K2, K3 on frame 1's right image: every level bit for bit against the "
        "twins, one launch each")
    left = torch.from_numpy(pair[0]).to(dev)
    make = lambda: make_frame_stereo(left, right, cfg)      # noqa: E731
    match = lambda: stereo_ops.compute_stereo_matches(*args)   # noqa: E731
    plain_ms, kf_ms, closure_ms = _split_kf(times, s.metrics,
                                           [c["kf_frame"] for c in s.loop_closures])
    res = {"track_ms_median": plain_ms, "keyframe_track_ms_median": kf_ms,
           "closure_track_ms": closure_ms, "lap_s": lap_s, "frames": len(kept),
           "alone_track_ms_median": alone_ms, "alone_keyframe_track_ms_median": alone_kf_ms,
           # the profiler's device time: both hold the host until the stream
           # drains once a call, so they cannot queue behind a sleeping kernel
           "make_frame_stereo_ms": _event_ms(make, 10),
           "make_frame_stereo_device_ms": _device_ms(make, 5)[0],
           "compute_stereo_matches_ms": _event_ms(match, 20),
           "compute_stereo_matches_device_ms": _device_ms(match, 5)[0],
           "compute_stereo_matches_device_activities": _device_ms(match, 5)[1],
           "front_launches_per_frame": [2, 2, 2], "syncs_per_plain_frame_median": _median(plain),
           **stream, "ate_m": ate,
           "tracked": tracked, "loops": s.n_loops_closed, "keyframes": int(s.m.n_keyframes),
           "keyframes_inserted": s._kf_seq_host,
           "right_image": _front_timing("[stereo]", cfg, right.to(torch.float32), dev, card)}
    log(f"[stereo] {card}: track_stereo median {_fmt(plain_ms)} ms per frame without a keyframe, "
        f"{_fmt(kf_ms)} ms with one, closure frames {[round(t, 1) for t in closure_ms]} ms "
        f"(the renderers running); the first {STEREO_TIMED} frames alone: {_fmt(alone_ms)} / "
        f"{_fmt(alone_kf_ms)} ms; "
        f"make_frame_stereo {res['make_frame_stereo_ms']:.3f} ms per call, device "
        f"(profiler, a lower bound) {res['make_frame_stereo_device_ms']:.3f} ms; "
        f"compute_stereo_matches {res['compute_stereo_matches_ms']:.3f} ms per call, device "
        f"{res['compute_stereo_matches_device_ms']:.3f} ms, "
        f"{res['compute_stereo_matches_device_activities']:.0f} device activities per call")
    return launches, res


@contextmanager
def _mono_instruments(rec):
    """Time the monocular initialization's parts (synchronized wall ms, in
    rec["ms"] as (part, ms)) and record the inputs of its last attempt (the
    one that initialized): the search's and K4's, the initializer's, and
    K9's at C = 2 (the two-view BA)."""
    saved = [(matching, "search_for_initialization"), (initializer, "initialize"),
             (initializer, "_check_rt"), (system.SlamSystem, "_two_view_ba")]
    originals = [getattr(o, n) for o, n in saved]
    window, assemble = cm.window_best_two, cb.ba_assemble

    def timed(part, fn, record=None):
        def call(*args, **kw):
            if record is not None:
                rec[record] = (args, kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec.setdefault("ms", []).append((part, (time.perf_counter() - t0) * 1e3))
            return out
        return call

    def search(*args, **kw):
        def first(*a):
            rec["k4"] = a
            return window(*a)
        cm.window_best_two = first
        try:
            return timed("search", originals[0], "search")(*args, **kw)
        finally:
            cm.window_best_two = window

    def two_view(self, m, kf0, kf1):
        def first(*a):
            rec.setdefault("k9", a)
            return assemble(*a)
        cb.ba_assemble = first
        try:
            return timed("two_view_ba", originals[3])(self, m, kf0, kf1)
        finally:
            cb.ba_assemble = assemble

    matching.search_for_initialization = search
    initializer.initialize = timed("initialize", originals[1], "initialize")
    initializer._check_rt = timed("check_rt", originals[2])
    system.SlamSystem._two_view_ba = two_view
    try:
        yield
    finally:
        for (o, n), fn in zip(saved, originals):
            setattr(o, n, fn)


def mono_parity(rec, errs):
    """The initialization on the card against its CPU run with the same
    draws: SearchForInitialization's K4 launch and the whole search bit for
    bit, `initialize` (its success and model equal, R and t within
    INIT_POSE_TOL, `good` on INIT_GOOD_FLOOR of the rows), K9 at C = 2
    every field bit for bit."""
    k4 = rec["k4"]
    for a, b, name in zip(cm.window_best_two(*k4), cm.window_best_two_plain(*k4),
                          ("best", "index", "second")):
        errs["best_two"] = max(errs["best_two"], _max_abs(a, b))
        _require_equal(f"[mono] best_two at the initialization search {name}", a, b)
    args, kw = rec["search"]
    got = matching.search_for_initialization(*args, **kw)
    want = matching.search_for_initialization(*(a.cpu() for a in args), **kw)
    for a, b, name in zip(got, want, ("idx", "dist", "valid")):
        _require_equal(f"[mono] search_for_initialization {name} (card against CPU)", a.cpu(), b)
    args, kw = rec["initialize"]
    seed = kw["generator"].initial_seed()
    on_card = initializer.initialize(*args, generator=torch.Generator().manual_seed(seed))
    on_cpu = initializer.initialize(*(a.cpu() if isinstance(a, torch.Tensor) else a
                                      for a in args),
                                    generator=torch.Generator().manual_seed(seed))
    dR = float((on_card.R21.cpu() - on_cpu.R21).abs().max())
    dt = float((on_card.t21.cpu() - on_cpu.t21).abs().max())
    good = float((on_card.good.cpu() == on_cpu.good).float().mean())
    log(f"[mono] initialize on the card against the CPU (draws of seed {seed}): success "
        f"{bool(on_card.success)} / {bool(on_cpu.success)}, homography "
        f"{bool(on_card.used_homography)} / {bool(on_cpu.used_homography)}, max |R diff| "
        f"{dR:.3g}, max |t diff| {dt:.3g}, good equal on {good:.2%} of the rows")
    if bool(on_card.success) != bool(on_cpu.success) or \
            bool(on_card.used_homography) != bool(on_cpu.used_homography) or \
            not (dR <= INIT_POSE_TOL and dt <= INIT_POSE_TOL and good >= INIT_GOOD_FLOOR):
        raise AssertionError("[mono] initialize on the card parts from its CPU run")
    k9 = rec["k9"]
    _lin_equal("[mono] K9 at C=2 (the two-view BA)", schur_ba.Lin(*cb.ba_assemble(*k9)),
               schur_ba.Lin(*cb.ba_assemble_plain(*k9)), errs)
    log(f"[mono] best_two at the initialization search "
        f"({k4[0].shape[0]}x{k4[6].shape[0]}, window 100 px, octave 0), the whole search "
        f"(card against CPU) and K9 at C=2 (E={k9[5].numel()}) bit for bit")


def mono_phase(voc, dev, card, errs, clean):
    """EVAL.md's fig8-mono row through SlamSystem.track_monocular with its
    defaults (`mono_config`; the [loop] phase's clean renders through
    ImperfectCamera(noise_sigma=2.0)), then flush(): checked against
    REFERENCE_MONO's runs (the initialization frame, the frames tracked,
    the Sim3-aligned ATE, the keyframe count, a finite map; the loops
    reported); the initialization on the card against the CPU (`mono_parity`);
    a stream lap at depth STREAM_DEPTH over the first STREAM_LAP frames.
    Timed: track_monocular, an initialization attempt's search, RANSAC and
    CheckRT, the two-view BA, K4 at the init gate and K9 at C = 2. Counts
    set to 0 before the lap, read after. Returns (launches, results)."""
    cfg = mono_config()
    poses, frames = render_mono_frames(clean)
    rec, times, syncs, closure_nb, states, front = {}, [], [], [], [], []
    launch.reset_launches()
    t0 = time.perf_counter()
    with _mono_instruments(rec):
        s = _loop_lap(cfg, voc, frames, dev, times, syncs, closure_nb, states=states,
                      front=front)
    lap_s = time.perf_counter() - t0
    launches = dict(launch.LAUNCHES)
    refs = REFERENCE_MONO
    gt = [(i / cfg.fps, T) for i, T in enumerate(poses)]
    traj = s.get_trajectory()
    ate = trajectory.ate_rmse(traj, gt, with_scale=True)
    init = states.index(system.OK)
    r_init = [r["init_frame"] for r in refs]
    r_kf = [r["keyframes"] for r in refs]
    log(f"[mono] tracked {len(traj)} of {len(poses)} frames in {lap_s:.1f} s, initialized at "
        f"frame {init} (reference runs {r_init}); {int(s.m.n_keyframes)} keyframes in the map "
        f"(reference runs {r_kf}), {s._kf_seq_host} inserted, {int(s.m.n_points)} points; "
        f"{s.n_loops_closed} loops closed at "
        f"{[(c['kf_seq'], c['kf_frame'], c['cand_frame']) for c in s.loop_closures]} "
        f"(reference runs {[r['loops'] for r in refs]}: "
        f"{[[(c['kf_seq'], c['kf_frame'], c['cand_frame']) for c in r['closures']] for r in refs]}"
        f"); Sim3-aligned ATE {ate * 100:.3f} cm (reference runs "
        f"{[round(r['ate_m'] * 100, 3) for r in refs]} cm); launches over the lap: {launches}")
    if not min(r_init) - MONO_INIT_SLACK <= init <= max(r_init) + MONO_INIT_SLACK:
        raise AssertionError(f"[mono] initialized at frame {init}, the reference runs at {r_init}")
    if len(traj) < LOOP_TRACKED_FLOOR * len(poses):
        raise AssertionError(f"[mono] {len(traj)} of {len(poses)} frames tracked")
    if not ate <= 2 * max(r["ate_m"] for r in refs) + 0.01:
        raise AssertionError(f"[mono] ATE {ate:.4f} m > 2 x the reference runs' largest + 1 cm")
    if not (1 - KF_COUNT_SLACK) * min(r_kf) <= int(s.m.n_keyframes) <= \
            (1 + KF_COUNT_SLACK) * max(r_kf):
        raise AssertionError(f"[mono] {int(s.m.n_keyframes)} keyframes, the reference runs {r_kf}")
    bad = _map_finite(s.m)
    if bad:
        raise AssertionError(f"[mono] non-finite {bad} in the map")
    if any(not _genuine(poses, c) for c in s.loop_closures):
        raise AssertionError(f"[mono] a closure joins two places: "
                             f"{[(c['kf_frame'], c['cand_frame']) for c in s.loop_closures]}")
    missing = [k for k in PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"[mono] kernels never launched: {missing}")
    if set(front) != {(1, 1, 1)}:
        raise AssertionError(f"[mono] K1, K2, K3 launches per frame: {dict(Counter(front))}")
    mono_parity(rec, errs)

    stream = _stream_lap("[mono]", cfg, voc, frames[:STREAM_LAP], poses[:STREAM_LAP], dev, ate,
                         REFERENCE_STREAMS["mono"])

    parts = {}
    for part, ms in rec["ms"]:
        parts.setdefault(part, []).append(ms)
    kf_frames = {e["frame"] for e in s.metrics if e.get("kf")}
    after = [syncs[i] for i in range(init + 1, len(syncs)) if i not in kf_frames]
    plain_ms, kf_ms, closure_ms = _split_kf(times, s.metrics,
                                           [c["kf_frame"] for c in s.loop_closures])
    k4, k9 = rec["k4"], rec["k9"]
    cand4 = cm.window_candidates(*k4[:5], *k4[6:10], k4[11])
    pairs4 = int(k4[4].sum()) * int(k4[9].sum())
    e9 = k9[5].numel()
    res = {"track_ms_median": plain_ms, "keyframe_track_ms_median": kf_ms,
           "closure_track_ms": closure_ms, "lap_s": lap_s, "init_frame": init,
           "init_attempts": len(parts.get("initialize", [])),
           "search_ms": parts.get("search"), "initialize_ms": parts.get("initialize"),
           "check_rt_ms": parts.get("check_rt"), "two_view_ba_ms": parts.get("two_view_ba"),
           "syncs_per_frame_after_init_median": _median(after),
           "syncs_per_frame_after_init_max": max(after), "ate_m": ate, "tracked": len(traj),
           "loops": s.n_loops_closed, "keyframes": int(s.m.n_keyframes), **stream,
           "best_two_init": _input_timing(
               "[mono]", "best_two (window form)",
               f"{k4[0].shape[0]}x{k4[6].shape[0]}, the initialization search (100 px, octave 0)",
               lambda: cm.window_best_two(*k4), lambda: cm.window_best_two_plain(*k4),
               _proj_match_bytes(k4, cand4), k4[4].numel() + k4[9].numel() + 12 * pairs4
               + 24 * int(cand4.sum()), card),
           "ba_edge_two_view": _input_timing(
               "[mono]", "ba_edge", f"E={e9} ({k9[2].shape[0]} points x {k9[5].shape[1]}), C=2, "
               f"the two-view BA", lambda: cb.ba_assemble(*k9),
               lambda: cb.ba_assemble_plain(*k9), _ba_assemble_bytes(k9), 600 * e9, card)}
    log(f"[mono] {card}: track_monocular median {_fmt(plain_ms)} ms per frame without a keyframe, "
        f"{_fmt(kf_ms)} ms with one, closure frames {[round(t, 1) for t in closure_ms]} ms; "
        f"{res['init_attempts']} initialization attempts: search "
        f"{[round(t, 2) for t in parts.get('search', [])]} ms, initialize (RANSAC and CheckRT) "
        f"{[round(t, 2) for t in parts.get('initialize', [])]} ms, of it CheckRT "
        f"{[round(t, 2) for t in parts.get('check_rt', [])]} ms; the two-view BA "
        f"{[round(t, 2) for t in parts.get('two_view_ba', [])]} ms; host syncs per frame after "
        f"the initialization without a keyframe: median {_median(after)}, max {max(after)}")
    return launches, res


# ---------------------------------------------------------------------------
# [files]: sequences on disk through the port's example scripts
# ---------------------------------------------------------------------------

FILES_STEREO_PAIRS = 60     # [files]: block-stereo's first pairs, KITTI and EuRoC layouts
FILES_MONO_FRAMES = 90      # [files]: fig8-mono's first frames, TUM monocular layout
TUM_DEPTH_FACTOR = 5000.0   # TUM's DepthMapFactor: 16-bit depth PNG units per metre
TUM_DEPTH_LATE_S = 0.005    # depth timestamps after the rgb ones (associate_tum pairs them)
EUROC_T0_NS = 1403636579763555584   # EuRoC MH_01's first cam0 timestamp
TUM1_DISTORTION = dict(k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)
FILES_MONO_TRACKED_FLOOR = 0.95     # [files] tum-mono: frames tracked after initialization
RESUME_TOL_M = 0.05         # a resumed or relocalized camera centre (tests/test_checkpoint.py)
TRAJ_FILE_TOL = 1e-6        # the example script's trajectory files against get_trajectory()
FILES_KF_CHECKED = ("tum-rgbd", "tum-rgbd-distorted")   # keyframe frames held to the reference
FILES_PNG_FILTERS = "adaptive"  # the row filters libpng (so cv::imwrite) chooses
# kernels the drivers' laps need not launch: K7 is on no call chain; K4's node
# form runs where tracking falls back to the reference keyframe, relocalizes
# or closes a loop, which no lap does (the phase's resume relocalizes)
FILES_OFF_DRIVERS = {
    "pose_normal_eqs": "no call chain of the drivers reaches it",
    "best_two_node": "no driver lap falls back to the reference keyframe, relocalizes or "
                     "closes a loop: the [files] phase's node-form launches are the resume's "
                     "relocalization on the loaded map (files_resume_launches)"}
# What the reference (orb_slam2_tpu, XLA path) gives on the decoded files
# handed the port's CPU frames: `scripts/chip_smoke_reference.py --files-only`
# (its SlamSystem with its defaults and the vocabulary trained on the fly,
# as the example scripts construct it; depth_map_factor 1/5000 set in code): the
# state after every frame, the keyframe frames and the ATE.
REFERENCE_FILES = {
    'tum-rgbd': {'states': [1] * 31, 'kf_frames': [8, 9, 12, 15, 19, 26], 'tracked': 31,
                 'keyframes': 7, 'loops': 0, 'ate_m': 0.011376},
    'tum-rgbd-distorted': {'states': [1] * 31, 'kf_frames': [7, 8, 11, 14, 19, 28],
                           'tracked': 31, 'keyframes': 7, 'loops': 0, 'ate_m': 0.012344},
    'kitti-stereo': {'states': [1] * 60, 'kf_frames': [9, 10, 17, 23, 32, 43, 58],
                     'tracked': 60, 'keyframes': 8, 'loops': 0, 'ate_m': 0.006987}}


def write_png(path, img, filters=0, level=1):
    """A PNG of `img` with the standard library (zlib, struct): (H, W) uint8
    or uint16 gray, or (H, W, 3) uint8 RGB. filters: the row filter of every
    row (0-4: None, Sub, Up, Average, Paeth), "cycle" (row y gets y % 5) or
    "adaptive" (each row the filter whose bytes, read as signed, have the
    least absolute sum: libpng's default choice, so OpenCV's imwrite's);
    level: zlib's (1, the fastest: the smoke writes ~450 frames). Returns
    the rows of each filter (5,)."""
    import struct
    import zlib
    a = np.ascontiguousarray(img)
    h, w = a.shape[:2]
    ch = 1 if a.ndim == 2 else a.shape[2]
    if a.dtype == np.uint16:
        bits, rows = 16, a.astype(">u2").view(np.uint8).reshape(h, -1)
    elif a.dtype == np.uint8:
        bits, rows = 8, a.reshape(h, -1)
    else:
        raise ValueError(f"write_png: {a.dtype} samples")
    bpp = ch * bits // 8
    raw = rows.astype(np.int16)
    left, up, ul = (np.zeros_like(raw) for _ in range(3))
    left[:, bpp:], up[1:], ul[1:, bpp:] = raw[:, :-bpp], raw[:-1], raw[:-1, :-bpp]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    cand = np.stack([(raw - pred) % 256 for pred in (0, left, up, (left + up) // 2, paeth)])
    if filters == "adaptive":
        kinds = np.minimum(cand, 256 - cand).sum(-1).argmin(0)
    else:
        kinds = np.arange(h) % 5 if filters == "cycle" else np.full(h, filters)
    out = np.empty((h, rows.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    out[:, 1:] = cand[kinds, np.arange(h)]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, bits, {1: 0, 3: 2}[ch], 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(out.tobytes(), level)) + chunk(b"IEND", b""))
    return np.bincount(kinds, minlength=5)


def _settings(path, cfg, depth_factor=None, stereo_rect=False):
    """A settings YAML in the reference's format (`Examples/*/*.yaml`) for
    `cfg`'s camera and extractor; with stereo_rect, LEFT. / RIGHT. blocks of
    the identity rectification (D = 0, R = I, P = K)."""
    def mat(rows, cols, data):
        return (f" !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n   dt: d\n"
                f"   data: [{', '.join(repr(float(v)) for v in data)}]")
    lines = ["%YAML:1.0", ""]
    for key in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3"):
        lines.append(f"Camera.{key}: {getattr(cfg, key)!r}")
    lines += [f"Camera.width: {cfg.width}", f"Camera.height: {cfg.height}",
              f"Camera.fps: {cfg.fps!r}", "Camera.RGB: 1", f"ThDepth: {cfg.th_depth!r}"]
    if cfg.bf:
        lines.append(f"Camera.bf: {cfg.bf!r}")
    if depth_factor is not None:
        lines.append(f"DepthMapFactor: {depth_factor!r}")
    lines += [f"ORBextractor.nFeatures: {cfg.n_features}",
              f"ORBextractor.scaleFactor: {cfg.scale_factor!r}",
              f"ORBextractor.nLevels: {cfg.n_levels}",
              f"ORBextractor.iniThFAST: {cfg.ini_th_fast}",
              f"ORBextractor.minThFAST: {cfg.min_th_fast}"]
    if stereo_rect:
        K = [cfg.fx, 0.0, cfg.cx, 0.0, cfg.fy, cfg.cy, 0.0, 0.0, 1.0]
        for side in ("LEFT", "RIGHT"):
            lines += [f"{side}.height: {cfg.height}", f"{side}.width: {cfg.width}",
                      f"{side}.D:{mat(1, 5, [0.0] * 5)}", f"{side}.K:{mat(3, 3, K)}",
                      f"{side}.R:{mat(3, 3, np.eye(3).ravel())}",
                      f"{side}.P:{mat(3, 4, K[:3] + [0.0] + K[3:6] + [0.0] + K[6:] + [0.0])}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def distort_frame(gray, depth, cfg_distorted):
    """The pinhole render (gray, depth) as a camera with cfg_distorted's
    lens sees it: each pixel samples the render at its undistorted position
    (`undistort_pixels`), gray bilinear (rounded to uint8), depth nearest."""
    from orb_slam2_tpu_torch.geometry.camera import undistort_pixels
    h, w = gray.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    uv = undistort_pixels(cfg_distorted.camera(device="cpu"),
                          torch.from_numpy(np.stack([xx, yy], -1))).numpy()
    x, y = uv[..., 0], uv[..., 1]
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    ax, ay = np.clip(x - x0, 0, 1), np.clip(y - y0, 0, 1)
    g = gray.astype(np.float32)
    out = ((1 - ay) * ((1 - ax) * g[y0, x0] + ax * g[y0, x0 + 1])
           + ay * ((1 - ax) * g[y0 + 1, x0] + ax * g[y0 + 1, x0 + 1]))
    xn = np.clip(np.round(x).astype(np.int64), 0, w - 1)
    yn = np.clip(np.round(y).astype(np.int64), 0, h - 1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8), depth[yn, xn], (x, y)


def _depth_png(depth):
    return np.clip(np.round(depth * TUM_DEPTH_FACTOR), 0, 65535).astype(np.uint16)


def write_file_sequences(root, rgbd=None, mono_clean=None):
    """Write the [files] phase's sequences under `root`, in the datasets'
    own layouts, with a settings YAML each. rgbd: (poses, frames) of
    `render_frames()` (rendered here when None); mono_clean: the figure
    eight's first FILES_MONO_FRAMES clean renders (`render_loop_clean`'s
    triple; rendered when None). Every PNG with FILES_PNG_FILTERS' row
    filters. Returns {lap: dict(dir, settings, sensor, gt: [(timestamp,
    T_wc)], example, argv, written: each frame's images as its files hold
    them (the RGB PNG's gray, depth in 16-bit units), filter_rows: the rows
    of all laps by filter)}; the laps:
    - tum-rgbd: rgb/ (gray as 8-bit RGB), depth/ (16-bit at x5000), rgb.txt,
      depth.txt (5 ms late, one extra depth entry with no rgb partner);
    - tum-rgbd-distorted: the same poses through TUM1's fr1 lens;
    - kitti-stereo: image_0/, image_1/, times.txt (block-stereo's first
      FILES_STEREO_PAIRS pairs, uint8);
    - euroc-stereo: the same pairs, mav0/cam{0,1}/data.csv + data/<ns>.png,
      identity rectification blocks;
    - tum-mono: rgb/, rgb.txt (fig8-mono's first FILES_MONO_FRAMES, uint8)."""
    cfg = bench_config()
    fps = cfg.fps
    poses, frames = render_frames() if rgbd is None else rgbd
    laps = {}
    from concurrent.futures import ThreadPoolExecutor
    # zlib and numpy's whole-image operations release the GIL
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))
    written = []

    def png(path, a):
        written.append(pool.submit(write_png, path, a, FILES_PNG_FILTERS))

    def tum_rgbd(name, cfg_lap, images):
        d = os.path.join(root, name)
        os.makedirs(os.path.join(d, "rgb"))
        os.makedirs(os.path.join(d, "depth"))
        rgb_txt, depth_txt = ["# color images"], ["# depth maps"]
        for i, (gray, depth) in enumerate(images):
            ts = f"{i / fps:.6f}"
            png(os.path.join(d, "rgb", f"{ts}.png"), np.repeat(gray[..., None], 3, -1))
            dts = f"{i / fps + TUM_DEPTH_LATE_S:.6f}"
            png(os.path.join(d, "depth", f"{dts}.png"), _depth_png(depth))
            rgb_txt.append(f"{ts} rgb/{ts}.png")
            depth_txt.append(f"{dts} depth/{dts}.png")
        extra = f"{(len(images) + 3) / fps:.6f}"    # a depth map with no rgb partner
        png(os.path.join(d, "depth", f"{extra}.png"), _depth_png(images[-1][1]))
        depth_txt.append(f"{extra} depth/{extra}.png")
        for fname, lines in (("rgb.txt", rgb_txt), ("depth.txt", depth_txt)):
            with open(os.path.join(d, fname), "w") as f:
                f.write("\n".join(lines) + "\n")
        _settings(os.path.join(d, "settings.yaml"), cfg_lap, depth_factor=TUM_DEPTH_FACTOR)
        laps[name] = dict(dir=d, settings=os.path.join(d, "settings.yaml"), sensor=SENSOR_RGBD,
                          gt=[(float(f"{i / fps:.6f}"), T) for i, T in enumerate(poses)],
                          example="rgbd_tum", written=[(g, _depth_png(dp)) for g, dp in images])

    tum_rgbd("tum-rgbd", cfg, frames)
    cfg_d = dataclasses.replace(cfg, **TUM1_DISTORTION)
    tum_rgbd("tum-rgbd-distorted", cfg_d, [distort_frame(g, d, cfg_d)[:2] for g, d in frames])

    scfg = block_config()
    spose, pairs = render_block_frames(FILES_STEREO_PAIRS)
    q = lambda x: np.clip(np.round(x), 0, 255).astype(np.uint8)  # noqa: E731
    pairs = [(q(l), q(r)) for l, r in pairs]
    d = os.path.join(root, "kitti-stereo")
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(d, cam))
    for i, (l, r) in enumerate(pairs):
        png(os.path.join(d, "image_0", f"{i:06d}.png"), l)
        png(os.path.join(d, "image_1", f"{i:06d}.png"), r)
    with open(os.path.join(d, "times.txt"), "w") as f:
        f.write("".join(f"{i / fps:.6e}\n" for i in range(len(pairs))))
    _settings(os.path.join(d, "settings.yaml"), scfg)
    laps["kitti-stereo"] = dict(dir=d, settings=os.path.join(d, "settings.yaml"),
                                sensor=SENSOR_STEREO, example="stereo_kitti", written=pairs,
                                gt=[(float(f"{i / fps:.6e}"), T) for i, T in enumerate(spose)])
    d = os.path.join(root, "euroc-stereo")
    ns = [EUROC_T0_NS + round(i * 1e9 / fps) for i in range(len(pairs))]
    for k, cam in enumerate(("cam0", "cam1")):
        os.makedirs(os.path.join(d, "mav0", cam, "data"))
        for t, pair in zip(ns, pairs):
            png(os.path.join(d, "mav0", cam, "data", f"{t}.png"), pair[k])
        with open(os.path.join(d, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "".join(f"{t},{t}.png\n" for t in ns))
    _settings(os.path.join(d, "settings.yaml"), scfg, stereo_rect=True)
    laps["euroc-stereo"] = dict(dir=d, settings=os.path.join(d, "settings.yaml"),
                                sensor=SENSOR_STEREO, example="stereo_euroc", written=pairs,
                                gt=[(t * 1e-9, T) for t, T in zip(ns, spose)])

    mcfg = mono_config()
    if mono_clean is None:
        mono_clean = render_loop_clean(FILES_MONO_FRAMES)
    mposes, mframes = render_mono_frames(mono_clean)
    d = os.path.join(root, "tum-mono")
    os.makedirs(os.path.join(d, "rgb"))
    lines = ["# color images"]
    mono_written = [(q(img),) for img in mframes]
    for i, (img,) in enumerate(mono_written):
        ts = f"{i / fps:.6f}"
        png(os.path.join(d, "rgb", f"{ts}.png"), img)
        lines.append(f"{ts} rgb/{ts}.png")
    with open(os.path.join(d, "rgb.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    _settings(os.path.join(d, "settings.yaml"), mcfg)
    laps["tum-mono"] = dict(dir=d, settings=os.path.join(d, "settings.yaml"),
                            sensor=SENSOR_MONOCULAR, example="mono_tum", written=mono_written,
                            gt=[(float(f"{i / fps:.6f}"), T) for i, T in enumerate(mposes)])
    with pool:
        rows = sum(f.result() for f in written).tolist()
    for name, lap in laps.items():
        lap["argv"] = [lap["settings"], lap["dir"]] + \
            ([""] if lap["example"] == "rgbd_tum" else []) + [os.path.join(root, name)]
        lap["filter_rows"] = rows
    return laps


def decoded_sequence(lap):
    """The lap's frames as the port's dataset decodes them, and the
    decoder's name: [(timestamp, *images)]."""
    from orb_slam2_tpu_torch.geometry.rectify import StereoRectifier
    from orb_slam2_tpu_torch.utils import datasets
    d = lap["dir"]
    ds = {"rgbd_tum": lambda: datasets.TumRGBD(d), "mono_tum": lambda: datasets.TumMonocular(d),
          "stereo_kitti": lambda: datasets.KittiStereo(d),
          "stereo_euroc": lambda: datasets.EurocStereo(
              d, rectifier=StereoRectifier.from_settings(lap["settings"]))}[lap["example"]]()
    with ds:
        return list(ds), ds.decoder


def _files_track(s, frame):
    """The example script's call on one decoded frame (timestamp, *images)."""
    return _track_frame(s, frame[1] if s.cfg.sensor == SENSOR_MONOCULAR else frame[1:], frame[0])


def _memory_lap(cfg, frames, dev):
    """A fresh SlamSystem as the example scripts construct it, over decoded frames
    held in memory: returns (system, states, ms per call)."""
    s = system.SlamSystem(cfg, device=dev)
    states, times = [], []
    for frame in frames:
        t0 = time.perf_counter()
        _files_track(s, frame)
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(int(s.state))
    torch.cuda.synchronize()
    return s, states, times


def _same_run(tag, a, a_states, b, b_states, timestamps=True):
    """Two systems' runs bit for bit: the state after every call, the
    keyframe frames, and every trajectory pose (with its timestamp)."""
    ka = sorted(e["frame"] for e in a.metrics if e.get("kf"))
    kb = sorted(e["frame"] for e in b.metrics if e.get("kf"))
    ta, tb = a.get_trajectory(), b.get_trajectory()
    same = a_states == b_states and ka == kb and len(ta) == len(tb) and all(
        np.array_equal(x[1], y[1]) and (not timestamps or x[0] == y[0]) for x, y in zip(ta, tb))
    if not same:
        raise AssertionError(f"{tag}: states {a_states} / {b_states}, keyframes {ka} / {kb}, "
                             f"{len(ta)} / {len(tb)} poses")
    return ka


def _trajectory_files(tag, s, prefix):
    """The three files run_sequence wrote against the system's own records."""
    traj, kft = s.get_trajectory(), s.keyframe_trajectory()
    err = 0.0
    for path, want in ((prefix + "_FrameTrajectory_TUM.txt", traj),
                       (prefix + "_KeyFrameTrajectory_TUM.txt", kft)):
        back = trajectory.load_tum(path)
        if len(back) != len(want):
            raise AssertionError(f"{tag} {path}: {len(back)} of {len(want)} poses")
        for (t0, T0), (t1, T1) in zip(want, back):
            err = max(err, abs(t0 - t1), float(np.abs(T0 - T1).max()))
    kitti = np.loadtxt(prefix + "_CameraTrajectory_KITTI.txt", ndmin=2)
    if kitti.shape != (len(traj), 12):
        raise AssertionError(f"{tag} KITTI file: {kitti.shape}")
    if traj:
        err = max(err, float(np.abs(kitti - np.stack([T[:3, :4].ravel() for _, T in traj]))
                             .max()))
    if not err <= TRAJ_FILE_TOL:
        raise AssertionError(f"{tag}: trajectory files {err:.3g} from get_trajectory()")
    return err


def _reference_check(tag, name, states, s, gt, sensor):
    """A lap against REFERENCE_FILES[name]: the same states, keyframe frames
    within SYSTEM_KF_SLACK (the TUM laps), ATE <= 2x the reference's + 1
    cm, a finite map."""
    ref = REFERENCE_FILES[name]
    ate = trajectory.ate_rmse(s.get_trajectory(), gt, with_scale=sensor == SENSOR_MONOCULAR)
    kf = sorted(e["frame"] for e in s.metrics if e.get("kf"))
    log(f"{tag} {name}: states against the reference's {'equal' if states == ref['states'] else 'DIFFERENT'}; "
        f"keyframes at {kf} (reference {ref['kf_frames']}); ATE {ate * 100:.3f} cm (reference "
        f"{ref['ate_m'] * 100:.3f} cm)")
    if states != ref["states"]:
        raise AssertionError(f"{tag} {name}: states {states} != the reference's {ref['states']}")
    if name in FILES_KF_CHECKED and (len(kf) != len(ref["kf_frames"]) or any(
            abs(a - b) > SYSTEM_KF_SLACK for a, b in zip(kf, ref["kf_frames"]))):
        raise AssertionError(f"{tag} {name}: keyframes at {kf}, the reference's at "
                             f"{ref['kf_frames']}")
    if not ate <= 2 * ref["ate_m"] + 0.01:
        raise AssertionError(f"{tag} {name}: ATE {ate:.4f} m > 2 x the reference's "
                             f"{ref['ate_m']:.4f} m + 1 cm")
    bad = _map_finite(s.m)
    if bad:
        raise AssertionError(f"{tag} {name}: non-finite {bad} in the map")
    return ate


def _resume(tag, cfg, s, frames, gt, dev, path):
    """save_map after the lap, load_map on the card (every field bit for
    bit against the saved map with its derived caches rebuilt, as load_map
    rebuilds them), then a fresh system in localization mode on the loaded map:
    seeded at the newest keyframe's frame (tests/test_checkpoint.py:40-69)
    it tracks the next frame within RESUME_TOL_M and inserts no keyframe;
    kidnapped (state LOST) it relocalizes a mapped frame within
    RESUME_TOL_M. Returns the numbers."""
    from orb_slam2_tpu_torch.utils import checkpoint
    t0 = time.perf_counter()
    checkpoint.save_map(path, s.m, extra=dict(frame_id=s.frame_id))
    m2, extra = checkpoint.load_map(path, device=dev)
    io_ms = (time.perf_counter() - t0) * 1e3
    saved = mapstate.refresh_obs_table(s.m)    # load_map rebuilds the derived caches
    differ = [n for n in mapstate.MapState._fields
              if not torch.equal(getattr(saved, n), getattr(m2, n))]
    if differ or int(extra["frame_id"]) != s.frame_id:
        raise AssertionError(f"{tag} load_map: fields {differ} differ from the saved map")
    s2 = system.SlamSystem(cfg, vocabulary=s.voc, device=dev)
    s2.m = m2
    s2.db = s2._empty_db()
    valid = np.nonzero(m2.kf_valid.cpu().numpy())[0]
    for k in valid:
        s2.db = s2.db.add(int(k), s2._bow_vec(m2.kf_desc[int(k)], m2.kf_feat_valid[int(k)]))
    s2.activate_localization_mode()
    fid = m2.kf_frame_id.cpu().numpy()
    kf = int(valid[np.argmax(fid[valid])])
    i = int(fid[kf])
    nxt = i + 1 if i + 1 < len(frames) else i - 1
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    s2.state, s2.ref_kf = system.OK, kf
    s2._set_last(make_frame_rgbd(up(frames[i][1]), up(frames[i][2]), cfg), m2.kf_pose[kf],
                 m2.kf_obs[kf])
    n_kf = int(m2.n_keyframes)
    T = s2.track_rgbd(frames[nxt][1], frames[nxt][2], frames[nxt][0])
    err = None if T is None else _centre_error(torch.from_numpy(T), gt[0][1], gt[nxt][1])
    if T is None or not err <= RESUME_TOL_M or int(s2.m.n_keyframes) != n_kf:
        raise AssertionError(f"{tag} resume: frame {nxt} from keyframe {kf} (frame {i}): "
                             f"centre error {err}, keyframes {int(s2.m.n_keyframes)} of {n_kf}")
    s2.state = system.LOST
    k = KIDNAP_POSE
    t0 = time.perf_counter()
    T = s2.track_rgbd(frames[k][1], frames[k][2], frames[k][0] + 99.0)
    reloc_ms = (time.perf_counter() - t0) * 1e3
    rerr = None if T is None else _centre_error(torch.from_numpy(T), gt[0][1], gt[k][1])
    if T is None or not rerr <= RESUME_TOL_M or int(s2.m.n_keyframes) != n_kf:
        raise AssertionError(f"{tag} resume: relocalizing frame {k} on the loaded map: centre "
                             f"error {rerr}, keyframes {int(s2.m.n_keyframes)} of {n_kf}")
    log(f"{tag} checkpoint: save_map / load_map of {n_kf} keyframes and {int(m2.n_points)} "
        f"points in {io_ms:.1f} ms ({os.path.getsize(path) / 1e6:.2f} MB), every field bit for "
        f"bit; resumed in localization mode at keyframe {kf} (frame {i}): frame {nxt} tracked "
        f"{err * 100:.3f} cm from the truth, no keyframe inserted; kidnapped, frame {k} "
        f"relocalized on the loaded map {rerr * 100:.3f} cm from the truth in {reloc_ms:.1f} ms")
    return dict(save_load_ms=io_ms, resume_err_m=err, reloc_err_m=rerr, reloc_ms=reloc_ms,
                checkpoint_mb=os.path.getsize(path) / 1e6)


@contextmanager
def _driver_records(module):
    """The driver module's `run_dataset` wrapped while the block runs: the
    records of the driver's own loop (its decoder, the frames its dataset
    gave, each frame's seconds waiting on the dataset and in its track_*
    call, the state after it)."""
    rec = {}
    run = module.run_dataset

    def timed(ds, load_s, frames):
        it = iter(ds)
        while True:
            t0 = time.perf_counter()
            frame = next(it, None)
            if frame is None:
                return
            load_s.append(time.perf_counter() - t0)
            frames.append(frame)
            yield frame

    def wrapped(s, ds, track_fn, prefix):
        load_s, track_s, states, frames = [], [], [], []

        def track(s_, frame):
            t0 = time.perf_counter()
            T = track_fn(s_, frame)
            track_s.append(time.perf_counter() - t0)
            states.append(int(s_.state))
            return T
        rec.update(decoder=ds.decoder, load_s=load_s, track_s=track_s, states=states,
                   frames=frames)
        try:
            return run(s, timed(ds, load_s, frames), track, prefix)
        finally:
            ds.close()
    module.run_dataset = wrapped
    try:
        yield rec
    finally:
        module.run_dataset = run


def _decode_ms(path, n=5):
    """The port's PNG decoder on one file in this thread: the median ms."""
    from orb_slam2_tpu_torch.utils import datasets
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        datasets.decode_png(path)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def files_phase(dev, card, rgbd, mono_clean):
    """The port's example scripts (`orb_slam2_tpu_torch/examples/`) on sequences
    written to disk in the datasets' layouts (`write_file_sequences`), each
    through `main(argv, device)`: SlamSystem(cfg) as the scripts construct
    it (loop closing on, the vocabulary trained on the fly), the settings
    YAML read by `SlamConfig.from_yaml`. Checked per lap (see the module
    docstring); then the checkpoint after tum-rgbd. The counts are set to 0
    just before each driver's main and read just after it; the in-memory
    twin laps and the resume are counted apart. Returns ({"drivers",
    "twins", "resume": launches}, results)."""
    from orb_slam2_tpu_torch.examples import mono_tum, rgbd_tum, stereo_euroc, stereo_kitti
    from orb_slam2_tpu_torch.utils import datasets
    examples = {"rgbd_tum": rgbd_tum, "mono_tum": mono_tum, "stereo_kitti": stereo_kitti,
                "stereo_euroc": stereo_euroc}
    tag = "[files]"
    holder = tempfile.TemporaryDirectory(prefix="chip_smoke_files_")
    tmp = holder.name
    t0 = time.perf_counter()
    laps = write_file_sequences(tmp, rgbd, mono_clean)
    write_s = time.perf_counter() - t0
    n_files = sum(len(fs) for lap in laps.values() for _, _, fs in os.walk(lap["dir"]))
    filter_rows = laps["tum-rgbd"]["filter_rows"]
    log(f"{tag} wrote {len(laps)} sequences ({n_files} files, "
        f"{sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(tmp) for f in fs) / 1e6:.1f}"
        f" MB) in {write_s:.1f} s: {list(laps)}; PNG rows by filter (None, Sub, Up, Average, "
        f"Paeth, {FILES_PNG_FILTERS}): {filter_rows}")
    lib = datasets._load_native()
    probe = datasets.ImageStream([])
    decoder = probe.decoder
    probe.close()
    log(f"{tag} the native decoder {datasets._LIB_PATH}: "
        f"{'loaded' if lib is not None else 'not loaded (' + str(datasets._lib_error) + ')'}"
        f"; ImageStream's decoder: {decoder}")

    # the decoder alone on one 640x480 file of each kind, as written and
    # with every row filter None
    d = laps["tum-rgbd"]["dir"]
    first = {"gray": os.path.join(laps["kitti-stereo"]["dir"], "image_0", "000000.png"),
             "rgb": os.path.join(d, "rgb", sorted(os.listdir(os.path.join(d, "rgb")))[0]),
             "depth16": os.path.join(d, "depth", sorted(os.listdir(os.path.join(d, "depth")))[0])}
    decode_ms = {}
    for kind, path in first.items():
        img = datasets.decode_png(path)
        plain = os.path.join(tmp, f"filter_none_{kind}.png")
        write_png(plain, (img[..., 0] if img.shape[2] == 1 else img).astype(
            np.uint16 if kind == "depth16" else np.uint8))
        decode_ms[kind] = {FILES_PNG_FILTERS: _decode_ms(path), "none": _decode_ms(plain)}
    log(f"{tag} the port's PNG decoder on one 640x480 file in one thread, {card}: "
        + "; ".join(f"{k} {v[FILES_PNG_FILTERS]:.2f} ms ({FILES_PNG_FILTERS} filters), "
                    f"{v['none']:.2f} ms (filter None)" for k, v in decode_ms.items()))

    voc_ms = []
    build = system.bow_voc.build_vocabulary

    def timed_build(*a, **kw):
        t = time.perf_counter()
        out = build(*a, **kw)
        torch.cuda.synchronize()
        voc_ms.append((time.perf_counter() - t) * 1e3)
        return out
    system.bow_voc.build_vocabulary = timed_build
    res, systems = {}, {}
    counts = {k: dict.fromkeys(launch.LAUNCHES, 0) for k in ("drivers", "twins", "resume")}

    def read_counts(into):
        for k, v in launch.LAUNCHES.items():
            counts[into][k] += v
    t_phase = time.perf_counter()
    try:
        for name, lap in laps.items():
            cfg = SlamConfig.from_yaml(lap["settings"], sensor=lap["sensor"])
            module = examples[lap["example"]]
            with _driver_records(module) as rec:
                launch.reset_launches()
                t0 = time.perf_counter()
                s = module.main(lap["argv"], device=dev)
                torch.cuda.synchronize()
                lap_s = time.perf_counter() - t0
                read_counts("drivers")
            systems[name] = s
            states, load_s, track_s = rec["states"], rec["load_s"], rec["track_s"]
            # what the driver read is what was written: gray exactly, depth
            # to its 16-bit value
            frames_l = rec.pop("frames")
            if len(frames_l) != len(lap["written"]):
                raise AssertionError(f"{tag} {name}: {len(frames_l)} frames read of "
                                     f"{len(lap['written'])}")
            for (ts, *got), want in zip(frames_l, lap["written"]):
                if not all(np.array_equal(g, w.astype(np.float32)) for g, w in zip(got, want)):
                    raise AssertionError(f"{tag} {name}: the frame at {ts} decodes to other "
                                         f"values than were written")
            kf = sorted(e["frame"] for e in s.metrics if e.get("kf"))
            r = dict(frames=len(states), tracked=len(s.get_trajectory()), keyframes=len(kf),
                     lap_s=lap_s, decoder=rec["decoder"],
                     track_ms_median=statistics.median(track_s[1:]) * 1e3,
                     load_wait_share=sum(load_s) / (sum(load_s) + sum(track_s)),
                     load_wait_ms_median=statistics.median(load_s) * 1e3,
                     traj_file_err=_trajectory_files(f"{tag} {name}", s, lap["argv"][-1]))
            if s.voc is None or not bool(s.db.valid[s.m.kf_valid].all()):
                raise AssertionError(f"{tag} {name}: the vocabulary trained on the fly is "
                                     f"missing or lacks a live keyframe")
            if rec["decoder"] != decoder:
                raise AssertionError(f"{tag} {name}: decoder {rec['decoder']}, {decoder} "
                                     f"expected")
            if name in ("tum-rgbd", "kitti-stereo", "tum-mono"):
                launch.reset_launches()
                m, m_states, m_times = _memory_lap(cfg, frames_l, dev)
                read_counts("twins")
                _same_run(f"{tag} {name} (the example script from files against decoded arrays in "
                          f"memory)", s, states, m, m_states)
                r["memory_track_ms_median"] = statistics.median(m_times[1:])
                del m
            if name == "euroc-stereo":
                _same_run(f"{tag} euroc-stereo against kitti-stereo", s, states,
                          systems["kitti-stereo"], res["kitti-stereo"]["states"],
                          timestamps=False)
            if name in REFERENCE_FILES:
                r["ate_m"] = _reference_check(tag, name, states, s, lap["gt"], lap["sensor"])
            else:
                r["ate_m"] = trajectory.ate_rmse(s.get_trajectory(), lap["gt"],
                                                 with_scale=lap["sensor"] == SENSOR_MONOCULAR)
            if name == "tum-mono":
                init = states.index(system.OK) if system.OK in states else None
                after = len(states) - (init or 0)
                r["init_frame"] = init
                if init is None or r["tracked"] < FILES_MONO_TRACKED_FLOOR * after:
                    raise AssertionError(f"{tag} tum-mono: initialized at {init}, "
                                         f"{r['tracked']} of {after} frames tracked after")
            if name == "tum-rgbd":
                launch.reset_launches()
                r.update(_resume(tag, cfg, s, frames_l, lap["gt"], dev,
                                 os.path.join(tmp, "map.npz")))
                read_counts("resume")
            r["states"] = states
            res[name] = r
            del frames_l
            log(f"{tag} {name} through {lap['example']}.main: {r['tracked']} of {r['frames']} "
                f"frames tracked, keyframes at {kf}, ATE {r['ate_m'] * 100:.3f} cm"
                f"{'' if name != 'tum-mono' else f' (Sim3-aligned, initialized at frame {init})'}"
                f"; every image read as written; {card}: track median "
                f"{r['track_ms_median']:.2f} ms from files"
                f"{'' if 'memory_track_ms_median' not in r else ', %.2f ms in memory (the same run bit for bit)' % r['memory_track_ms_median']}"
                f"; waiting on the loader {r['load_wait_share']:.2%} of each frame (median "
                f"{r['load_wait_ms_median']:.2f} ms); trajectory files within "
                f"{r['traj_file_err']:.2g} of get_trajectory()")
    finally:
        system.bow_voc.build_vocabulary = build
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    del systems
    holder.cleanup()
    log(f"{tag} launches of the drivers' mains: {counts['drivers']}; of the in-memory twin "
        f"laps: {counts['twins']}; of the resume: {counts['resume']}; the vocabulary trained "
        f"on the fly in {[round(t, 1) for t in voc_ms]} ms (one per system); the phase "
        f"{phase_s:.1f} s")
    missing = [k for k, v in counts["drivers"].items() if v == 0 and k not in FILES_OFF_DRIVERS]
    if missing:
        raise AssertionError(f"{tag} kernels the drivers never launched: {missing}")
    missing = [k for k in launch.LAUNCHES if k != "pose_normal_eqs"
               and not sum(c[k] for c in counts.values())]
    if missing:
        raise AssertionError(f"{tag} kernels the phase never launched: {missing}")
    for name in res:
        res[name].pop("states")
    return counts, dict(laps=res, decoder=decoder, decode_ms_one_file=decode_ms,
                        filter_rows=filter_rows, write_s=write_s, vocabulary_ms=voc_ms,
                        phase_s=phase_s)


# ---------------------------------------------------------------------------
# [eval]: the torture row's first trough through SlamSystem
# ---------------------------------------------------------------------------

# What the reference (orb_slam2_tpu, XLA path) gives on [eval]'s frames handed
# the port's CPU extraction: `scripts/chip_smoke_reference.py --eval-only`
# (its SlamSystem with the row's config, loop closing on,
# synth_vocabulary(10, 6), then flush()): the loops, the frames tracked, the
# keyframes inserted and kept, the points, the keyframe frames, the states of
# the first 31 frames, the frames not tracked, the frames that fell back to
# the reference keyframe and the ATE.
REFERENCE_EVAL = {'loops': 0, 'closures': [], 'tracked': 150, 'keyframes_inserted': 11,
                  'keyframes': 11, 'points': 2601,
                  'kf_frames': [10, 11, 15, 20, 26, 38, 60, 85, 108, 134],
                  'states': [1] * 31, 'lost_frames': [], 'fallback_frames': [],
                  'ate_m': 0.041967}


def eval_phase(voc, dev, card):
    """EVAL.md's torture-forward-rgbd row (`eval_synthetic_hard.row`: the
    long forward drive under exposure amplitude 0.25 at 0.12 m a frame, 256
    keyframes and 32,768 points), its first EVAL_FRAMES frames (the gain
    falls to 0.75 at frame 135), rendered on threads ahead of the tracker,
    through SlamSystem.track_rgbd synchronously with loop closing on, then
    flush(): checked against REFERENCE_EVAL (the states of the first
    SEQ_FRAMES_CHECKED frames, then the evaluation rows' bands, `check_row`),
    a finite map, every kernel of PATH_KERNELS launched. Logged: the frames
    that took the wide-window retry (the step's scalars[10]) and the
    fallback to the reference keyframe. Counts set to 0 before the lap, read
    after. Returns (launches, results)."""
    r = ev.row("torture-forward-rgbd")
    poses = r.gt[:EVAL_FRAMES]
    frames = ((a, b) for _, a, b in ev.row_frames(r, EVAL_FRAMES, ahead=RENDER_AHEAD))
    times, states, closure_nb = [], [], []
    launch.reset_launches()
    t0 = time.perf_counter()
    s = _loop_lap(r.cfg, voc, frames, dev, times, closure_nb=closure_nb, states=states)
    lap_s = time.perf_counter() - t0
    launches = dict(launch.LAUNCHES)
    ref = REFERENCE_EVAL
    gt = [(i / r.cfg.fps, T) for i, T in enumerate(poses)]
    traj = s.get_trajectory()
    ate = trajectory.ate_rmse(traj, gt)
    retry = [e["frame"] for e in s.metrics if e.get("retry")]
    fallback = [e["frame"] for e in s.metrics if e.get("fallback")]
    plain_ms, kf_ms, closure_ms = _split_kf(times, s.metrics,
                                           [c["kf_frame"] for c in s.loop_closures])
    log(f"[eval] {card}: torture-forward-rgbd's first {len(poses)} frames: {len(traj)} tracked "
        f"(reference {ref['tracked']}) in {lap_s:.1f} s; {s._kf_seq_host} keyframes inserted "
        f"(reference {ref['keyframes_inserted']}), {int(s.m.n_keyframes)} kept, "
        f"{int(s.m.n_points)} points; {s.n_loops_closed} loops (reference {ref['loops']}); ATE "
        f"{ate * 100:.3f} cm (reference {ref['ate_m'] * 100:.3f} cm); the wide-window retry on "
        f"{len(retry)} frames {retry}, the fallback on {len(fallback)} frames {fallback} "
        f"(reference {ref['fallback_frames']}); track_rgbd median {_fmt(plain_ms)} ms without a "
        f"keyframe, {_fmt(kf_ms)} ms with one; launches over the lap: {launches}")
    got_states = [int(st) for st in states[:SEQ_FRAMES_CHECKED]]
    if got_states != ref["states"]:
        raise AssertionError(f"[eval] states of frames 0-{SEQ_FRAMES_CHECKED - 1} {got_states}, "
                             f"the reference's {ref['states']}")
    closures = [dict(c, cand_neighbour_frames=nb) for c, nb in zip(s.loop_closures, closure_nb)]
    misses = check_row(dict(frames=len(poses), tracked=len(traj),
                            keyframes_inserted=s._kf_seq_host, loops=s.n_loops_closed,
                            closures=closures, ate_m=ate), ref, poses)
    if misses:
        raise AssertionError(f"[eval] {misses[0]}")
    bad = _map_finite(s.m)
    if bad:
        raise AssertionError(f"[eval] non-finite {bad} in the map")
    missing = [k for k in PATH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"[eval] kernels never launched: {missing}")
    return launches, {"tracked": len(traj), "keyframes_inserted": s._kf_seq_host,
                      "loops": s.n_loops_closed, "ate_m": ate, "lap_s": lap_s,
                      "retry_frames": retry, "fallback_frames": fallback,
                      "track_ms_median": plain_ms, "keyframe_track_ms_median": kf_ms,
                      "closure_track_ms": closure_ms}


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
    uploads_rec = [(torch.from_numpy(g).to(dev), torch.from_numpy(d).to(dev))
                   for g, d in frames[:N_RECORD]]
    with twins(), recording(recorded):
        run_sequence(cfg, uploads_rec)
    match_pose_parity(recorded, dev, errs)
    map_parity(recorded, dev, errs)

    launches, uploads, inputs, results, syncs, reads, events = main_path_phase(
        cfg, poses, frames, dev)
    side_launches = {"pose_normal_eqs": k7_path(recorded)}
    voc = synth_vocabulary(10, 6, device=dev)
    log(f"[system] synth_vocabulary(10, 6): {voc.n_nodes} nodes, {voc.n_words} words on the "
        f"card ({_nbytes(voc.children, voc.centroids, voc.word_id, voc.word_weight) / 1e6:.1f} MB)")
    system_launches, system_res = system_phase(cfg, poses, frames, voc, dev, card)
    t0 = time.perf_counter()
    clean = render_loop_clean()
    log(f"[loop] rendered the figure eight: {len(clean[2])} frames {W}x{H} in "
        f"{time.perf_counter() - t0:.1f} s")
    loop_launches, k9_gba, loop_res, lap = loop_phase(cfg, voc, dev, card, errs, clean)
    multi_launches, multi_res = multi_phase(cfg, voc, dev, card, errs, lap)
    del lap
    if not launches["best_two_node"]:
        # no frame of the forced run fell back to the reference keyframe:
        # the node form's launches are the [system] phase's (relocalization)
        side_launches["best_two_node"] = system_launches["best_two_node"]
    missing = [k for k, v in {**launches, **side_launches}.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")
    per_call = timing_phase(cfg, frames, uploads, inputs, results, recorded, syncs, reads,
                            events, dev, card)
    stereo_launches, stereo_res = stereo_phase(voc, dev, card, errs,
                                               loop_res.pop("plain_frame_syncs"))
    mono_launches, mono_res = mono_phase(voc, dev, card, errs, clean)
    files_launches, files_res = files_phase(
        dev, card, (poses, frames),
        (clean[0], clean[1][:FILES_MONO_FRAMES], clean[2][:FILES_MONO_FRAMES]))
    del clean
    eval_launches, eval_res = eval_phase(voc, dev, card)
    log(f"[result] {card}: " + json.dumps({"system": system_res, "loop": loop_res,
                                           "multi": multi_res, "stereo": stereo_res,
                                           "mono": mono_res, "files": files_res,
                                           "eval": eval_res}))
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # K7 is on no call chain of the main path: its `launches` are the side
    # run's (k7_path), and `main_path_launches` says what the main path gave;
    # `system_launches` are the [system] phase's, `loop_launches` the [loop]
    # phase's (K9's `gba`: its launches and timing at the global BA's shape),
    # `multi_launches` the [multi] phase's split lap's, `stereo_launches` and
    # `mono_launches` those of the [stereo] and [mono] laps, `files_launches`
    # those of the [files] phase's driver mains (`files_twin_launches` its
    # in-memory twin laps', `files_resume_launches` its resume's), `eval_launches`
    # those of the [eval] lap; the timings at their new inputs beside them (K1-K3 on a stereo
    # pair's right image, K4 at the initialization search, K9 at C = 2)
    froms = {"pose_normal_eqs": "a run of its own: no call chain of the main path reaches it",
             "best_two_node": "the [system] phase: relocalization's BoW search (no frame of "
                              "the main path fell back to the reference keyframe)"}
    kernels = []
    for name, (src, rep) in SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": side_launches.get(name, launches[name]),
                 "main_path_launches": launches[name],
                 "system_launches": system_launches[name],
                 "loop_launches": loop_launches[name], "multi_launches": multi_launches[name],
                 "stereo_launches": stereo_launches[name], "mono_launches": mono_launches[name],
                 "files_launches": files_launches["drivers"][name],
                 "files_twin_launches": files_launches["twins"][name],
                 "files_resume_launches": files_launches["resume"][name],
                 "eval_launches": eval_launches[name],
                 "max_abs_err": errs[name], **per_call[name]}
        if name == "ba_edge":
            entry["gba"] = k9_gba
            entry["shard"] = multi_res["solvers"]["k9_shard"]
            entry["two_view"] = mono_res["ba_edge_two_view"]
        if name == "best_two":
            entry["init_search"] = mono_res["best_two_init"]
        if name in FRONT_KERNELS:
            entry["stereo_right_image"] = stereo_res["right_image"][name]
        if name in side_launches:
            entry["launches_from"] = froms[name]
        if not files_launches["drivers"][name]:
            entry["files_launches_from"] = FILES_OFF_DRIVERS[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
