"""The global-BA entry: the global bundle adjustment a loop closure
triggers, as the port's system schedules it (`SlamSystem._gba_chunk`):
`gba_async_chunks` chained calls of `loop_closing.run_global_ba(cfg, m,
n_iters=ceil(gba_total_iters / gba_async_chunks))`, each on the map the
last returned. Every global BA in the window starts from the same drifted
map `m0`, built in set-up through the port's map API from the harness's
synthetic arrays, so no state carries from one to the next.

Set-up: the arrays (`harness/mapgen.py`), the map, and two warm global
BAs (the kernels built or loaded from the checkout's build cache, every
shape run once). Correctness: once the window has closed, each distinct
answer the window produced is judged against the plain reference
(`harness/reference.py`) run in float64 on the same arrays.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
import time

import torch

from orb_slam2_tpu_torch.mapstate import map as mapstate
from orb_slam2_tpu_torch.pipeline import loop_closing
from orb_slam2_tpu_torch.solvers import pcg_ba, schur_ba
from orb_slam2_tpu_torch.utils import config as slam_config

from slambench.harness import counts, mapgen, reference, trace as tracing

SENSORS = {"monocular": slam_config.SENSOR_MONOCULAR, "stereo": slam_config.SENSOR_STEREO,
           "rgbd": slam_config.SENSOR_RGBD}
SPANS = ("gba", "gba.chunk", "loop_closing.problem", "solver.solve")
K9_NAME = "ba_assemble_kernel"
WARM_GBAS = 2
PROBLEM_REPS = 20


def sync(device):
    """Wait for the device (nothing to wait for on the CPU, where the tests
    drive this entry at small sizes)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def slam_config_of(data: dict) -> slam_config.SlamConfig:
    fields = dict(data["slam"])
    fields["sensor"] = SENSORS[fields["sensor"]]
    return slam_config.SlamConfig(**fields)


@dataclasses.dataclass
class State:
    data: dict
    scfg: slam_config.SlamConfig
    arr: mapgen.MapArrays
    m0: mapstate.MapState
    device: torch.device
    chunks: int
    iters: int
    warm_s: float = 0.0
    phases: dict = dataclasses.field(default_factory=dict)   # set-up seconds by phase
    ref: tuple = None                # (float64 problem, its solution judged), once computed
    out_poses: torch.Tensor = None   # (n_keep, K, 4, 4) the window's answers
    out_points: torch.Tensor = None  # (n_keep, P, 3)


def build_map(scfg, arr: mapgen.MapArrays, device) -> mapstate.MapState:
    """The program's map of `arr`, through the port's public map API: the
    keyframes, then the points, then each keyframe's bindings."""
    K, P, N = scfg.max_keyframes, scfg.max_map_points, scfg.max_keypoints
    feat_point, xy, ur, depth, level = mapgen.keyframe_major(arr, N)
    m = mapstate.empty(K, P, N, device=device)
    frame_ids = arr.frame_id.tolist()
    angle = torch.zeros((N,), dtype=torch.float32, device=device)
    desc = torch.zeros((N, 8), dtype=torch.int32, device=device)
    unbound = torch.full((N,), -1, dtype=torch.int32, device=device)
    slots = []
    for k in range(int(arr.kf_valid.sum())):
        m, slot = mapstate.add_keyframe(m, arr.Tcw[k], xy[k], level[k].to(torch.int32), angle,
                                        desc, ur[k], depth[k], feat_point[k] >= 0, unbound,
                                        frame_ids[k], float(k))
        slots.append(slot)
    pt_slots = mapstate.allocate_points(m, arr.pt_valid)
    ref = arr.anchor.clamp(min=0)
    m = mapstate.add_points(m, pt_slots, arr.points,
                            torch.zeros((P, 8), dtype=torch.int32, device=device), ref, ref)
    feat = torch.arange(N, dtype=torch.int32, device=device)
    for k, slot in enumerate(slots):
        fp = feat_point[k]
        ids = pt_slots[fp.clamp(min=0)]
        m = mapstate.bind_observations(m, slot, feat, ids, fp >= 0)
    return m


def run_once(st: State):
    """One global BA from m0: (kf_pose, pt_pos) of the map it returns."""
    m = st.m0
    for _ in range(st.chunks):
        m = loop_closing.run_global_ba(st.scfg, m, n_iters=st.iters)
    return m.kf_pose, m.pt_pos


def setup(data: dict, traffic: dict, seed: int, device, seconds: float) -> State:
    t0 = time.perf_counter()
    phases = {}
    scfg = slam_config_of(data)
    torch.empty((1,), device=device)
    sync(device)
    phases["device"] = time.perf_counter() - t0
    arr = mapgen.synthesize(data, traffic, seed, device)
    sync(device)
    phases["arrays"] = time.perf_counter() - t0 - sum(phases.values())
    chunks = scfg.gba_async_chunks
    st = State(data=data, scfg=scfg, arr=arr, m0=build_map(scfg, arr, device), device=device,
               chunks=chunks, iters=max(1, -(-scfg.gba_total_iters // chunks)), phases=phases)
    sync(device)
    phases["map"] = time.perf_counter() - t0 - sum(phases.values())
    for i in range(WARM_GBAS):
        t1 = time.perf_counter()
        run_once(st)
        sync(device)
        st.warm_s = time.perf_counter() - t1
        phases[f"warm{i}"] = st.warm_s
    # room for every answer of the window (twice the warm count), the
    # last slot taken by each answer past it
    n_keep = int(2 * seconds / max(st.warm_s, 1e-3)) + 8
    st.out_poses = torch.empty((n_keep,) + tuple(st.m0.kf_pose.shape), device=device)
    st.out_points = torch.empty((n_keep,) + tuple(st.m0.pt_pos.shape), device=device)
    return st


def keep(st: State, i: int, answer):
    j = min(i, st.out_poses.shape[0] - 1)
    st.out_poses[j].copy_(answer[0])
    st.out_points[j].copy_(answer[1])


def _spanned(fn, name):
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


def traced(st: State, min_s: float, min_gbas: int, host: bool):
    """A short traced window: global BAs from m0 under the profiler until
    min_s has passed and at least min_gbas ran. With `host`, the host's
    operators too, and each global BA, chunk, problem build and solve in a
    span of its own (which slows the host: the gaps' names come from such
    a window, the device's busy time and activities from one without).
    Returns (trace, count)."""
    patched = [(loop_closing, "global_ba_problem", "loop_closing.problem"),
               (pcg_ba, "solve_ba_pcg", "solver.solve"), (schur_ba, "solve_ba", "solver.solve")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    span = torch.profiler.record_function if host else (lambda name: contextlib.nullcontext())
    n = 0
    try:
        if host:
            for mod, attr, name in patched:
                setattr(mod, attr, _spanned(getattr(mod, attr), name))
        sync(st.device)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            while n < min_gbas or time.perf_counter() - t0 < min_s:
                with span("gba"):
                    m = st.m0
                    for _ in range(st.chunks):
                        with span("gba.chunk"):
                            m = loop_closing.run_global_ba(st.scfg, m, n_iters=st.iters)
                    sync(st.device)
                n += 1
            window_s = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return tracing.read(prof, SPANS, window_s), n


def problem_ms(st: State) -> float:
    """Device ms of one `global_ba_problem(cfg, m0)` called alone: CUDA
    events around PROBLEM_REPS calls back to back."""
    loop_closing.global_ba_problem(st.scfg, st.m0)
    sync(st.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(PROBLEM_REPS):
        loop_closing.global_ba_problem(st.scfg, st.m0)
    ev[1].record()
    sync(st.device)
    return ev[0].elapsed_time(ev[1]) / PROBLEM_REPS


def shapes(st: State) -> counts.Shapes:
    """What a global BA of this map works on (`counts.Shapes`)."""
    pb = reference.problem(st.arr, st.data, reference.Arith("float32"))
    n = torch.bincount(pb.e_pt, minlength=pb.X.shape[0])
    return counts.Shapes(edges=int(pb.e_pt.numel()), points=int((n > 0).sum()),
                         free_cams=int(pb.cam_free.sum()), cam_slots=pb.R.shape[0],
                         point_slots=pb.X.shape[0], edge_pairs=int((n * (n + 1) // 2).sum()))


def trace_context(st: State, values: dict, trace_s: float) -> dict:
    """What the per-layer readers read (`slambench/metrics/*.py`), from a
    traced window of at least trace_s and the run's end-to-end values."""
    tr, n = traced(st, trace_s, 2, host=False)
    named, _ = traced(st, 0.0, 1, host=True)
    s = shapes(st)
    g = st.data["global_ba"]
    return dict(gba_s=values["gba_s"], trace=tr, n_traced=n, gaps=named.gaps,
                problem_ms=problem_ms(st), shapes=s,
                needed=counts.global_ba(s, g["solver"], st.chunks, st.iters,
                                        int(g.get("cg_iters", 0))),
                k9_bytes=counts.ba_assemble_bytes(s.point_slots * st.scfg.ba_max_obs,
                                                  s.point_slots, s.cam_slots),
                k9_name=K9_NAME)


def solved_reference(st: State):
    """The float64 reference's problem and its global BA's answer judged
    (`reference.evaluate`), computed once."""
    if st.ref is None:
        pb = reference.problem(st.arr, st.data, reference.Arith("float64"))
        st.ref = pb, reference.evaluate(pb, *reference.global_ba(pb, reference.Arith("float64")))
    return st.ref


def answer_gaps(st: State, answer) -> dict:
    """The numbers of one answer (kf_pose (K,4,4), pt_pos (P,3)) against the
    float64 reference."""
    pb, ref = solved_reference(st)
    got = reference.evaluate(pb, answer[0][:, :3, :3], answer[0][:, :3, 3], answer[1])
    return reference.nan_to_inf(reference.gaps(pb, got, ref))


# kernel names that tell of arithmetic below float32: TF32, half, bfloat16
# and 8-bit types, and the tensor-core tile names of TF32 (s1688, s16816)
# and half (h1688, h16816) gemms
LOW_PRECISION = re.compile(r"tf32|bf16|bfloat16|f16|half|fp8|e4m3|e5m2|s1688|s16816|h1688|h16816",
                           re.IGNORECASE)


def device_kernels(st: State) -> set:
    """The names of the device activities of one global BA from m0, from the
    profiler (none on the CPU)."""
    if st.device.type != "cuda":
        return set()
    sync(st.device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once(st)
        sync(st.device)
    return set(tracing.read(prof, (), time.perf_counter() - t0).by_name)


def precision_checks(names) -> dict:
    """The configuration's stated precision, as far as a run can show it:
    float32 matrix products with TF32 off (`tf32_matmul` 1 where torch was
    left to use TF32), and no device kernel of a global BA named for lower
    precision (`low_precision_kernels`, of `names`). Lower precision in the
    solver's linear solve moves the answer too little for the reference's
    numbers to see (PERF.md, section 2)."""
    return {"tf32_matmul": int(torch.get_float32_matmul_precision() != "highest"),
            "low_precision_kernels": sum(1 for n in names if LOW_PRECISION.search(n))}


def judge(st: State, n_answers: int, limits: dict):
    """Judge the window's answers against the reference once the window has
    closed: frees the program's map, runs the reference in float64 on the
    harness's arrays, and takes each number's worst over the distinct
    answers; the run's precision is judged with them (`precision_checks`,
    on the kernels of one more global BA, profiled). Returns (checks
    {name: {value, limit}}, failed answers, distinct answers, reference
    seconds)."""
    n_kept = min(n_answers, st.out_poses.shape[0])
    poses, points = st.out_poses[:n_kept], st.out_points[:n_kept]
    distinct, owner = [], []
    for i in range(n_kept):
        for j, d in enumerate(distinct):
            if torch.equal(poses[i], poses[d]) and torch.equal(points[i], points[d]):
                owner.append(j)
                break
        else:
            distinct.append(i)
            owner.append(len(distinct) - 1)
    # answers past the buffer share the last slot's judgement
    owner += [owner[-1]] * (n_answers - n_kept)
    names = device_kernels(st)
    low = sorted(n for n in names if LOW_PRECISION.search(n))
    if low:
        print(f"slambench: kernels below float32: {', '.join(n[:120] for n in low)}",
              file=sys.stderr)
    st.m0 = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    solved_reference(st)
    ref_s = time.perf_counter() - t0
    run = precision_checks(names)
    per = [dict(answer_gaps(st, (poses[i], points[i])), **run) for i in distinct]
    bad = [any(not p[k] <= lim for k, lim in limits.items()) for p in per]
    checks = {k: {"value": max(p[k] for p in per), "limit": lim} for k, lim in limits.items()}
    return checks, sum(bad[o] for o in owner), len(distinct), ref_s


def end_to_end(window_s: float, n: int) -> dict:
    """The end-to-end metrics of a window of n global BAs."""
    return {"gba_s": window_s / n}
