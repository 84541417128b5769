#!/usr/bin/env python3
"""The JAX reference's numbers for `chip_smoke.py` (the PyTorch/CUDA port's
smoke run), measured on the CPU with the reference package's XLA path.

    env JAX_PLATFORMS=cpu python scripts/chip_smoke_reference.py \
        [--system-only | --loop-only | --split-only | --stereo-only | --mono-only |
         --stream-only | --files-only]

It renders chip_smoke's frames (the reference bench's first N_FRAMES poses,
640x480, 1000 features, RGB-D), extracts them with the port's front end (as
the port's tests do, so both packages see the same keypoints), runs the
reference's RGB-D initialization, tracking step and `keyframe_pass` with
chip_smoke's keyframe rule and state chaining, and prints the values
chip_smoke holds the port to: valid keypoints, local-map inliers and
camera-centre error per tracked frame, and per keyframe event the points
triangulated, points replaced by fusion, BA outlier observations erased,
keyframes culled, and the valid points and keyframes after the event.

The per-event counts come from `jax_mapping_stages`, which runs the body of
the reference's `mapping_ops.mapping_pass` stage by stage on the same
snapshot (the jitted pass returns none of them); the script asserts that
every field of its map equals `keyframe_pass`'s before it records the
numbers. The port's parity test
(`tests/test_torch_keyframe_pass.py`) uses the same stages.

Then the `[system]` phase's numbers: the reference `SlamSystem` (loop
closing off, `synth_vocabulary(10, 6)`, the natural keyframe policy) over
the same frames, handed the port's frames through its frame-given tracking
path (the stream's step patched to take the frame as its images, as
`tests/test_torch_system.py` does): the state after every call, the
keyframe frames and the ATE of a synchronous lap; a kidnap (state LOST, the
render of pose KIDNAP_POSE) and its camera-centre error; a fresh system
with pipeline_depth=3 and its flush, with the same records.

`--loop-only` gives the `[loop]` phase's numbers (`REFERENCE_LOOP`): the
reference `SlamSystem` with its defaults (loop closing on, 4 amortized GBA
chunks, the natural keyframe policy, `synth_vocabulary(10, 6)`) over
chip_smoke's figure eight (`render_loop_frames`, EVAL.md's fig8-rgbd row,
560 frames) handed the port's frames, then `flush()`: the loops closed and,
for each closure, its keyframe sequence number, the frames of its keyframe
and candidate and of the candidate's covisible keyframes; the frames
tracked, the keyframes inserted and the ATE.

`--split-only` gives the `[multi]` phase's (`REFERENCE_SPLIT`): the same
lap at pipeline depth STREAM_DEPTH, once as the stream and once as the
tracking / mapping split (`mapping_device`, the second of two virtual CPU
devices), with the keyframe frames and the states besides.

`--stereo-only` gives the `[stereo]` phase's numbers (`REFERENCE_STEREO`):
the same lap over chip_smoke's street canyon (`render_block_frames`,
EVAL.md's block-stereo row, 780 stereo pairs) handed the port's stereo
frames (its extraction and SAD matcher on the CPU), with the state after
every frame and the keyframe frames besides. `--mono-only` gives the
`[mono]` phase's (`REFERENCE_MONO`): three laps over chip_smoke's
monocular figure eight (`render_mono_frames`, EVAL.md's fig8-mono row),
the initializer's RANSAC sets drawn from PRNGKey(frame_id + k) for k = 0,
1, 2 (monocular initialization varies with its draws), each with its
initialization frame and its Sim3-aligned ATE.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

# the tracking / mapping split (--split-only) needs a second device
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from orb_slam2_tpu.mapstate import map as jmap
from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import mapping_ops as jmo
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.geometry import se3 as jse3
from orb_slam2_tpu.utils import config as jconfig

_fuse_decide = jax.jit(jmo._fuse_decide, static_argnums=0)
# float fields of the stage recomposition against the jitted keyframe_pass's:
# XLA fuses the two differently, and pt_min_dist comes out one float32 ulp
# apart (1.2e-7 relative) on ~1 % of the points; every other field is equal
STAGE_TOL = 1e-6
MONO_KEYS = 3       # monocular reference runs, RANSAC keys PRNGKey(frame_id + k), k < 3


def jax_mapping_stages(cfg, m, kf_id):
    """The reference's mapping_pass body, stage by stage (jitted pieces).
    Returns a dict: the map after each stage ('culled_pts', 'tri', 'fused',
    'stats', 'ba', 'out'), the inputs the port's stage functions need
    ('covis_ids', 'tgt_ids', 'obs') and the event's counts ('n_new',
    'n_replaced', 'n_outliers', 'n_culled', 'culled')."""
    st = {}
    K, P, N = m.capacity_kf, m.capacity_pt, m.n_feat
    m = jmo.cull_map_points(cfg, m, cur_kf=kf_id)
    st["culled_pts"] = m
    nn = 20 if cfg.sensor == jconfig.SENSOR_MONOCULAR else 10
    ids, _ = jmap.covisible_keyframes(m, kf_id, nn)
    st["covis_ids"] = ids
    m, n_new = jmo.triangulate_batch(cfg, m, kf_id, ids)
    st["tri"], st["n_new"] = m, int(n_new)

    tgt_ids, _ = jmo._fusion_targets(m, kf_id, nn, cap=3 * nn)
    st["tgt_ids"] = tgt_ids
    cur_pts = m.kf_obs[kf_id]
    cnt = m.pt_obs_cnt
    kf_obs = m.kf_obs
    mapping = jnp.arange(P, dtype=jnp.int32)
    st["rounds"] = []
    for nb in np.asarray(tgt_ids):
        if nb < 0:
            continue
        nbs = jnp.asarray(nb, jnp.int32)
        dec = _fuse_decide(cfg, m._replace(kf_obs=kf_obs), cnt, nbs, cur_pts, cur_pts >= 0)
        st["rounds"].append((int(nb), kf_obs, dec))
        idx, bind, src, tgt, both, src_wins = dec
        mapping = jmo._fuse_mapping_update(mapping, src, tgt, both, src_wins, P)
        row = kf_obs[nbs].at[jnp.where(bind, idx, N)].set(src, mode="drop")
        kf_obs = kf_obs.at[nbs].set(row)
    m = m._replace(kf_obs=kf_obs)
    rows = m.kf_obs[jnp.clip(tgt_ids, 0, K - 1)]
    rows = jnp.where((tgt_ids >= 0)[:, None], rows, -1).reshape(-1)
    present = jnp.zeros((P,), bool).at[jnp.where(rows >= 0, rows, P)].set(True, mode="drop")
    fuse_pts, fuse_ok = jmap.compact_mask(present, cfg.max_local_points)
    dec = _fuse_decide(cfg, m, cnt, kf_id, fuse_pts, fuse_ok)
    st["union"] = (fuse_pts, fuse_ok, m, dec)
    idx, bind, src, tgt, both, src_wins = dec
    mapping = jmo._fuse_mapping_update(mapping, src, tgt, both, src_wins, P)
    m = jmap.bind_observations(m, kf_id, idx, src, bind)
    mapping = mapping[mapping]
    mapping = mapping[mapping]
    st["mapping"] = mapping
    st["n_replaced"] = int(jnp.sum((mapping != jnp.arange(P)) & m.pt_valid))
    st["pre_replace"] = m
    m = jmap.replace_points_fast(m, mapping)
    touched = jnp.concatenate([jnp.clip(tgt_ids, 0, K - 1), jnp.asarray(kf_id, jnp.int32)[None]])
    rows = m.kf_obs[touched]
    rows = jnp.where(rows >= 0, mapping[jnp.clip(rows, 0, P - 1)], -1)
    rows = jnp.where(m.pt_valid[jnp.clip(rows, 0, P - 1)] & (rows >= 0), rows, -1)
    m = m._replace(kf_obs=m.kf_obs.at[touched].set(rows))
    st["fused"] = m

    bound = m.kf_obs[kf_id]
    pmask = jnp.zeros((P,), bool).at[jnp.where(bound >= 0, bound, P)].set(True, mode="drop")
    obs = jmap.point_observations(m, 16)
    m = jmap.refresh_obs_table(m, obs=obs)
    m = jmap.update_point_descriptors(m, pmask, obs=obs)
    m = jmap.update_point_normals(m, pmask, cfg.scale_factors, obs=obs)
    m = jmap.update_connections(m, kf_id, use_table=True)
    st["stats"], st["obs"] = m, obs
    st["n_outliers"], st["n_culled"] = 0, 0
    st["culled"] = np.zeros((K,), bool)
    if int(m.n_keyframes) > 2:
        m_ba = jmo.local_ba(cfg, m, kf_id, n_local=cfg.ba_local_cams,
                            n_fixed=cfg.ba_fixed_cams, max_pts=cfg.ba_max_points,
                            max_obs=cfg.ba_max_obs, obs=obs)
        st["n_outliers"] = int(jnp.sum((m.kf_obs >= 0) & (m_ba.kf_obs < 0)))
        st["ba"] = m_ba
        m, culled = jmo.cull_keyframes(cfg, m_ba, kf_id, obs=obs)
        if bool(jnp.any(culled)):
            m = jmap.refresh_obs_table(m)
        st["culled"], st["n_culled"] = np.asarray(culled), int(jnp.sum(culled))
    st["out"] = m
    return st


def jax_frame(f):
    """A reference FrameData from the port's (descriptors as uint32)."""
    from orb_slam2_tpu_torch.utils import convert
    return jframe.FrameData(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(f).items()})


def jax_last(cfg, m, f, Tcw, matched):
    """The next frame's inputs after a keyframe (SlamSystem._set_last)."""
    P = m.capacity_pt
    pos = m.pt_pos[jnp.clip(matched, 0, P - 1)]
    has = (matched >= 0) & m.pt_valid[jnp.clip(matched, 0, P - 1)]
    z = jnp.maximum(f.depth, 1e-6)
    pc = jnp.stack([(f.xy[:, 0] - cfg.cx) / cfg.fx * z, (f.xy[:, 1] - cfg.cy) / cfg.fy * z, z],
                   -1)
    pw = jse3.apply(jse3.inverse(Tcw), pc)
    temporal = (f.depth > 0) & (f.depth < cfg.th_depth * cfg.baseline) & ~has & f.valid
    return jnp.where(temporal[:, None], pw, pos), has | temporal


def copy_map(m):
    """keyframe_pass donates its map: hand it a copy."""
    return jax.tree.map(jnp.copy, m)


def assert_same_map(got, want, what):
    """Every MapState field of got equals want's: integer and bool fields
    exactly, float fields within STAGE_TOL (relative and absolute)."""
    for name in jmap.MapState._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=STAGE_TOL, atol=STAGE_TOL,
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


def event_numbers(st, m_after):
    """One keyframe event's record: the stage counts and the map after."""
    return [st["n_new"], st["n_replaced"], st["n_outliers"], st["n_culled"],
            int(m_after.n_points), int(m_after.n_keyframes)]


def system_laps(jcfg, poses, jf):
    """The reference SlamSystem's records for chip_smoke's [system] phase."""
    import torch
    import chip_smoke as cs
    from orb_slam2_tpu.bow import vocabulary as jvoc
    from orb_slam2_tpu.pipeline import system as jsystem
    from orb_slam2_tpu.utils import trajectory as jtraj

    voc = jvoc.synth_vocabulary(10, 6)
    jts.full_tracking_step_from_images = \
        lambda cfg, m, f, *rest: jts.full_tracking_step(cfg, m, f, *rest[:-1])

    def track(s, f, ts):
        if s.state == jsystem.OK and s.pipeline_depth > 0:
            return s._track_stream(f, ts, "rgbd")
        if s.state != jsystem.OK:
            s._flush_pipeline()
        return s._track(f, ts)

    gt = [(i / jcfg.fps, T) for i, T in enumerate(poses)]
    out = {}
    for name, depth in (("sync", 0), ("stream", 3)):
        s = jsystem.SlamSystem(jcfg, vocabulary=voc, enable_loop_closing=False,
                               pipeline_depth=depth)
        states = []
        for i, f in enumerate(jf):
            track(s, f, i / jcfg.fps)
            states.append(int(s.state))
        s.flush()
        out[f"{name}_states"] = states
        out[f"{name}_kf_frames"] = sorted(e["frame"] for e in s.metrics if e.get("kf"))
        out[f"{name}_ate_m"] = round(jtraj.ate_rmse(s.get_trajectory(), gt), 6)
        print(f"{name}: {len(s.get_trajectory())} frames tracked, keyframes at "
              f"{out[f'{name}_kf_frames']}, ATE {out[f'{name}_ate_m']} m", flush=True)
        if name == "sync":
            s.state = jsystem.LOST
            T = track(s, jf[cs.KIDNAP_POSE], 99.0)
            assert T is not None, "the reference did not relocalize"
            out["kidnap_kf"] = int(s.ref_kf)
            out["kidnap_err_m"] = round(cs._centre_error(torch.from_numpy(np.array(T)), poses[0],
                                                         poses[cs.KIDNAP_POSE]), 6)
    return out


def sensor_lap(jcfg, poses, frame_at, key_offset=0, depth=0, mapping_device=None,
               vocabulary="synth", timestamps=None):
    """The reference SlamSystem with its defaults (loop closing on, 4
    amortized GBA chunks, the natural keyframe policy,
    `synth_vocabulary(10, 6)`) over the sequence, handed the port's frames
    (`frame_at(i, init)`: frame i, extracted with the doubled initialization
    budget where init, as a monocular system extracts before it
    initializes), then `flush()`. A monocular run draws its initializer's
    RANSAC sets from PRNGKey(frame_id + key_offset). With depth > 0 the
    system streams at that depth (with `mapping_device`, the tracking /
    mapping split). vocabulary "synth" is `synth_vocabulary(10, 6)`, None
    the tree trained on the fly (as the example scripts construct the system);
    timestamps default to i / fps. Returns the records chip_smoke holds a
    phase to."""
    from orb_slam2_tpu.bow import vocabulary as jvoc
    from orb_slam2_tpu.pipeline import loop_closing as jlc
    from orb_slam2_tpu.pipeline import system as jsystem
    from orb_slam2_tpu.solvers import initializer as jinit
    from orb_slam2_tpu.utils import trajectory as jtraj

    voc = jvoc.synth_vocabulary(10, 6) if vocabulary == "synth" else vocabulary
    if timestamps is None:
        timestamps = [i / jcfg.fps for i in range(len(poses))]
    jts.full_tracking_step_from_images = \
        lambda cfg, m, f, *rest: jts.full_tracking_step(cfg, m, f, *rest[:-1])
    s = jsystem.SlamSystem(jcfg, vocabulary=voc, pipeline_depth=depth,
                           mapping_device=mapping_device)
    mono = jcfg.sensor == jconfig.SENSOR_MONOCULAR
    closures, detections = [], []
    correct_loop, dispatch, initialize = jlc.correct_loop, jlc.detect_loop_dispatch, \
        jinit.initialize

    def record_correct(cfg, m, kf_id, cand_id, Scm, **kw):
        fid = np.asarray(m.kf_frame_id)
        nb = np.nonzero((np.asarray(m.covis[cand_id]) > 0) & np.asarray(m.kf_valid))[0]
        closures.append(dict(kf_seq=s._kf_seq_host, kf_frame=int(fid[kf_id]),
                             cand_frame=int(fid[cand_id]),
                             cand_neighbour_frames=sorted(int(fid[k]) for k in nb)))
        print(f"closure {closures[-1]}", flush=True)
        return correct_loop(cfg, m, kf_id, cand_id, Scm, **kw)

    def record_dispatch(cfg, m, db, vec, kf_id, state):
        cands = dispatch(cfg, m, db, vec, kf_id, state)
        fid = np.asarray(m.kf_frame_id)
        detections.append((s._kf_seq_host, [int(fid[c]) for c in np.asarray(cands) if c >= 0]))
        return cands

    def keyed_initialize(*args, key=None, **kw):
        return initialize(*args, key=jax.random.PRNGKey(s.frame_id + key_offset), **kw)

    jlc.correct_loop, jlc.detect_loop_dispatch = record_correct, record_dispatch
    jinit.initialize = keyed_initialize
    states, init_frame = [], None
    t0 = time.perf_counter()
    try:
        for i in range(len(poses)):
            f = frame_at(i, mono and s.state == jsystem.NOT_INITIALIZED)
            if s.state == jsystem.OK and depth > 0:
                s._track_stream(f, timestamps[i], "rgbd")
            else:
                s._flush_pipeline()
                s._track(f, timestamps[i])
            states.append(int(s.state))
            if init_frame is None and s.state == jsystem.OK:
                init_frame = i
            if i % 50 == 0:
                print(f"frame {i}: {s.get_map_stats()} ({time.perf_counter() - t0:.0f} s)",
                      flush=True)
        s.flush()
    finally:
        jlc.correct_loop, jlc.detect_loop_dispatch = correct_loop, dispatch
        jinit.initialize = initialize
    gt = list(zip(timestamps, poses))
    traj = s.get_trajectory()
    print(f"detections (kf_seq, candidate frames): {[d for d in detections if d[1]]}")
    fid = np.asarray(s.m.kf_frame_id)
    return dict(loops=s.n_loops_closed, closures=closures, tracked=len(traj),
                keyframes_inserted=s._kf_seq_host, keyframes=int(s.m.n_keyframes),
                points=int(s.m.n_points), init_frame=init_frame,
                kf_frames=sorted(e["frame"] for e in s.metrics if e.get("kf")),
                states=states,
                loop_edge_frames=[[int(fid[i]), int(fid[j])]
                                  for i, j in np.asarray(s.m.loop_edges) if i >= 0],
                ate_m=round(jtraj.ate_rmse(traj, gt, with_scale=mono), 6))


def files_laps():
    """The reference SlamSystem on chip_smoke's [files] sequences
    (`write_file_sequences`), decoded by the port's datasets and extracted
    by the port on the CPU: with its defaults and the vocabulary trained on
    the fly, as the example scripts construct it, and the config its `from_yaml`
    reads from each lap's settings, except depth_map_factor, set in code to
    1/DepthMapFactor (the JAX `from_yaml` keeps the factor as read). The
    state after every frame, the keyframe frames and the ATE of tum-rgbd,
    tum-rgbd-distorted and kitti-stereo."""
    import tempfile
    import torch
    import chip_smoke as cs
    from orb_slam2_tpu_torch.pipeline import frame as tframe
    from orb_slam2_tpu_torch.utils import convert
    from orb_slam2_tpu_torch.utils.config import SlamConfig as TConfig

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        laps = cs.write_file_sequences(tmp)
        for name in ("tum-rgbd", "tum-rgbd-distorted", "kitti-stereo"):
            lap = laps[name]
            tcfg = TConfig.from_yaml(lap["settings"], sensor=lap["sensor"])
            jcfg = dataclasses.replace(
                jconfig.SlamConfig.from_yaml(lap["settings"], sensor=lap["sensor"]),
                use_pallas=0, depth_map_factor=tcfg.depth_map_factor)
            assert convert.config_from_jax(jcfg) == tcfg
            frames, decoder = cs.decoded_sequence(lap)
            t = torch.from_numpy
            if lap["sensor"] == jconfig.SENSOR_STEREO:
                jf = [jax_frame(tframe.make_frame_stereo(t(l), t(r), tcfg)) for _, l, r in frames]
            else:
                jf = [jax_frame(tframe.make_frame_rgbd(t(g), t(d), tcfg)) for _, g, d in frames]
            r = sensor_lap(jcfg, [T for _, T in lap["gt"]], lambda i, init: jf[i],
                           vocabulary=None, timestamps=[ts for ts, _ in lap["gt"]])
            out[name] = {k: r[k] for k in ("states", "kf_frames", "tracked", "keyframes",
                                           "loops", "ate_m")}
            print(f"{name} ({len(frames)} frames, decoder {decoder}): {out[name]}", flush=True)
    return out


def loop_lap(jcfg, poses, jf):
    """The reference SlamSystem's records for chip_smoke's [loop] phase."""
    return sensor_lap(jcfg, poses, lambda i, init: jf[i])


def main():
    import torch
    import chip_smoke as cs
    from orb_slam2_tpu_torch.pipeline import frame as tframe
    from orb_slam2_tpu_torch.utils import convert

    t0 = time.perf_counter()
    tcfg = cs.bench_config()
    jcfg = jconfig.SlamConfig(use_pallas=0, **{
        k: getattr(tcfg, k) for k in ("fx", "fy", "cx", "cy", "width", "height", "bf", "sensor",
                                      "fps", "th_depth", "n_features", "max_keyframes",
                                      "max_map_points")})
    assert convert.config_from_jax(jcfg) == tcfg
    if "--stereo-only" in sys.argv:
        tcfg = cs.block_config()
        jcfg = dataclasses.replace(jcfg, sensor=tcfg.sensor, bf=tcfg.bf)
        assert convert.config_from_jax(jcfg) == tcfg
        poses, pairs = cs.render_block_frames(cs.BLOCK_LAP)
        jf = (jax_frame(tframe.make_frame_stereo(torch.from_numpy(l), torch.from_numpy(r), tcfg))
              for l, r in pairs)
        print(f"REFERENCE_STEREO = {sensor_lap(jcfg, poses, lambda i, init: next(jf))}")
        print(f"jax {jax.__version__}, {time.perf_counter() - t0:.0f} s")
        return
    if "--files-only" in sys.argv:
        print(f"REFERENCE_FILES = {files_laps()}")
        print(f"jax {jax.__version__}, {time.perf_counter() - t0:.0f} s")
        return
    if "--stream-only" in sys.argv:
        laps = {}
        tcfg_s = cs.block_config()
        jcfg_s = dataclasses.replace(jcfg, sensor=tcfg_s.sensor, bf=tcfg_s.bf)
        assert convert.config_from_jax(jcfg_s) == tcfg_s
        poses, pairs = cs.render_block_frames(cs.STREAM_LAP)
        jf = (jax_frame(tframe.make_frame_stereo(torch.from_numpy(l), torch.from_numpy(r),
                                                 tcfg_s))
              for l, r in pairs)
        laps["stereo"] = sensor_lap(jcfg_s, poses, lambda i, init: next(jf),
                                    depth=cs.STREAM_DEPTH)
        print(f"stereo stream: {laps['stereo']} ({time.perf_counter() - t0:.0f} s)", flush=True)
        tcfg_m = cs.mono_config()
        jcfg_m = dataclasses.replace(jcfg, sensor=tcfg_m.sensor, bf=tcfg_m.bf)
        poses, frames = cs.render_mono_frames(cs.render_loop_clean(cs.STREAM_LAP))
        cache = {}

        def mono_at(i, init):
            if (i, init) not in cache:
                cache[(i, init)] = jax_frame(tframe.make_frame_monocular(
                    torch.from_numpy(frames[i]), tcfg_m, init=init))
            return cache[(i, init)]
        laps["mono"] = [sensor_lap(jcfg_m, poses, mono_at, key_offset=k, depth=cs.STREAM_DEPTH)
                        for k in range(MONO_KEYS)]
        for lap in [laps["stereo"], *laps["mono"]]:
            lap.pop("loop_edge_frames", None)
            lap.pop("points", None)
        print(f"REFERENCE_STREAMS = {laps}")
        print(f"jax {jax.__version__}, {time.perf_counter() - t0:.0f} s")
        return
    if "--mono-only" in sys.argv:
        tcfg = cs.mono_config()
        jcfg = dataclasses.replace(jcfg, sensor=tcfg.sensor, bf=tcfg.bf)
        assert convert.config_from_jax(jcfg) == tcfg
        poses, frames = cs.render_mono_frames()
        cache = {}

        def frame_at(i, init):
            if (i, init) not in cache:
                cache[(i, init)] = jax_frame(tframe.make_frame_monocular(
                    torch.from_numpy(frames[i]), tcfg, init=init))
            return cache[(i, init)]
        runs = [sensor_lap(jcfg, poses, frame_at, key_offset=k) for k in range(MONO_KEYS)]
        print(f"REFERENCE_MONO = {runs}")
        print(f"jax {jax.__version__}, {time.perf_counter() - t0:.0f} s")
        return
    if "--loop-only" in sys.argv or "--split-only" in sys.argv:
        poses, frames = cs.render_loop_frames()
        jf = [jax_frame(tframe.make_frame_rgbd(torch.from_numpy(g), torch.from_numpy(d), tcfg))
              for g, d in frames]
        print(f"extracted {len(jf)} frames ({time.perf_counter() - t0:.0f} s)", flush=True)
        if "--split-only" in sys.argv:
            laps = {name: sensor_lap(jcfg, poses, lambda i, init: jf[i], depth=cs.STREAM_DEPTH,
                                     mapping_device=md)
                    for name, md in (("stream", None), ("split", jax.devices()[1]))}
            print(f"REFERENCE_SPLIT = {laps}")
            print(f"jax {jax.__version__}, {time.perf_counter() - t0:.0f} s")
            return
        print(f"REFERENCE_LOOP = {loop_lap(jcfg, poses, jf)}")
        print(f"jax {jax.__version__}, {time.perf_counter() - t0:.0f} s")
        return
    poses, frames = cs.render_frames()
    tf = [tframe.make_frame_rgbd(torch.from_numpy(g), torch.from_numpy(d), tcfg)
          for g, d in frames]
    jf = [jax_frame(f) for f in tf]
    if "--system-only" in sys.argv:
        print(f"REFERENCE_SYSTEM = {system_laps(jcfg, poses, jf)}")
        print(f"jax {jax.__version__}, {time.perf_counter() - t0:.0f} s")
        return
    N = jcfg.max_keypoints
    eye = jnp.eye(4, dtype=jnp.float32)
    m = jmap.empty(jcfg.max_keyframes, jcfg.max_map_points, N)
    m, kf = jmo.insert_keyframe(jcfg, m, jf[0], eye, jnp.full((N,), -1, jnp.int32), 0, 0.0,
                                all_depth=True)
    lm = m.kf_obs[kf]
    lp, lpv = jax_last(jcfg, m, jf[0], eye, lm)
    last, T_last, vel, has_vel, ref = jf[0], eye, eye, False, kf
    valid = [int(f.valid.sum()) for f in tf[:cs.N_FRONT]]
    inliers, errs, events = [], [], []
    for i in range(1, len(jf)):
        r = jts.full_tracking_step(jcfg, copy_map(m), jf[i], last, lp, lpv, lm, T_last, vel,
                                   jnp.asarray(has_vel), ref, 30)
        m = r.m
        inliers.append(int(r.scalars[3]))
        errs.append(cs._centre_error(torch.from_numpy(np.array(r.Tcw)), poses[0], poses[i]))
        assert int(r.scalars[0]) == 1, f"frame {i} lost"
        if i % cs.KF_EVERY == 0:
            m_pre, kf_new = jmo.insert_keyframe(jcfg, copy_map(m), jf[i], r.Tcw, r.matched_pt, i,
                                                i / jcfg.fps, update_stats=False,
                                                table_fresh=True)
            st = jax_mapping_stages(jcfg, m_pre, kf_new)
            m, culled, summary = jmo.keyframe_pass(jcfg, copy_map(m), jf[i], r.Tcw,
                                                   r.matched_pt, i, i / jcfg.fps)
            assert_same_map(st["out"], m, f"event at frame {i}, stages vs keyframe_pass")
            np.testing.assert_array_equal(st["culled"], np.asarray(culled))
            events.append(event_numbers(st, m))
            print(f"event at frame {i}: {events[-1]} (the stage recomposition's map equals "
                  f"keyframe_pass's)", flush=True)
            kf = summary[0]
            lm = m.kf_obs[kf]
            lp, lpv = jax_last(jcfg, m, jf[i], r.Tcw, lm)
            ref = kf
        else:
            lm, lp, lpv, ref = r.matched_pt, r.next_pts, r.next_pts_valid, r.ref_kf
        last, T_last, vel, has_vel = jf[i], r.Tcw, r.next_vel, True
    print(f"jax {jax.__version__}, {time.perf_counter() - t0:.0f} s")
    print(f"REFERENCE_VALID = {valid}")
    print(f"REFERENCE_LOCAL_INLIERS = {inliers}")
    print(f"REFERENCE_TRANS_ERR_M = {[round(e, 5) for e in errs]}")
    print(f"REFERENCE_EVENTS = {events}")
    t1 = time.perf_counter()
    print(f"REFERENCE_SYSTEM = {system_laps(jcfg, poses, jf)}")
    print(f"the [system] laps: {time.perf_counter() - t1:.0f} s")


if __name__ == "__main__":
    main()
