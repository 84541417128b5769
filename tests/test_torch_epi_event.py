"""K8 as the keyframe event's whole epipolar search
(`orb_slam2_tpu_torch/ops/cuda_match.epi_match_keyframes`, called by
`pipeline/mapping_ops._epi_match_batch`) on the CPU: its twin against the
JAX reference's XLA gate path on a JAX map snapshot, and a numpy model of
the kernel's order (`csrc/epi_match.cu`) against the twin.

- The snapshot is built as `test_torch_keyframe_pass.py` builds its event,
  at 240x320 RGB-D, 300 features: the reference's initialization, tracking
  on frames 1-4, `keyframe_pass` on frame 2, the keyframe of frame 4
  inserted with every 3rd feature freed (so triangulation has work) and
  the recent points culled. The reference's XLA path
  (`mapping_ops._triangulate_decide` with no precomputed match, batched over
  the covisible neighbours as `triangulate_batch` runs it when the Pallas
  kernels are off) gives each neighbour's best distance and column; the
  port's `_epi_match_batch` must give the same, bit for bit.
- The model repeats the kernel's decisions: CTAs of kRows kf1 features, the
  unbound ones compacted in order; the neighbour's unbound far features
  compacted in column order, in chunks of kCols; per row the least key
  dist * N + col over the gated compacted columns, carried across chunks.
  On `chip_smoke._synthetic_epi`'s sets (ties between two equal targets,
  a neighbour with no candidate column, NaN lines, a clamped den) at the
  kernel's chunk sizes and at small ones that split ties across chunks.
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.mapstate import map as jmap
from orb_slam2_tpu.pipeline import mapping_ops as jmo
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig

from orb_slam2_tpu_torch.ops import cuda_match as cm
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.pipeline import mapping_ops as tmo
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import synthetic as tsyn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, ROOT)
import chip_smoke_reference as ref  # noqa: E402
from chip_smoke import _synthetic_epi  # noqa: E402

torch.set_num_threads(1)
H, W, FX = 240, 320, 260.0
BIG, INT_MAX = cm.BIG, 2 ** 31 - 1


@pytest.fixture(scope="module")
def snapshot():
    kw = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H, bf=0.25 * FX,
              sensor=jconfig.SENSOR_RGBD, fps=30.0, th_depth=40.0, n_features=300,
              max_keyframes=16, max_map_points=4096, max_local_points=1024, ba_local_cams=4,
              ba_fixed_cams=4, ba_max_points=1024, ba_max_obs=8)
    jcfg = jconfig.SlamConfig(use_pallas=0, **kw)
    tcfg = convert.config_from_jax(jcfg)
    world = tsyn.PlateWorld(FX, FX, W / 2, H / 2, W, H, z0=5.0)
    jf = []
    for T in tsyn.loop_trajectory(181, radius=3.0, overshoot=0.5, spiral=0.12)[:5]:
        gray, depth = world.render_with_depth(T)
        gray = np.clip(np.round(gray), 0, 255).astype(np.uint8)
        jf.append(ref.jax_frame(tframe.make_frame_rgbd(torch.from_numpy(gray),
                                                       torch.from_numpy(depth), tcfg)))
    N = jcfg.max_keypoints
    eye = jnp.eye(4, dtype=jnp.float32)
    m, kf = jmo.insert_keyframe(jcfg, jmap.empty(jcfg.max_keyframes, jcfg.max_map_points, N),
                                jf[0], eye, jnp.full((N,), -1, jnp.int32), 0, 0.0,
                                all_depth=True)
    lm = m.kf_obs[kf]
    lp, lpv = ref.jax_last(jcfg, m, jf[0], eye, lm)
    last, T_last, vel, has_vel, rkf = jf[0], eye, eye, False, kf
    for i in range(1, 5):
        r = jts.full_tracking_step(jcfg, ref.copy_map(m), jf[i], last, lp, lpv, lm, T_last,
                                   vel, jnp.asarray(has_vel), rkf, 30)
        assert int(r.scalars[0]) == 1
        m = r.m
        if i == 2:
            m, _, summary = jmo.keyframe_pass(jcfg, ref.copy_map(m), jf[i], r.Tcw,
                                              r.matched_pt, i, i / 30)
            lm = m.kf_obs[summary[0]]
            lp, lpv = ref.jax_last(jcfg, m, jf[i], r.Tcw, lm)
            rkf = summary[0]
        else:
            lm, lp, lpv, rkf = r.matched_pt, r.next_pts, r.next_pts_valid, r.ref_kf
        last, T_last, vel, has_vel = jf[i], r.Tcw, r.next_vel, True
    m, kf = jmo.insert_keyframe(jcfg, ref.copy_map(m), jf[4], r.Tcw, r.matched_pt, 4, 4 / 30,
                                update_stats=False, table_fresh=True)
    m = m._replace(kf_obs=m.kf_obs.at[kf].set(jnp.where(jnp.arange(N) % 3 == 0, -1,
                                                        m.kf_obs[kf])))
    m = jmo.cull_map_points(jcfg, m, cur_kf=kf)
    ids, _ = jmap.covisible_keyframes(m, kf, 10)
    return jcfg, tcfg, m, kf, ids


def test_epi_unit_twin_equals_xla_gate_path(snapshot):
    jcfg, tcfg, m, kf, ids = snapshot
    assert int((np.asarray(ids) >= 0).sum()) >= 2              # covisible neighbours

    @jax.jit
    def xla(m, kf, ids):
        decide = lambda nb: jmo._triangulate_decide(jcfg, m, kf, jnp.maximum(nb, 0), 256)
        _, _, i2, best, _ = jax.vmap(decide)(ids)
        return best, i2

    want = xla(m, kf, ids)
    got = tmo._epi_match_batch(tcfg, convert.mapstate_from_numpy(m, device="cpu"),
                               torch.tensor(int(kf)), torch.from_numpy(np.array(ids)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[0] <= 50).sum()) > 20                      # matches the event uses


def epi_model(rows, k_rows, k_cols):
    """The kernel's decisions on the rows `cm.epi_rows` gathers: per
    neighbour, CTAs of k_rows kf1 features (the unbound compacted in order),
    the unbound far columns compacted in column order in chunks of k_cols,
    each row's least key over the gated columns carried across chunks."""
    desc1, un1, la, lb, lc, desc2, xy2, un2, sig, far = (t.numpy() for t in rows)
    b_n, n = la.shape
    best, idx = np.full((b_n, n), BIG), np.zeros((b_n, n), np.int64)
    for b in range(b_n):
        for r0 in range(0, n, k_rows):
            chunk = [i for i in range(r0, min(r0 + k_rows, n)) if un1[i]]
            keys = [INT_MAX] * len(chunk)
            for c0 in range(0, n, k_cols):
                cols = np.array([c for c in range(c0, min(c0 + k_cols, n))
                                 if un2[b, c] and far[b, c]], np.int64)
                if not len(cols):
                    continue
                d = np.unpackbits(desc1.view(np.uint8).reshape(n, 32)[chunk][:, None, :]
                                  ^ desc2[b].view(np.uint8).reshape(n, 32)[cols][None, :, :],
                                  axis=-1).sum(-1)
                x2, y2, s = xy2[b, cols, 0], xy2[b, cols, 1], sig[b, cols]
                for j, i in enumerate(chunk):
                    ss = la[b, i] * la[b, i] + lb[b, i] * lb[b, i]
                    den = np.float32(1e-12) if ss < np.float32(1e-12) else ss
                    num = la[b, i] * x2 + lb[b, i] * y2 + lc[b, i]
                    gate = num * num / den < s
                    if gate.any():
                        keys[j] = min(keys[j], int((d[j] * n + cols)[gate].min()))
            for i, key in zip(chunk, keys):
                if key != INT_MAX:
                    best[b, i], idx[b, i] = key // n, key % n
    return best, idx


@pytest.mark.parametrize("b,n,k_rows,k_cols", [(4, 256, 128, 2048), (4, 256, 8, 16),
                                               (3, 100, 7, 33), (1, 64, 128, 2048)])
def test_epi_model_equals_twin(b, n, k_rows, k_cols):
    """The kernel's order at its own chunk sizes (kRows 128, kCols 2048)
    and at small ones (ties split across column chunks): equal to the twin
    on every row."""
    args = _synthetic_epi(np.random.default_rng(n + b), b, n, torch.device("cpu"))
    got = epi_model(cm.epi_rows(*args), k_rows, k_cols)
    want = cm.epi_match_keyframes_plain(*args)
    for name, g, w in zip(("best", "idx"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    hits = got[0] < BIG
    assert hits.sum() > 10
    if b >= 3:
        assert not hits[0].any() and not hits[1].any() and hits[2].any()
