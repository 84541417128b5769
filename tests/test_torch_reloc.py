"""The port's relocalization searches (`ops/matching.search_by_projection_reloc`,
K4's window form with octaves (-1, +1)) and rescue round
(`pipeline/tracking_ops.reloc_rescue`) against the JAX reference on the CPU.

Tolerances, and why:
- the search: bit-exact (integer gates and Hamming argmins; the window's
  float compares on the same float32 values), at both rescue rounds;
- the rescue on a JAX map snapshot (`utils/convert.py`): the same matches,
  the same inlier count, Tcw within 1e-4 (one motion-only BA, float32 sums
  in another order).
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.mapstate import map as jmap
from orb_slam2_tpu.ops import matching as jmatch
from orb_slam2_tpu.pipeline import frame as jframe
from orb_slam2_tpu.pipeline import mapping_ops as jmo
from orb_slam2_tpu.pipeline import tracking_ops as jto
from orb_slam2_tpu.pipeline import tracking_step as jts
from orb_slam2_tpu.utils import config as jconfig

from orb_slam2_tpu_torch.ops import matching as tmatch
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.pipeline import tracking_ops as tto
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import synthetic as tsyn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import _synthetic_proj_tiles  # noqa: E402

torch.set_num_threads(1)
H, W, FX = 240, 320, 260.0
SCALE = tuple(1.2 ** i for i in range(8))
ROUNDS = [(10.0, 100), (3.0, 64)]


@pytest.mark.parametrize("th,orb_dist", ROUNDS)
@pytest.mark.parametrize("n", [600, 2048])
def test_search_by_projection_reloc_bit_exact(th, orb_dist, n):
    rng = np.random.default_rng(n + int(th))
    args, _ = _synthetic_proj_tiles(rng, "cpu", p=n // 2, n=n)
    uv, radius, pred, _, p_valid, p_desc, kp_xy, kp_level, _, kp_valid, kp_desc = args
    p_angle = torch.from_numpy(rng.uniform(0, 360, n // 2).astype(np.float32))
    kp_angle = torch.from_numpy(rng.uniform(0, 360, n).astype(np.float32))
    already = torch.from_numpy(rng.random(n) < 0.3)
    got = tmatch.search_by_projection_reloc(uv, pred, p_desc, p_valid, p_angle, kp_xy,
                                            kp_level, kp_desc, kp_valid, kp_angle, already,
                                            SCALE, th=th, orb_dist=orb_dist)
    j = lambda t: jnp.asarray(t.numpy().view(np.uint32) if t.dtype == torch.int32 and
                              t.dim() == 2 else t.numpy())
    want = jmatch.search_by_projection_reloc(j(uv), j(pred), j(p_desc), j(p_valid), j(p_angle),
                                             j(kp_xy), j(kp_level), j(kp_desc), j(kp_valid),
                                             j(kp_angle), j(already), SCALE, th=th,
                                             orb_dist=orb_dist)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    np.testing.assert_array_equal(got.idx.numpy()[v], np.asarray(want.idx)[v])
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert v.sum() > 10
    # a target taken already is never matched again
    assert not already.numpy()[got.idx.numpy()[v]].any()


def _jframe(f):
    return jframe.FrameData(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(f).items()})


@pytest.fixture(scope="module")
def snapshot():
    """A JAX map: the RGB-D initialization on frame 0, frames 1 and 2
    tracked; the rescue then re-searches keyframe 0's points into frame 2
    from a pose near its own, with most of its matches dropped."""
    kw = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H, bf=0.25 * FX,
              sensor=jconfig.SENSOR_RGBD, fps=30.0, th_depth=40.0, n_features=300,
              max_keyframes=8, max_map_points=4096, max_local_points=1024)
    jcfg = jconfig.SlamConfig(use_pallas=0, **kw)
    tcfg = convert.config_from_jax(jcfg)
    world = tsyn.PlateWorld(FX, FX, W / 2, H / 2, W, H, z0=5.0)
    tf = []
    for T in tsyn.loop_trajectory(181, radius=3.0, overshoot=0.5, spiral=0.12)[:3]:
        gray, depth = world.render_with_depth(T)
        gray = np.clip(np.round(gray), 0, 255).astype(np.uint8)
        tf.append(tframe.make_frame_rgbd(torch.from_numpy(gray), torch.from_numpy(depth), tcfg))
    jf = [_jframe(f) for f in tf]
    N = jcfg.max_keypoints
    eye = jnp.eye(4, dtype=jnp.float32)
    m, kf0 = jmo.insert_keyframe(jcfg, jmap.empty(8, 4096, N), jf[0], eye,
                                 jnp.full((N,), -1, jnp.int32), 0, 0.0, all_depth=True)
    lm = m.kf_obs[kf0]
    lp, lpv = tsystem.last_points(tcfg, convert.mapstate_from_numpy(m, device="cpu"), tf[0],
                                  torch.eye(4), torch.from_numpy(np.array(lm)))
    r1 = jts.full_tracking_step(jcfg, jax.tree.map(jnp.copy, m), jf[1], jf[0],
                                jnp.asarray(lp.numpy()), jnp.asarray(lpv.numpy()), lm, eye, eye,
                                jnp.asarray(False), kf0, 30)
    r2 = jts.full_tracking_step(jcfg, jax.tree.map(jnp.copy, r1.m), jf[2], jf[1], r1.next_pts,
                                r1.next_pts_valid, r1.matched_pt, r1.Tcw, r1.next_vel,
                                jnp.asarray(True), r1.ref_kf, 30)
    keep = np.random.default_rng(3).random(N) < 0.15
    matched = np.where(keep, np.asarray(r2.matched_pt), -1).astype(np.int32)
    Tcw = np.asarray(r2.Tcw).copy()
    Tcw[:3, 3] += [0.01, -0.005, 0.008]
    return dict(jcfg=jcfg, tcfg=tcfg, m=r2.m, kf=int(kf0), jf=jf[2], tf=tf[2], Tcw=Tcw,
                matched=matched)


def test_reloc_rescue_on_a_jax_map(snapshot):
    s = snapshot
    tm = convert.mapstate_from_numpy(s["m"], device="cpu")
    jT, jmatched = jnp.asarray(s["Tcw"]), jnp.asarray(s["matched"])
    tT, tmatched = torch.from_numpy(s["Tcw"]), torch.from_numpy(s["matched"])
    n_before = int((s["matched"] >= 0).sum())
    for th, orb_dist in ROUNDS:
        jT, jmatched, jn = jto.reloc_rescue(s["jcfg"], s["m"], s["kf"], s["jf"], jT, jmatched,
                                            th=th, orb_dist=orb_dist)
        tT, tmatched, tn = tto.reloc_rescue(s["tcfg"], tm, s["kf"], s["tf"], tT, tmatched,
                                            th=th, orb_dist=orb_dist)
        np.testing.assert_array_equal(tmatched.numpy(), np.asarray(jmatched))
        assert int(tn) == int(jn)
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-4)
    # the wide round found the dropped matches again
    assert int(tn) > 2 * n_before
