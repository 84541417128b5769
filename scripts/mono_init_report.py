#!/usr/bin/env python3
"""The `[mono]` phase's first initialization attempts, the port against the
JAX reference with the same RANSAC draws, on the CPU.

    env JAX_PLATFORMS=cpu python scripts/mono_init_report.py [--frames 5]

`chip_smoke.py`'s `[mono]` lap (EVAL.md's fig8-mono row: the figure eight
through ImperfectCamera(noise_sigma=2), 640x480, the initialization
extractor's 2048 keypoints) initializes at frame 3 on the port and at frame
2 in each of the reference's three runs (RANSAC keys PRNGKey(frame_id + k),
k = 0, 1, 2). This script replays `SlamSystem._initialize_monocular`'s
attempts on the first frames, extracted once by the port (both packages
see the same keypoints, as in `scripts/chip_smoke_reference.py`), and for
each attempt and each key k prints:
- SearchForInitialization's match count in both packages;
- RANSAC's best homography and fundamental scores (SH, SF) and the
  choice SH / (SH + SF) > 0.40, from the 200 hypotheses of the same draws;
- CheckRT's good count of the chosen solution and the decision, in both;
- the port's decision with its own draws (a CPU generator seeded with the
  frame id, as `SlamSystem` draws them).
A difference in a decision with the same draws is a fault of the port;
the same decisions with the same draws make the frame the port initializes
at a matter of its draws.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                                      # noqa: E402
import jax.numpy as jnp                                         # noqa: E402
import torch                                                    # noqa: E402

import chip_smoke as cs                                         # noqa: E402
from orb_slam2_tpu.ops import matching as jmatch                # noqa: E402
from orb_slam2_tpu.solvers import initializer as jinit          # noqa: E402
from orb_slam2_tpu_torch.ops import matching as tmatch          # noqa: E402
from orb_slam2_tpu_torch.pipeline import frame as tframe        # noqa: E402
from orb_slam2_tpu_torch.solvers import initializer as tinit    # noqa: E402
from orb_slam2_tpu_torch.utils import convert                   # noqa: E402

jax.config.update("jax_platforms", "cpu")
KEYS = 3


def scores(mod, p1, p2, valid, sets, asarray):
    """RANSAC's per-hypothesis homography and fundamental scores of one
    package on the same sets (the first half of its `initialize`)."""
    p1n, T1 = mod._normalize(p1, valid)
    p2n, T2 = mod._normalize(p2, valid)
    if mod is jinit:
        H = jax.vmap(lambda i: jnp.linalg.inv(T2) @ mod._solve_h(p1n[i], p2n[i]) @ T1)(sets)
        F = jax.vmap(lambda i: T2.T @ mod._solve_f(p1n[i], p2n[i]) @ T1)(sets)
        sh = jax.vmap(lambda h: mod._score_h(h, p1, p2, valid)[0])(H)
        sf = jax.vmap(lambda f: mod._score_f(f, p1, p2, valid)[0])(F)
    else:
        H = torch.linalg.inv(T2) @ mod._solve_h(p1n[sets], p2n[sets]) @ T1
        F = T2.T @ mod._solve_f(p1n[sets], p2n[sets]) @ T1
        sh, sf = mod._score_h(H, p1, p2, valid)[0], mod._score_f(F, p1, p2, valid)[0]
    return asarray(sh), asarray(sf)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    args = ap.parse_args()
    cfg = cs.mono_config()
    world, poses, clean = cs.render_loop_clean(args.frames)
    _, grays = cs.render_mono_frames(clean=(world, poses, clean))
    # the initialization extractor's doubled budget, as every frame before
    # the map exists is extracted
    frames = [tframe.make_frame_monocular(torch.from_numpy(g), cfg, init=True) for g in grays]
    jf = [{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(f).items()} for f in frames]
    ref = 0
    for fid in range(1, len(frames)):
        if ref is None:         # the frame after a failed search starts over
            ref = fid
            continue
        a, b = frames[ref], frames[fid]
        tm = tmatch.search_for_initialization(a.xy, a.level, a.desc, a.valid, a.angle,
                                              b.xy, b.level, b.desc, b.valid, b.angle)
        ja, jb = jf[ref], jf[fid]
        jm = jmatch.search_for_initialization(ja["xy"], ja["level"], ja["desc"], ja["valid"],
                                              ja["angle"], jb["xy"], jb["level"], jb["desc"],
                                              jb["valid"], jb["angle"])
        n_t, n_j = int(tm.valid.sum()), int(jnp.sum(jm.valid))
        same = bool(np.array_equal(tm.idx.numpy(), np.asarray(jm.idx)) and
                    np.array_equal(tm.valid.numpy(), np.asarray(jm.valid)))
        print(f"frame {fid} against frame {ref}: SearchForInitialization {n_t} matches "
              f"(reference {n_j}; the same pairs: {same})", flush=True)
        if n_t < 100:
            ref = None
            continue
        valid = tm.valid
        p1 = a.xy
        p2 = b.xy[torch.clamp(tm.idx, 0, b.xy.shape[0] - 1).long()]
        jp1, jp2, jvalid = jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy()), \
            jnp.asarray(valid.numpy())
        K = (float(cfg.fx), float(cfg.fy), float(cfg.cx), float(cfg.cy))
        n_valid = int(valid.sum())
        packed = torch.argsort((~valid).to(torch.uint8), stable=True)
        for k in range(KEYS):
            key = jax.random.PRNGKey(fid + k)
            draws = np.array(jax.random.randint(key, (jinit.RANSAC_ITERS, 8), 0, n_valid))
            sets = packed[torch.from_numpy(draws).long()]
            sh_t, sf_t = scores(tinit, p1, p2, valid, sets, lambda x: x.numpy())
            sh_j, sf_j = scores(jinit, jp1, jp2, jvalid, jnp.asarray(sets.numpy()), np.asarray)
            got = tinit.initialize(p1, p2, valid, *K, draws=torch.from_numpy(draws))
            want = jinit.initialize(jp1, jp2, jvalid, *K, key=key)
            SH_t, SF_t, SH_j, SF_j = sh_t.max(), sf_t.max(), sh_j.max(), sf_j.max()
            print(f"  key {fid}+{k}: SH {SH_t:.1f} / {SH_j:.1f}, SF {SF_t:.1f} / {SF_j:.1f} "
                  f"(port / reference; best hypotheses {int(sh_t.argmax())}/"
                  f"{int(sh_j.argmax())}, {int(sf_t.argmax())}/{int(sf_j.argmax())}), "
                  f"homography {bool(got.used_homography)} / {bool(want.used_homography)}; "
                  f"good {int(got.good.sum())} / {int(np.sum(want.good))}; success "
                  f"{bool(got.success)} / {bool(want.success)}", flush=True)
        own = tinit.initialize(p1, p2, valid, *K, generator=torch.Generator().manual_seed(fid))
        print(f"  the port's own draws (seed {fid}): success {bool(own.success)}, homography "
              f"{bool(own.used_homography)}, good {int(own.good.sum())}", flush=True)


if __name__ == "__main__":
    main()
