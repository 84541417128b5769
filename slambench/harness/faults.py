"""Faults planted under the global-BA entry's timed path, for the readings
that show which numbers catch them (`tools/readings.py`) and the test that
sees each make a run incorrect (`tests/test_slambench_faults.py`). Each is
a context manager over the entry's state; on exit the program is as it
was.

`FAULTS` break the answer: a step that returns its state unchanged, half
of the points left out, one answer altered where it is produced.
`SHORTCUTS` leave out part of the mathematics, as a change made for speed
could: one LM iteration fewer in each chunk, half the CG iterations. The
readings at the cell's size set the limits below both."""
from __future__ import annotations

import contextlib

import torch

from orb_slam2_tpu_torch.pipeline import loop_closing
from orb_slam2_tpu_torch.solvers import pcg_ba


@contextlib.contextmanager
def _patched(mod, attr, fn):
    saved = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, saved)


@contextlib.contextmanager
def unchanged(st):
    """Each global BA step returns the map it was given."""
    with _patched(loop_closing, "run_global_ba", lambda cfg, m, mesh=None, n_iters=10: m):
        yield


@contextlib.contextmanager
def half_points(st):
    """Half of the points (the odd slots) left out of the problem."""
    real = loop_closing.global_ba_problem

    def problem(cfg, m):
        prob = real(cfg, m)
        odd = torch.arange(prob.pt_valid.shape[0], device=prob.pt_valid.device) % 2 == 1
        return prob._replace(pt_valid=prob.pt_valid & ~odd)
    with _patched(loop_closing, "global_ba_problem", problem):
        yield


@contextlib.contextmanager
def altered(st):
    """The answer of one keyframe (the middle valid one) altered where the
    global BA produces it: its centre moved by 2 cm along its x axis."""
    real = loop_closing.run_global_ba
    k = int(st.arr.kf_valid.sum()) // 2

    def run(cfg, m, mesh=None, n_iters=10):
        out = real(cfg, m, mesh=mesh, n_iters=n_iters)
        pose = out.kf_pose.clone()
        pose[k, 0, 3] += 0.02
        return out._replace(kf_pose=pose)
    with _patched(loop_closing, "run_global_ba", run):
        yield


FAULTS = {"unchanged": unchanged, "half_points": half_points, "altered": altered}


@contextlib.contextmanager
def lm_fewer(st):
    """One LM iteration fewer in each chunk of the global BA."""
    real = loop_closing.run_global_ba

    def run(cfg, m, mesh=None, n_iters=10):
        return real(cfg, m, mesh=mesh, n_iters=max(1, n_iters - 1))
    with _patched(loop_closing, "run_global_ba", run):
        yield


@contextlib.contextmanager
def cg_half(st):
    """Half the configuration's CG iterations in each PCG camera step."""
    real = pcg_ba.solve_ba_pcg
    half = max(1, int(st.data["global_ba"].get("cg_iters", 50)) // 2)

    def solve(*args, **kw):
        return real(*args, **dict(kw, cg_iters=half))
    with _patched(pcg_ba, "solve_ba_pcg", solve):
        yield


SHORTCUTS = {"lm_fewer": lm_fewer, "cg_half": cg_half}
