"""The work a global BA needs, counted from its shapes, and the peaks it is
held to. The counts do not depend on how the program solves: they are what
the algorithm needs (each input byte read once, each output written once,
float32), so the one-hot products and repeated passes of an implementation
are not needed work.

`bound_s` and `ba_assemble_bytes` are copies of `chip_smoke._bound` and
`chip_smoke._ba_assemble_bytes`, in seconds.
"""
from __future__ import annotations

import dataclasses

# Published peaks of one NVIDIA H100 SXM (data sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
F32 = 4

ASSEMBLY_OPS_PER_EDGE = 600    # K9's count (PERF.md's kernel table)
OBS_BYTES = 24                 # an observation's u, v, uR, 1/sigma^2, camera, point
W_BYTES = 18 * F32             # an edge's 6x3 pose-point block


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What a global BA works on: valid edges, valid points, free cameras,
    camera and point slots, and sum over points of n(n+1)/2 for n the
    point's edges (the pairs of the sparse Schur complement)."""
    edges: int
    points: int
    free_cams: int
    cam_slots: int
    point_slots: int
    edge_pairs: int


def bound_s(n_bytes: float, ops: float):
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the operations over the float32 rate. Returns (seconds,
    "bytes" or "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def ba_assemble_bytes(n_edges: int, n_points: int, n_cams: int) -> int:
    """The bytes K9's function must move: per edge the observation (u, v,
    uR), inv_sigma2, stereo, mask and a camera index in (28) and We, chi2
    and depth_ok out (77); per point its position and validity in (13) and
    Hpp's 6 entries, bp and pt_on out (37); per camera its pose's 12
    entries in (48) and Hcc's 21 entries and bc out (108); err out. The
    edges, points and cameras are the launch's (padded) ones."""
    return 105 * n_edges + 50 * n_points + 156 * n_cams + 4


def assembly(s: Shapes):
    """One linearization: each observation and the state in, W_e, the
    camera blocks (Hcc 21 + bc 6 floats) and the point blocks (Hpp 6 + bp
    3) out; 600 operations an edge."""
    n_bytes = (s.edges * (OBS_BYTES + W_BYTES) + s.free_cams * (12 + 27) * F32
               + s.points * (3 + 9) * F32)
    return n_bytes, s.edges * ASSEMBLY_OPS_PER_EDGE


def pcg_step(s: Shapes, cg_iters: int):
    """One camera step by PCG and its back-substitution: W_e read once a
    pass (the right-hand side, each CG matvec, the back-substitution), two
    6x3 products an edge a pass (W^T x and W u, 2 x 36 operations), each
    point's 3x3 and each camera's 6x6 products, the block inverses once."""
    passes = cg_iters + 2
    n_bytes = passes * (s.edges * W_BYTES + (s.points * 3 + s.free_cams * 6) * F32)
    ops = passes * (s.edges * 72 + s.points * 18 + s.free_cams * 72) \
        + s.points * 60 + s.free_cams * 400
    return n_bytes, ops


def global_ba(s: Shapes, solver: str, chunks: int, iters: int, cg_iters: int):
    """(bytes, operations) one global BA needs: per chunk its iters + 1
    linearizations and iters camera steps, and the map's state in and out.
    The camera step is counted for the PCG solver, the one a cell runs."""
    if solver != "pcg":
        raise ValueError(f"no count of a {solver!r} camera step")
    a_b, a_o = assembly(s)
    p_b, p_o = pcg_step(s, cg_iters)
    state = (s.free_cams * 12 + s.points * 3) * F32 * 2
    n_bytes = chunks * ((iters + 1) * a_b + iters * p_b + state)
    ops = chunks * ((iters + 1) * a_o + iters * p_o)
    return n_bytes, ops
