"""DLT triangulation (port of `orb_slam2_tpu/geometry/triangulation.py`;
`Initializer::Triangulate`, `src/Initializer.cc:1069-1124`)."""
from __future__ import annotations

import torch


def triangulate(P1, P2, x1, x2):
    """P1, P2: (...,3,4) projection matrices; x1, x2: (...,2) coordinates
    in the frame of the Ps; leading axes broadcast. Returns (...,3) world
    points.

    Rows of A: x*P[2]-P[0], y*P[2]-P[1] for each view. The inhomogeneous
    DLT solves A[:, :3] X = -A[:, 3] by its 3x3 normal equations, as the
    reference does (scene points sit at finite depth, and every consumer
    re-gates by reprojection error)."""
    a0 = x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :]
    a1 = x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :]
    a2 = x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :]
    a3 = x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :]
    A = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)   # (...,4,4)
    M = A[..., :3]
    b = -A[..., 3]
    N = torch.einsum("...ri,...rj->...ij", M, M)
    Mb = torch.einsum("...ri,...r->...i", M, b)
    N = N + 1e-9 * torch.eye(3, dtype=A.dtype, device=A.device)
    # solve_ex: no error check, so no host sync and no raise on a singular
    # system (its row is gated out downstream, as in the reference)
    return torch.linalg.solve_ex(N, Mb[..., None]).result[..., 0]
