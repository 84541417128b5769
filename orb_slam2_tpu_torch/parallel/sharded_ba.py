"""Global bundle adjustment sharded over a device mesh (port of
`orb_slam2_tpu/parallel/sharded_ba.py`).

The landmark axis (the points and their observations) is split into W
equal blocks, one per rank of the mesh. Each rank assembles its block by
K9 (`schur_ba._assemble`) and Schur-reduces it into a partial reduced
camera system; one all-reduce of (S, b_red) gives every rank the whole
6C x 6C system, which each solves alike (a dense Cholesky), and the
points are back-substituted locally. The step's error is one more
all-reduce. The communication of an LM iteration is (6C)^2 + 6C + 1
floats, whatever the number of points.

Each block damps its camera blocks by its own largest diagonal entry
before the sum, as the reference's sharded solve does
(`sharded_ba.py:81-82`), so the result depends on W; at W = 1 it is
`schur_ba.solve_ba`'s bit for bit.
"""
from __future__ import annotations

from ..solvers import schur_ba
from ..solvers.schur_ba import BAProblem, BAResult
from . import distributed


def landmark_block(prob: BAProblem, group) -> BAProblem:
    """This rank's block of the point axis, with rank 0's poses and camera
    masks (the solve is one problem on every rank)."""
    rows = distributed.block(prob.points.shape[0], *distributed.size_rank(group), "points")
    poses, cam_valid, cam_fixed = distributed.broadcast_first(group, prob.poses, prob.cam_valid,
                                                              prob.cam_fixed)
    return BAProblem(poses=poses, cam_valid=cam_valid, cam_fixed=cam_fixed,
                     points=prob.points[rows], pt_valid=prob.pt_valid[rows],
                     obs_cam=prob.obs_cam[rows], obs_uvr=prob.obs_uvr[rows],
                     obs_level=prob.obs_level[rows])


def gather_result(res: BAResult, group) -> BAResult:
    """The whole result on every rank: the poses as they are (replicated),
    the points, inliers and chi2 of every block."""
    return BAResult(poses=res.poses, points=distributed.all_gather_rows(group, res.points),
                    edge_inlier=distributed.all_gather_rows(group, res.edge_inlier),
                    chi2=distributed.all_gather_rows(group, res.chi2))


def solve_global_ba_sharded(cam, prob: BAProblem, level_sigma2, mesh, n_iters: int = 10,
                            robust: bool = False) -> BAResult:
    """Global BA with the point axis sharded over `mesh` (a 1-D
    `DeviceMesh`; Q must divide by its size): n_iters LM iterations (a step
    kept if the error falls, lambda x0.3, else lambda x5), then the chi2
    classification (5.991 / 7.815 and positive depth). The result is the
    whole problem's `BAResult` on every rank.

    Replaces `Optimizer::GlobalBundleAdjustemnt` (`src/Optimizer.cc:62-353`;
    loop closing runs it with 10 non-robust iterations,
    `src/LoopClosing.cc:884-888`)."""
    group = mesh.get_group()
    local = landmark_block(prob, group)
    inv_sigma2, base_mask, delta2 = schur_ba._weights(local, level_sigma2)
    edges = schur_ba._edges(local, inv_sigma2)
    poses, points, lin = schur_ba._lm_iterations(cam, local, edges, local.poses, local.points,
                                                 base_mask.float(), robust, n_iters, group)
    inlier = base_mask & (lin.chi2 <= delta2) & lin.depth_ok
    return gather_result(BAResult(poses=poses, points=points, edge_inlier=inlier,
                                  chi2=lin.chi2), group)
