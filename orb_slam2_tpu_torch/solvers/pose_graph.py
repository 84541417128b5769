"""Sim3 pose-graph optimization, the essential graph (port of
`orb_slam2_tpu/solvers/pose_graph.py`).

`Optimizer::OptimizeEssentialGraph` (`src/Optimizer.cc:1069-1404`) with
g2o's `VertexSim3Expmap` / `EdgeSim3`: nodes are world-to-camera Sim3s
(7 DoF, the scale frozen for stereo and RGB-D), edges relative Sim3
measurements with identity information, residual
r = log(Sji^-1 * Sjw * Siw^-1). The Jacobians come from forward-mode
differentiation through exp / compose / log (dual tensors, the reference's
`jacfwd`; the g2o fork differentiates EdgeSim3 numerically). The normal
system is H = J^T J of the dense (7E x 7K) Jacobian, one matrix product, so
its sums run in a fixed order (no scatter-add), and it is solved by a
damped Cholesky: 896 x 896 at K = 128. Plain PyTorch on the problem's
device (cuBLAS, cuSOLVER), no host reads. With a process group
(`parallel/sharded_pose_graph.py`) the problem holds this rank's block of
edges: (H, b) is summed over the ranks by one all-reduce before the
damping, and so is the error.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..geometry import sim3
from ..geometry.sim3 import Sim3
from ..parallel import distributed


class PoseGraphProblem(NamedTuple):
    nodes: Sim3                # (K,...) Siw per keyframe
    node_valid: torch.Tensor   # (K,) bool
    node_fixed: torch.Tensor   # (K,) bool: the loop's candidate keyframe
    edge_i: torch.Tensor       # (E,) int32
    edge_j: torch.Tensor       # (E,) int32
    edge_meas: Sim3            # (E,...) Sji = Sjw * Siw^-1
    edge_valid: torch.Tensor   # (E,) bool


def _edge_residual(zeta_i, zeta_j, Si, Sj, meas_inv):
    """r = log(meas^-1 * exp(zeta_j) Sj * (exp(zeta_i) Si)^-1) : (E,7)."""
    Si_new = sim3.compose(sim3.exp(zeta_i), Si)
    Sj_new = sim3.compose(sim3.exp(zeta_j), Sj)
    rel = sim3.compose(Sj_new, sim3.inverse(Si_new))
    return sim3.log(sim3.compose(meas_inv, rel))


def _edge_terms(prob: PoseGraphProblem, nodes: Sim3, jacobians: bool = True):
    """Residuals r (E,7) and, with `jacobians`, dr/dzeta_i and dr/dzeta_j
    (E,7,7) at zeta = 0, all in one forward-mode pass (dual tensors) over
    the edges repeated 14 times, one copy per tangent direction of either
    end."""
    K = prob.node_valid.shape[0]
    Si = nodes.take(torch.clamp(prob.edge_i, 0, K - 1).long())
    Sj = nodes.take(torch.clamp(prob.edge_j, 0, K - 1).long())
    meas_inv = sim3.inverse(prob.edge_meas)
    E = prob.edge_i.shape[0]
    dev = Si.t.device
    if not jacobians:
        z0 = torch.zeros((E, 7), dtype=torch.float32, device=dev)
        return _edge_residual(z0, z0, Si, Sj, meas_inv), None, None

    def rep(g):
        return Sim3(g.R.repeat(14, 1, 1), g.t.repeat(14, 1), g.s.repeat(14))

    zero = torch.zeros((7 * E, 7), dtype=torch.float32, device=dev)
    tangent = torch.eye(7, dtype=torch.float32, device=dev).repeat_interleave(E, dim=0)
    with fwAD.dual_level():
        zi = fwAD.make_dual(torch.cat([zero, zero]), torch.cat([tangent, zero]))
        zj = fwAD.make_dual(torch.cat([zero, zero]), torch.cat([zero, tangent]))
        r, dr = fwAD.unpack_dual(_edge_residual(zi, zj, rep(Si), rep(Sj), rep(meas_inv)))
    # dr[(side, k, e), a] = d r_a(e) / d zeta_side[e, k]
    dr = dr.reshape(2, 7, E, 7).permute(0, 2, 3, 1)
    return r[:E], dr[0], dr[1]


def _solve_iteration(prob: PoseGraphProblem, nodes: Sim3, lam, fix_scale: bool, group=None):
    """One damped Gauss-Newton step: returns the updated nodes."""
    K = prob.node_valid.shape[0]
    r, Ji, Jj = _edge_terms(prob, nodes)
    dev = r.device
    w = prob.edge_valid.to(torch.float32)
    slots = torch.arange(K, device=dev)
    on_i = (prob.edge_i[:, None] == slots) & prob.edge_valid[:, None]      # (E,K)
    on_j = (prob.edge_j[:, None] == slots) & prob.edge_valid[:, None]
    # the dense Jacobian (E*7, K*7): each edge's row block holds Ji at its
    # node i and Jj at its node j (invalid edges are zero rows)
    J = on_i.to(torch.float32)[:, None, :, None] * Ji[:, :, None, :] + \
        on_j.to(torch.float32)[:, None, :, None] * Jj[:, :, None, :]
    J = J.reshape(-1, K * 7)
    H = J.T @ J
    b = -(J.T @ (r * w[:, None]).reshape(-1))
    if group is not None:
        H, b = distributed.all_reduce_sum(group, H, b)

    free = prob.node_valid & ~prob.node_fixed
    free7 = free.repeat_interleave(7)
    if fix_scale:
        # freeze every node's sigma coordinate (stereo / RGB-D: 6 DoF)
        free7 = free7 & (torch.arange(7, device=dev) != 6).repeat(K)
    eye = torch.eye(K * 7, dtype=torch.float32, device=dev)
    Hd = H + lam * eye
    Hd = torch.where(free7[:, None] & free7[None, :], Hd, torch.zeros_like(Hd))
    Hd = Hd + torch.where(free7, 0.0, 1.0) * eye
    bd = torch.where(free7, b, torch.zeros_like(b))
    # cholesky_ex: no host check; a failed factor gives NaN, and the step
    # is rejected, as the reference's
    chol, info = torch.linalg.cholesky_ex(Hd + 1e-8 * eye)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    dx = torch.cholesky_solve(bd[:, None], chol)[:, 0].reshape(K, 7)
    dx = torch.where(free[:, None], dx, torch.zeros_like(dx))
    return sim3.compose(sim3.exp(dx), nodes)


def _error(prob: PoseGraphProblem, nodes: Sim3, group=None):
    r, _, _ = _edge_terms(prob, nodes, jacobians=False)
    err = (r * r * prob.edge_valid.to(torch.float32)[:, None]).sum()
    return err if group is None else distributed.all_reduce_sum(group, err)[0]


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20,
                        fix_scale: bool = False, group=None) -> Sim3:
    """Gauss-Newton with a small damping (the reference's lambda_init is
    1e-16, `src/Optimizer.cc:1084`), n_iters steps, each kept only if it
    lowers the error (lambda halves on a kept step, grows 10x otherwise).
    Returns the optimized nodes. `group`: prob holds this rank's edges
    (`sharded_pose_graph.optimize_pose_graph_sharded`)."""
    nodes = prob.nodes
    lam = torch.full((), 1e-8, dtype=torch.float32, device=nodes.t.device)
    cur = _error(prob, nodes, group)
    for _ in range(n_iters):
        new = _solve_iteration(prob, nodes, lam, fix_scale, group)
        err = _error(prob, new, group)
        accept = err < cur                 # False for NaN: the step is rejected
        nodes = sim3.where(accept.expand(nodes.s.shape), new, nodes)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-12),
                          torch.clamp(lam * 10.0, max=1e4))
        cur = torch.where(accept, err, cur)
    return nodes
