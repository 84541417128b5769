"""The essential graph's Sim3 pose-graph solve sharded over a device mesh
(port of `orb_slam2_tpu/parallel/sharded_pose_graph.py`).

The edge axis is split into W equal blocks, one per rank. Each rank forms
the residuals and forward-mode Jacobians of its edges
(`pose_graph._edge_terms`) and its part of the 7K x 7K normal system; one
all-reduce of (H, b) a Gauss-Newton step gives every rank the whole
system, damped after the sum (so the result does not depend on W beyond
the order of the float32 sums) and solved alike on every rank. The error
of a tentative step is one more all-reduce.
"""
from __future__ import annotations

from ..geometry.sim3 import Sim3
from ..solvers import pose_graph
from ..solvers.pose_graph import PoseGraphProblem
from . import distributed


def optimize_pose_graph_sharded(prob: PoseGraphProblem, mesh, n_iters: int = 20,
                                fix_scale: bool = False) -> Sim3:
    """`pose_graph.optimize_pose_graph` with the edges sharded over `mesh`
    (a 1-D `DeviceMesh`; E must divide by its size: the caller pads the
    edge axis, `loop_closing.essential_problem`). Every rank solves rank
    0's nodes and returns the same optimized nodes."""
    group = mesh.get_group()
    rows = distributed.block(prob.edge_i.shape[0], *distributed.size_rank(group), "edges")
    R, t, s, node_valid, node_fixed = distributed.broadcast_first(
        group, prob.nodes.R, prob.nodes.t, prob.nodes.s, prob.node_valid, prob.node_fixed)
    meas = prob.edge_meas
    local = PoseGraphProblem(
        nodes=Sim3(R, t, s), node_valid=node_valid, node_fixed=node_fixed,
        edge_i=prob.edge_i[rows], edge_j=prob.edge_j[rows],
        edge_meas=Sim3(meas.R[rows], meas.t[rows], meas.s[rows]),
        edge_valid=prob.edge_valid[rows])
    return pose_graph.optimize_pose_graph(local, n_iters, fix_scale, group=group)
