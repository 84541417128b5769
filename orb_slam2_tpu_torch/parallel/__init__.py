"""Multi-device solvers (port of `orb_slam2_tpu/parallel/`).

`distributed.init_distributed` returns a 1-D `torch.distributed` device
mesh named "shard"; `sharded_ba.solve_global_ba_sharded`,
`solvers.pcg_ba.solve_ba_pcg_sharded` and
`sharded_pose_graph.optimize_pose_graph_sharded` split their landmark or
edge axis over it, one block per rank, and all-reduce the small reduced
system. The modules are imported by name, not from here: the solvers in
`solvers/` import `distributed`, and the sharded modules import them.
"""
