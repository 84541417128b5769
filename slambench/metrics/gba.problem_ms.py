"""gba.problem_ms (loop closing): device ms of one
`loop_closing.global_ba_problem(cfg, m0)` called alone, by CUDA events
around back-to-back calls (`entries/global_ba.problem_ms`)."""


def read(ctx):
    return ctx.get("problem_ms")
