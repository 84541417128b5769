"""solver.ops_per_gba (solvers): device activities (kernels, copies,
fills) per global BA in the traced window."""


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("n_traced", 0)
    if tr is None or n <= 0 or tr.n_activities == 0:
        return None
    return tr.n_activities / n
