"""solver.lm_kept (solvers): the share of the PCG solver's LM steps whose
error fell and whose work was kept (the program's counters
`solvers.pcg.lm_kept` over `solvers.pcg.lm_tried`) in the window recording
them, in %. Nothing where no step was counted."""


def read(ctx):
    c = ctx.get("counts") or {}
    tried = c.get("solvers.pcg.lm_tried", 0)
    if tried <= 0:
        return None
    return 100.0 * c.get("solvers.pcg.lm_kept", 0) / tried
