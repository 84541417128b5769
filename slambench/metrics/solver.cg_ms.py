"""solver.cg_ms (solvers): device ms per global BA of the activities
launched inside the program's `solvers.pcg.cg` span (the CG loop), in the
host-profiled window recording the program's spans: the most any change to
the CG loop can save. Nothing where that span launched no device work."""
from slambench.harness.program_trace import Row


def read(ctx):
    pt, n = ctx.get("program"), ctx.get("n_program", 0)
    if pt is None or n <= 0:
        return None
    t = pt.rows.get("solvers.pcg.cg", Row()).device_s
    return 1e3 * t / n if t > 0 else None
