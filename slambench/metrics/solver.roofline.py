"""solver.roofline (solvers): the least time one global BA's needed bytes
and operations take at the card's peaks (`harness/counts.global_ba`), as a
share of the measured time per global BA (`gba_s` of the same run), in %."""
from slambench.harness import counts


def read(ctx):
    if "needed" not in ctx or not ctx.get("gba_s"):
        return None
    t_min, _ = counts.bound_s(*ctx["needed"])
    return 100.0 * t_min / ctx["gba_s"]
