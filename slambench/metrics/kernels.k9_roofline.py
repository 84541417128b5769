"""kernels.k9_roofline (kernels): K9's least time, its launch's bytes
(`harness/counts.ba_assemble_bytes`) at HBM's rate, as a share of its mean
device time per launch in the traced window, in %. Nothing where no K9
launch was traced."""
from slambench.harness import counts, trace


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    t, n = trace.kernel_time(tr, ctx["k9_name"])
    if n == 0 or t <= 0:
        return None
    t_min, _ = counts.bound_s(ctx["k9_bytes"], 0)
    return 100.0 * t_min / (t / n)
