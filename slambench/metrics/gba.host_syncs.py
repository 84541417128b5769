"""gba.host_syncs (loop closing): synchronising CUDA calls
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`, `cudaEventSynchronize`)
that a program span holds, per global BA, in the host-profiled window
recording the program's spans: each is the host waiting for the card. The
harness's own synchronisation at a global BA's end lies outside every
program span and is not counted. Nothing where no program span or no
device activity was traced."""
from slambench.harness.program_trace import OUTSIDE


def read(ctx):
    pt, n = ctx.get("program"), ctx.get("n_program", 0)
    if pt is None or n <= 0 or not pt.recorded() or pt.device_s <= 0:
        return None
    return sum(r.syncs for name, r in pt.rows.items() if name != OUTSIDE) / n
