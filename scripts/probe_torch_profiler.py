#!/usr/bin/env python3
"""Whether torch.profiler records every device activity in a fresh process:
20 in-place multiplies of a 64 MB tensor, with nothing, a sleeping kernel
before them or one after them inside the profiling window, twice. Needs one
CUDA device; imports nothing of the repo.

    python3 scripts/probe_torch_profiler.py

Prints each window's device rows (kernel, count, ms). Late in
`chip_smoke.py`'s process the profiler drops a share of such activities;
this shows whether a fresh process records them all.
"""
import torch
from torch.profiler import ProfilerActivity, profile


def main():
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    big = torch.ones(1 << 24, device="cuda")
    big.mul_(1.0)
    torch.cuda.synchronize()
    for trial in range(2):
        for where in ("none", "before", "after"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                if where == "before":
                    torch.cuda._sleep(1 << 24)
                for _ in range(20):
                    big.mul_(1.0)
                if where == "after":
                    torch.cuda._sleep(1 << 24)
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            print(trial, where, [(e.key[:50], e.count, round(e.self_device_time_total / 1e3, 4))
                                 for e in evs], flush=True)


if __name__ == "__main__":
    main()
