"""The device mesh and the collectives of the sharded solvers (port of
`orb_slam2_tpu/parallel/distributed.py`).

The reference's design scales global BA and the essential graph over a
mesh: every rank holds the whole map (the SPMD contract: every rank
builds the same `SlamSystem` and feeds it the same frames, so every rank
calls the sharded solvers in the same order), solves its block of the
landmark or edge axis, and one all-reduce per iteration sums the small
reduced system, which every rank then solves alike.

    # one process per GPU: torchrun --nproc-per-node=N script.py
    from orb_slam2_tpu_torch.parallel import distributed
    mesh = distributed.init_distributed()            # NCCL, from torchrun's environment
    system = SlamSystem(cfg, gba_mesh=mesh)

`init_distributed(device="cpu", ...)` makes a gloo mesh instead, as the
tests do with CPU processes. The mesh carries the process group; the
solvers run on the device of the tensors they are given.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device="cuda", axis: str = "shard") -> DeviceMesh:
    """Initialize the default process group, if no one has, and return a
    1-D device mesh over all its ranks, its dimension named `axis`.

    The group comes from explicit arguments (`init_method`, e.g.
    "tcp://localhost:29500" or "file:///path", with `world_size` and
    `rank`), else from torchrun's environment (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT), else it is this process alone (world size 1,
    an in-memory store). The backend is NCCL for device "cuda" (the
    default) and gloo for "cpu"; an NCCL failure raises, with no fallback
    to gloo."""
    dev_type = torch.device(device).type
    backend = BACKENDS[dev_type]
    if not dist.is_initialized():
        if world_size is not None:
            dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                    rank=rank)
        elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend} for "
                         f"device {device}")
    return init_device_mesh(dev_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def size_rank(group):
    """(the size W of a process group, this process's rank in it)."""
    return dist.get_world_size(group), dist.get_rank(group)


def block(n: int, W: int, r: int, what: str):
    """Rank r's rows [r n/W, (r+1) n/W) of an axis of n, which must split
    into W equal blocks (the reference's `P("shard")`)."""
    if n % W:
        raise ValueError(f"{n} {what} do not split into {W} equal blocks")
    return slice(r * n // W, (r + 1) * n // W)


def all_reduce_sum(group, *ts):
    """The sums over the ranks of float32 tensors, by one all-reduce of them
    packed end to end."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=group)
    return [part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in ts]), ts)]


def broadcast_first(group, *ts):
    """Rank 0's copy of each tensor, on every rank (the caller's tensors are
    left as they are; bool goes as uint8)."""
    src = dist.get_global_rank(group, 0)
    out = []
    for t in ts:
        buf = t.to(torch.uint8) if t.dtype == torch.bool else t.clone()
        dist.broadcast(buf, src=src, group=group)
        out.append(buf.bool() if t.dtype == torch.bool else buf)
    return out


def all_gather_rows(group, t):
    """Every rank's block of rows, in rank order."""
    buf = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out
