"""What every kernel wrapper shares: device dispatch, argument checks, the
ctypes launch and the one launch counter.

Each wrapper (`cuda_extract.py`, `cuda_match.py`, `cuda_pose.py`,
`cuda_ba.py`) runs its
plain-PyTorch twin for a CPU tensor and launches its CUDA kernel for a CUDA
tensor, or raises: there is no switch and no fallback. `LAUNCHES` counts
kernel launches by kernel name (K4's two forms apart: `best_two` the window
form, `best_two_node` the node form), one per launch and nowhere else, so a
run can show that it went through the kernels. The count is kept under a
lock: the tracking / mapping split launches from two host threads.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

LAUNCHES = {"pyramid": 0, "dense_stage": 0, "brief": 0, "best_two": 0,
            "best_two_node": 0, "proj_match": 0, "pose_lm": 0, "pose_normal_eqs": 0, "epi_match": 0,
            "ba_edge": 0}
_LAUNCHES_LOCK = threading.Lock()


def reset_launches():
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (twin), False for a CUDA tensor (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or twin for tensors on {t.device}")


def check(t: torch.Tensor, dtype, shape, device, name: str, align: int = 1):
    """Raise unless t is a contiguous tensor of this dtype and shape on
    device whose data starts on an `align`-byte boundary (the kernels load
    descriptor rows as 16-byte and coordinate pairs as 8-byte vectors)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device} aligned to {align} bytes, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()}, address {t.data_ptr():#x})")


def launch(kernel: str, fn_name: str, device, *args):
    """Call the C launcher `fn_name` on the current stream of `device` and
    count one launch of `kernel`. The launcher returns cudaGetLastError()."""
    from ._build import library
    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
    count(kernel)


def count(kernel: str):
    """One launch of `kernel` (from any host thread)."""
    with _LAUNCHES_LOCK:
        LAUNCHES[kernel] += 1


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def counters(kernel: str, device, n: int):
    """The n uint32 counters (as int32) of `kernel` for launches on the
    current stream of `device`, 0 between launches: the kernel's last block
    sets them back to 0. Launches on one stream run one after another, so
    they share a buffer; launches on two streams may overlap, so each
    stream has its own, and so does each kernel."""
    return _counters(kernel, device, torch.cuda.current_stream(device).cuda_stream, n)


@functools.lru_cache(maxsize=64)
def _counters(kernel: str, device, stream: int, n: int):
    # made while `stream` is current on `device`, so the caching allocator
    # never hands the buffer to another stream while a launch may use it
    return torch.zeros((n,), dtype=torch.int32, device=device)
