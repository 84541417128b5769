"""Build and load the hand-written CUDA kernels of `orb_slam2_tpu_torch/csrc/`.

The sources have a plain C interface. At first use `nvcc` compiles each
`csrc/*.cu` for Hopper (`sm_90a`), one process per source, all started
together, and links the objects into one shared library under
`_build/<hash>/` in the package (listed in `.gitignore`), keyed by a hash
of the sources and the flags, so an edit rebuilds and an unchanged tree
reuses the library.
The library is loaded with ctypes; pointers and the CUDA stream pass as
`c_void_p`. There is no fallback: a missing `nvcc` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Per-source flags. -fmad=false: no multiply-add is contracted into an FMA,
# so a kernel that performs its twin's float32 operations in the twin's
# order rounds every term as the twin does: the pose sweep (K6/K7), the
# epipolar gate (K8) and the BA assembly (K9).
SOURCE_FLAGS = {name: ("-fmad=false",) for name in ("pose_lm.cu", "epi_match.cu",
                                                     "ba_edge.cu")}
LIB_NAME = "liborb_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each kernel's launcher; every one returns cudaGetLastError()
SIGNATURES = {
    # n levels, dims (2n + 2 host ints), img, out, itaps, ftaps, counters,
    # stream
    "orb_pyramid": (_I, _P, _P, _P, _P, _P, _P, _P),
    # n levels, ptrs (4n host pointers), dims (6n host ints), taps, ini_th,
    # min_th, stream
    "orb_dense_stage_levels": (_I, _P, _P, _P, _F, _F, _P),
    # n levels, blurs (n host pointers), dims (3n host ints), ys, xs, ca,
    # sa, points, out, stream
    "orb_brief_levels": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # uv, radius, src_level, src_ur, src_valid, src_desc, n, kp_xy, kp_level,
    # kp_ur, kp_valid, kp_desc, m, dlo, dhi, best, idx, second, carry, stream
    "orb_window_best_two": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                            _P, _P, _P, _P, _P),
    # desc_a, node_a, valid_a, n, desc_b, node_b, valid_b, m, best, idx,
    # second, stream
    "orb_node_best_two": (_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P),
    # uv, radius, pred_level, p_ur, p_valid, p_desc, p, kp_xy, kp_level,
    # kp_ur, kp_valid, kp_desc, n, best, idx, second, carry, stream
    "orb_proj_match": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                       _P, _P, _P, _P, _P),
    # Tcw, fx, fy, cx, cy, bf, d2_mono, d2_stereo, xw, obs, inv_s2, stereo,
    # valid, e, n_rounds, n_iters, pose (4x4), inliers, n_inl, chi2, stream
    "orb_pose_lm": (_P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                    _P, _P, _P),
    # Tcw, fx, fy, cx, cy, bf, d2_mono, d2_stereo, xw, obs, inv_s2, stereo,
    # mask, e, robust, out, stream
    "orb_pose_normal_eqs": (_P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _P, _P, _I, _I, _P,
                            _P),
    # sigma2, scale (host float tables), levels, kf_obs, kf_feat_valid, kf_xy,
    # kf_desc, kf_level, kf1, kf2, F, epipoles, n_nb, n, best, idx, stream
    "orb_epi_match": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P),
    # fx, fy, cx, cy, bf, d2m, d2s, robust, poses, points, pt_valid, cam, obs,
    # inv_s2, stereo, mask, order, cam_start, Q, O, C, Hcc, bc, Hpp, bp, We,
    # pt_on, err, chi2, depth_ok, partial, err_pt, counters, stream
    "orb_ba_assemble": (_P, _P, _P, _P, _P, _F, _F, _I, *(_P,) * 10, _I, _I, _I,
                        *(_P,) * 13),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc"))
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def build():
    """Compile the kernels if this source tree has not been built yet.

    Returns (library path, seconds spent compiling (0.0 when reused),
    nvcc's diagnostic output per source: the ptxas register, spill and
    shared-memory report)."""
    srcs = _sources()
    h = hashlib.sha256(repr((NVCC_FLAGS, sorted(SOURCE_FLAGS.items()))).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [os.path.join(out_dir, os.path.basename(s)[:-3] + f".{os.getpid()}.o")
            for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(os.path.basename(s), ()),
                               "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s, o in zip(srcs, objs)]
    report, failed = [], []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        report.append(f"== {os.path.basename(s)}\n{out}")
        if p.returncode != 0:
            failed.append(f"{os.path.basename(s)} (exit {p.returncode})")
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n" + "".join(report))
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    for o in objs:
        os.remove(o)
    os.replace(tmp, lib)          # atomic: a concurrent loader sees all or nothing
    return lib, seconds, "".join(report)


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once, whichever host
    thread launches first)."""
    with _LIBRARY_LOCK:
        return _library()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
