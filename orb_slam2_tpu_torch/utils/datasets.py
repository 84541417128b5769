"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV (port of
`orb_slam2_tpu/utils/datasets.py`).

The reference's example programs read each image with cv::imread after
listing the sequence (`Examples/Monocular/mono_tum.cc:38-97` LoadImages,
`Examples/Stereo/stereo_kitti.cc`, `Examples/RGB-D/rgbd_tum.cc` with its
association files). Here each dataset is an iterator over host arrays
backed by `ImageStream`, the prefetching decoder of
`native/libslamloader.so` (libpng, worker threads), loaded through ctypes.
Where that library does not load, `ImageStream` decodes with this module's
own PNG (stdlib zlib, all five row filters) and PGM/PPM reader in a few
worker processes; `ImageStream.decoder` names the one that runs. Host-side NumPy:
images reach the system as float32 gray, depth as float32 raw sensor units
(`SlamConfig.depth_map_factor` scales it to metres on the device).
"""
from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import sys
import threading
import zlib
from collections import deque
from concurrent.futures import Future
from typing import Iterator, List, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native",
                                         "libslamloader.so"))
_lib = None
_lib_error: Optional[str] = None


def _load_native():
    """The native decoder library, or None (the reason in `_lib_error`).
    It is loaded as built; nothing here builds it."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _lib_error = str(e)
        return None
    lib.slam_loader_create.restype = ctypes.c_void_p
    lib.slam_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.slam_loader_next.restype = ctypes.c_int
    lib.slam_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.slam_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# The decoder of this module: PNG (zlib) and binary PGM / PPM
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples per pixel


def _unfilter_rows(kinds, rows, stride: int, bpp: int) -> np.ndarray:
    """None, Sub and Up rows, one row at a time."""
    out = np.empty(rows.shape, np.uint8)
    prior = np.zeros(stride, np.uint8)
    pad = (-stride) % bpp
    for y, (r, k) in enumerate(zip(rows, kinds)):
        if k == 0:
            cur = r
        elif k == 1:        # Sub: a running sum along each byte lane, mod 256
            lanes = np.concatenate([r, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        else:               # Up
            cur = r + prior
        out[y] = cur
        prior = out[y]
    return out


def _unfilter_wavefront(kinds, rows, stride: int, bpp: int) -> np.ndarray:
    """Any mix of the five filters. A pixel's byte needs the pixel to its
    left (a), above (b) and above-left (c), all on earlier anti-diagonals
    y + x, so each anti-diagonal is one vector step: height + width steps
    where Average and Paeth would take one step per byte."""
    height = rows.shape[0]
    npx = -(-stride // bpp)
    n_diag = height + npx - 1
    filt = np.zeros((height, npx * bpp), np.int16)
    filt[:, :stride] = rows
    filt = filt.reshape(height, npx, bpp)
    # skewed: sk[d + 1, y + 1] is pixel (y, x = d - y); a pixel off the image
    # (x < 0, y < 0, d < 0) stays 0, as the filters take it
    sk = np.zeros((n_diag + 1, height + 1, bpp), np.int16)
    ys = np.arange(height)[:, None]
    d_all = ys + np.arange(npx)[None, :]
    fsk = np.zeros((n_diag, height, bpp), np.int16)
    fsk[d_all, np.broadcast_to(ys, d_all.shape)] = filt
    k = kinds.astype(np.int64)[:, None]
    sub, up, avg, paeth = k == 1, k == 2, k == 3, k == 4
    for d in range(n_diag):
        lo, hi = max(0, d - npx + 1), min(height, d + 1)
        a = sk[d, lo + 1:hi + 1]
        b = sk[d, lo:hi]
        c = sk[d - 1, lo:hi] if d else np.zeros_like(b)
        bc, ac = b - c, a - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(paeth[lo:hi], pred, np.where(avg[lo:hi], (a + b) >> 1, np.where(
            up[lo:hi], b, np.where(sub[lo:hi], a, 0))))
        sk[d + 1, lo + 1:hi + 1] = (fsk[d, lo:hi] + pred) & 0xFF
    out = sk[1 + d_all, 1 + np.broadcast_to(ys, d_all.shape)]
    return out.reshape(height, -1)[:, :stride].astype(np.uint8)


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of a
    non-interlaced image: (height, stride) uint8 rows of bpp bytes per
    pixel (at least 1)."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, {height * (stride + 1)} expected")
    raw = raw.reshape(height, stride + 1)
    kinds, rows = raw[:, 0], raw[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {kinds.max()} is not one of the five")
    if kinds.max(initial=0) <= 2:
        return _unfilter_rows(kinds, rows, stride, bpp)
    return _unfilter_wavefront(kinds, rows, stride, bpp)


def decode_png(path: str) -> np.ndarray:
    """A non-interlaced PNG as the native decoder returns it: (H, W, C)
    uint16 (8-bit samples widened, 16-bit native), C = 1 (gray) or 3 (RGB,
    palette expanded), alpha stripped; gray below 8 bits scaled to 0-255."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, ihdr = 8, [], None, None
    while pos < len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, bits, colour, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if colour not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {colour}")
    ch = _PNG_CHANNELS[colour]
    stride = (w * ch * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, ch * bits // 8))
    if bits == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif bits == 8:
        img = rows.reshape(h, w, ch).astype(np.uint16)
    else:                       # 1, 2, 4 bits: gray or palette indices
        px = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
        vals = (px * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(-1)[:, :w]
        if colour == 0:
            vals = vals * (255 // ((1 << bits) - 1))
        img = vals.astype(np.uint16).reshape(h, w, 1)
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        img = palette[img[..., 0]].astype(np.uint16)
    elif colour in (4, 6):      # strip alpha
        img = img[..., :ch - 1]
    return img


def decode_pnm(path: str) -> np.ndarray:
    """Binary PGM (P5) or PPM (P6) as (H, W, C) uint16 (16-bit big-endian
    samples where maxval > 255)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic = buf[:2]
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PGM / PPM file")
    fields, pos = [], 2
    while len(fields) < 3:
        while buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":
            pos = buf.index(b"\n", pos) + 1
            continue
        end = pos
        while not buf[end:end + 1].isspace():
            end += 1
        fields.append(int(buf[pos:end]))
        pos = end
    w, h, maxv = fields
    pos += 1                    # the one whitespace byte after maxval
    ch = 3 if magic == b"P6" else 1
    n = w * h * ch
    dt = np.dtype(">u2") if maxv > 255 else np.dtype(np.uint8)
    data = np.frombuffer(buf, dt, count=n, offset=pos)
    return data.astype(np.uint16).reshape(h, w, ch)


def decode_image(path: str) -> np.ndarray:
    """One image file by its extension, as the native decoder picks."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return decode_png(path)
    if ext in (".pgm", ".ppm", ".pnm"):
        return decode_pnm(path)
    try:
        return decode_png(path)
    except ValueError:
        return decode_pnm(path)


class _DecodeWorker:
    """One process of the port's decoder: this file run as a script (numpy
    and the standard library only), reading a path a line on its stdin and
    writing each image to its stdout as "+", its (H, W, C) as three
    big-endian u32 and its uint16 samples, or as "-" and a length-prefixed
    error. A thread here reads the results into futures. Processes, not
    threads: undoing Average and Paeth rows is ~1,100 small numpy calls an
    image, which would hold the GIL that the thread issuing the card's work
    needs."""

    def __init__(self):
        self.proc = subprocess.Popen([sys.executable, "-P", os.path.abspath(__file__),
                                      "--decode-worker"],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.pending: deque = deque()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def submit(self, path: str) -> Future:
        f: Future = Future()
        self.pending.append((path, f))
        self.proc.stdin.write(path.encode() + b"\n")
        self.proc.stdin.flush()
        return f

    def _read(self):
        out, why = self.proc.stdout, "the decoder process ended"
        try:
            while True:
                status = out.read(1)
                if status == b"+":
                    shape = struct.unpack(">III", out.read(12))
                    n = 2 * shape[0] * shape[1] * shape[2]
                    data = out.read(n)
                    if len(data) != n:
                        break
                    path, f = self.pending.popleft()
                    f.set_result(np.frombuffer(data, np.uint16).reshape(shape))
                elif status == b"-":
                    msg = out.read(struct.unpack(">I", out.read(4))[0]).decode()
                    path, f = self.pending.popleft()
                    f.set_exception(ValueError(msg))
                else:
                    break
        except Exception as e:      # a broken stream: fail what waits, stop the process
            why = f"{why}: {e!r}"
            self.proc.kill()
        while self.pending:
            path, f = self.pending.popleft()
            f.set_exception(OSError(f"{path}: {why}"))

    def close(self):
        if self.pending:            # closed early: drop the files still queued
            self.proc.kill()
        self.proc.stdin.close()
        self.proc.wait()
        self.reader.join()


def _serve():
    """The decoder process's loop (`_DecodeWorker`)."""
    out = sys.stdout.buffer
    for line in sys.stdin.buffer:
        try:
            img = np.ascontiguousarray(decode_image(line.rstrip(b"\n").decode()), np.uint16)
        except Exception as e:      # reported to the reading side, which raises it
            msg = f"{type(e).__name__}: {e}".encode()
            out.write(b"-" + struct.pack(">I", len(msg)) + msg)
        else:
            out.write(b"+" + struct.pack(">III", *img.shape) + img.tobytes())
        out.flush()


class ImageStream:
    """In-order prefetched image stream over a list of paths. Yields float32
    grayscale (or, with gray=False, the raw uint16 samples) numpy arrays.
    `decoder` is "native" (libslamloader.so on `threads` worker threads) or
    "python" (this module's decoder in `threads` worker processes); either
    decodes `window` files ahead. Call close() when done; iterating to the
    end closes it too."""

    def __init__(self, paths: List[str], gray: bool = True, window: int = 8,
                 threads: int = 2, max_pixels: int = 4096 * 3072):
        self.paths = paths
        self.gray = gray
        self.lib = _load_native()
        self.decoder = "native" if self.lib is not None else "python"
        self._i = 0
        self._handle = None
        self._workers = None
        if self.lib is not None:
            self._buf = np.zeros(max_pixels * 3, dtype=np.uint16)
            arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
            self._handle = self.lib.slam_loader_create(arr, len(paths), window, threads)
        elif paths:
            self._workers = [_DecodeWorker() for _ in range(max(1, min(threads, len(paths))))]
            self._ahead = deque(self._submit(j) for j in range(min(window, len(paths))))
            self._window = window

    def _submit(self, j: int) -> Future:
        return self._workers[j % len(self._workers)].submit(self.paths[j])

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        return self

    def _next_raw(self) -> np.ndarray:
        if self._handle is not None:
            w = ctypes.c_int(); h = ctypes.c_int()
            c = ctypes.c_int(); bits = ctypes.c_int()
            ok = self.lib.slam_loader_next(
                self._handle, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                self._buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                ctypes.byref(bits))
            if not ok:
                raise OSError(f"the native decoder failed on {self.paths[self._i - 1]}")
            n = w.value * h.value * c.value
            return self._buf[:n].reshape(h.value, w.value, c.value).copy()
        if self._workers is None:
            raise ValueError("ImageStream is closed")
        nxt = self._i - 1 + self._window
        if nxt < len(self.paths):
            self._ahead.append(self._submit(nxt))
        return self._ahead.popleft().result()

    def __next__(self) -> np.ndarray:
        if self._i >= len(self.paths):
            self.close()
            raise StopIteration
        self._i += 1
        img = self._next_raw()
        if self.gray:
            if img.shape[2] == 3:
                img = (0.299 * img[:, :, 0] + 0.587 * img[:, :, 1]
                       + 0.114 * img[:, :, 2])
            else:
                img = img[:, :, 0]
            return img.astype(np.float32)
        return img[:, :, 0] if img.shape[2] == 1 else img

    def close(self):
        if self._handle is not None:
            self.lib.slam_loader_destroy(self._handle)
            self._handle = None
        if self._workers is not None:
            for w in self._workers:
                w.close()
            self._workers = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _Sequence:
    """close() for the streams a dataset holds, and `with` support."""
    _streams: Tuple[str, ...] = ()

    @property
    def decoder(self) -> str:
        return getattr(self, self._streams[0]).decoder

    def close(self):
        for name in self._streams:
            getattr(self, name).close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _listing(path: str) -> List[List[str]]:
    """The whitespace-split rows of a TUM-style listing, comments skipped."""
    with open(path) as f:
        return [line.split() for line in f if line.strip() and not line.startswith("#")]


# ---------------------------------------------------------------------------
# Dataset front ends
# ---------------------------------------------------------------------------

class TumMonocular(_Sequence):
    """TUM rgb.txt-listed sequence (`mono_tum.cc` LoadImages)."""
    _streams = ("stream",)

    def __init__(self, seq_dir: str):
        self.dir = seq_dir
        rows = _listing(os.path.join(seq_dir, "rgb.txt"))
        self.timestamps: List[float] = [float(r[0]) for r in rows]
        self.stream = ImageStream([os.path.join(seq_dir, r[1]) for r in rows])

    def __len__(self):
        return len(self.timestamps)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        for ts, img in zip(self.timestamps, self.stream):
            yield ts, img


def associate_tum(seq_dir: str, max_dt: float = 0.02):
    """rgb <-> depth timestamp association (the TUM associate.py tool that
    made the reference's `Examples/RGB-D/associations/*`): each rgb entry
    with the nearest depth entry within max_dt."""
    rgb = [(float(r[0]), r[1]) for r in _listing(os.path.join(seq_dir, "rgb.txt"))]
    depth = [(float(r[0]), r[1]) for r in _listing(os.path.join(seq_dir, "depth.txt"))]
    d_ts = np.array([t for t, _ in depth])
    pairs = []
    for ts, rel in rgb:
        i = int(np.argmin(np.abs(d_ts - ts)))
        if abs(d_ts[i] - ts) <= max_dt:
            pairs.append((ts, rel, depth[i][1]))
    return pairs


class TumRGBD(_Sequence):
    """TUM RGB-D with on-the-fly association (or a 4-column association
    file like the reference's `associations/fr1_desk.txt`). Yields
    (timestamp, float32 gray, float32 raw depth)."""
    _streams = ("rgb", "depth")

    def __init__(self, seq_dir: str, association_file: Optional[str] = None):
        self.dir = seq_dir
        if association_file and os.path.exists(association_file):
            self.entries = [(float(p[0]), p[1], p[3]) for p in _listing(association_file)]
        else:
            self.entries = associate_tum(seq_dir)
        self.rgb = ImageStream([os.path.join(seq_dir, e[1]) for e in self.entries])
        self.depth = ImageStream([os.path.join(seq_dir, e[2]) for e in self.entries],
                                 gray=False)

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        for (ts, _, _), img, d in zip(self.entries, self.rgb, self.depth):
            yield ts, img, d.astype(np.float32)


class KittiStereo(_Sequence):
    """KITTI odometry grayscale stereo (`stereo_kitti.cc` LoadImages:
    image_0/image_1 numbered pngs + times.txt)."""
    _streams = ("left", "right")

    def __init__(self, seq_dir: str):
        self.dir = seq_dir
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.timestamps = [float(x) for x in f.read().split()]
        n = len(self.timestamps)
        self.left = ImageStream([os.path.join(seq_dir, "image_0", f"{i:06d}.png")
                                 for i in range(n)])
        self.right = ImageStream([os.path.join(seq_dir, "image_1", f"{i:06d}.png")
                                  for i in range(n)])

    def __len__(self):
        return len(self.timestamps)

    def __iter__(self):
        for ts, l, r in zip(self.timestamps, self.left, self.right):
            yield ts, l, r


class KittiMonocular(KittiStereo):
    def __iter__(self):
        for ts, l in zip(self.timestamps, self.left):
            yield ts, l


def _euroc_cam(seq_dir: str, cam: str):
    entries = []
    with open(os.path.join(seq_dir, "mav0", cam, "data.csv")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            ts_ns, fname = line.strip().split(",")[:2]
            entries.append((int(ts_ns) * 1e-9,
                            os.path.join(seq_dir, "mav0", cam, "data", fname)))
    return entries


class EurocStereo(_Sequence):
    """EuRoC MAV stereo (`stereo_euroc.cc`): mav0/cam0|cam1/data.csv +
    data/<ts>.png, the pairs matched by timestamp (within 3 ms). EuRoC
    images are unrectified; pass a `geometry.rectify.StereoRectifier`
    (built from the settings YAML's LEFT./RIGHT. blocks, as the reference
    does at startup) to rectify each pair on the fly."""
    _streams = ("left", "right")

    def __init__(self, seq_dir: str, rectifier=None):
        self.rectifier = rectifier
        cam0, cam1 = _euroc_cam(seq_dir, "cam0"), _euroc_cam(seq_dir, "cam1")
        cam1_ts = np.array([t for t, _ in cam1])
        self.entries = []
        for ts, p0 in cam0:
            i = int(np.argmin(np.abs(cam1_ts - ts)))
            if abs(cam1_ts[i] - ts) < 0.003:
                self.entries.append((ts, p0, cam1[i][1]))
        self.left = ImageStream([e[1] for e in self.entries])
        self.right = ImageStream([e[2] for e in self.entries])

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        for (ts, _, _), l, r in zip(self.entries, self.left, self.right):
            if self.rectifier is not None:
                l, r = self.rectifier(l, r)
            yield ts, l, r


class EurocMonocular(_Sequence):
    """EuRoC cam0-only sequence (`mono_euroc.cc` LoadImages)."""
    _streams = ("stream",)

    def __init__(self, seq_dir: str):
        entries = _euroc_cam(seq_dir, "cam0")
        self.timestamps = [t for t, _ in entries]
        self.stream = ImageStream([p for _, p in entries])

    def __len__(self):
        return len(self.timestamps)

    def __iter__(self):
        for ts, img in zip(self.timestamps, self.stream):
            yield ts, img


if __name__ == "__main__" and sys.argv[1:] == ["--decode-worker"]:
    _serve()
