"""The port's dataset loaders (`utils/datasets.py`) against the JAX
reference's on the same files, its own PNG / PGM / PPM decoder against the
native one, and the DepthMapFactor repair.

Files are written here: by PIL (its encoder picks the Sub and Paeth row
filters), by `chip_smoke.write_png` (every one of the five filters, row by
row, and libpng's adaptive choice) and as binary PGM / PPM. Loaders must give the reference's entries,
timestamps and arrays exactly; the decoder of the port must give the native
library's samples exactly.

DepthMapFactor: the reference's settings give sensor units per metre (TUM:
5000). ORB-SLAM2 inverts it (`Tracking.cc`: mDepthMapFactor =
1.0f/mDepthMapFactor) and scales each depth image by the inverse, so a TUM
PNG value of 5000 is 1 m. The port's `from_yaml` stores the inverse; the
JAX package stores the factor as read and multiplies by it, so there the
same pixel is 2.5e7 m. The test records both.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from orb_slam2_tpu.geometry import rectify as jrectify
from orb_slam2_tpu.ops import stereo as jstereo
from orb_slam2_tpu.utils import config as jconfig
from orb_slam2_tpu.utils import datasets as jds

import chip_smoke
from orb_slam2_tpu_torch.geometry import rectify as trectify
from orb_slam2_tpu_torch.pipeline import frame as tframe
from orb_slam2_tpu_torch.utils import config as tconfig
from orb_slam2_tpu_torch.utils import datasets as tds
from orb_slam2_tpu_torch.utils.synthetic import PlateWorld

torch.set_num_threads(1)


def _smooth(rng, shape, hi):
    """Images with structure, so PIL's encoder picks filters other than None."""
    return (np.cumsum(rng.integers(0, 3, size=shape), axis=1) % (hi + 1))


def _images(rng):
    """(name, writer, array as the decoders should return it (H, W, C))."""
    g8 = _smooth(rng, (37, 53), 255).astype(np.uint8)
    g16 = _smooth(rng, (29, 41), 60000).astype(np.uint16)
    rgb = _smooth(rng, (23, 31, 3), 255).astype(np.uint8)
    rgba = _smooth(rng, (19, 27, 4), 255).astype(np.uint8)
    pal = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=16)
    la = _smooth(rng, (17, 21, 2), 255).astype(np.uint8)
    bits = [Image.fromarray(g8).convert("1")]
    out = [("gray8_pil", lambda p: Image.fromarray(g8).save(p), g8[..., None]),
           ("gray16_pil", lambda p: Image.fromarray(g16).save(p), g16[..., None]),
           ("rgb_pil", lambda p: Image.fromarray(rgb).save(p), rgb),
           ("rgba_pil", lambda p: Image.fromarray(rgba).save(p), rgba[..., :3]),
           ("gray_alpha_pil", lambda p: Image.fromarray(la, "LA").save(p), la[..., :1]),
           ("palette_pil", lambda p: pal.save(p), np.asarray(pal.convert("RGB"))),
           ("gray1_pil", lambda p: bits[0].save(p), np.asarray(bits[0].convert("L"))[..., None])]
    for name, a in (("gray8", g8), ("gray16", g16), ("rgb", rgb)):
        want = a if a.ndim == 3 else a[..., None]
        out.append((f"{name}_filters", lambda p, a=a: chip_smoke.write_png(p, a, "cycle"), want))
        out.append((f"{name}_adaptive",
                    lambda p, a=a: chip_smoke.write_png(p, a, "adaptive"), want))
        for k in range(5):
            out.append((f"{name}_filter{k}",
                        lambda p, a=a, k=k: chip_smoke.write_png(p, a, k), want))
    return out


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    """The native library as the reference's loader leaves it: built from
    native/ where a checkout lacks it (the port's loader only loads)."""
    assert jds._load_native() is not None


def test_native_library_loaded():
    assert tds._load_native() is not None, tds._lib_error
    assert tds.ImageStream([]).decoder == "native"


def test_png_decoder_against_native(rng, tmp_path):
    for name, write, want in _images(rng):
        path = str(tmp_path / f"{name}.png")
        write(path)
        got = tds.decode_png(path)
        s = tds.ImageStream([path], gray=False)
        native = s._next_raw()
        s.close()
        np.testing.assert_array_equal(got, native, err_msg=name)
        np.testing.assert_array_equal(got, want.astype(np.uint16), err_msg=name)


def _unfilter_bytewise(data, height, stride, bpp):
    """The PNG specification's row filters, one byte at a time."""
    out = np.zeros((height + 1, stride + bpp), np.int64)   # a zero row above, bpp zeros left
    for y in range(height):
        k = data[y * (stride + 1)]
        for i in range(stride):
            x = data[y * (stride + 1) + 1 + i]
            a, b, c = out[y + 1, i], out[y, i + bpp], out[y, i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y + 1, i + bpp] = (x + (0, a, b, (a + b) // 2, paeth)[k]) % 256
    return out[1:, bpp:].astype(np.uint8)


@pytest.mark.parametrize("kinds", ["none_sub_up", "all_five", "paeth"])
def test_unfilter_against_bytewise(rng, kinds):
    """The decoder's row-by-row path (None, Sub, Up) and its anti-diagonal
    path (any row Average or Paeth) against the specification's byte loop,
    at several pixel widths and a stride that is not a multiple of bpp."""
    hi = {"none_sub_up": 3, "all_five": 5, "paeth": None}[kinds]
    for height, stride, bpp in ((1, 1, 1), (7, 13, 1), (9, 12, 3), (11, 14, 2), (6, 10, 4),
                                (5, 7, 3)):
        k = (np.full(height, 4) if hi is None else rng.integers(0, hi, height)).astype(np.uint8)
        rows = rng.integers(0, 256, (height, stride), dtype=np.uint8)
        data = np.concatenate([k[:, None], rows], 1).tobytes()
        np.testing.assert_array_equal(tds._unfilter(data, height, stride, bpp),
                                      _unfilter_bytewise(data, height, stride, bpp),
                                      err_msg=f"{kinds} {height}x{stride}/{bpp}")


def _write_pnm(path, a):
    ch = 1 if a.ndim == 2 else 3
    maxv = 65535 if a.dtype == np.uint16 else 255
    body = a.astype(">u2").tobytes() if a.dtype == np.uint16 else a.tobytes()
    with open(path, "wb") as f:
        f.write(f"P{5 if ch == 1 else 6}\n# a comment\n{a.shape[1]} {a.shape[0]}\n{maxv}\n"
                .encode() + body)


def test_pnm_decoder_against_native(rng, tmp_path):
    for name, a in (("g8.pgm", rng.integers(0, 256, (9, 13), dtype=np.uint8)),
                    ("g16.pgm", rng.integers(0, 65536, (7, 11), dtype=np.uint16)),
                    ("c.ppm", rng.integers(0, 256, (6, 5, 3), dtype=np.uint8))):
        path = str(tmp_path / name)
        _write_pnm(path, a)
        got = tds.decode_image(path)
        s = tds.ImageStream([path], gray=False)
        native = s._next_raw()
        s.close()
        np.testing.assert_array_equal(got, native, err_msg=name)
        np.testing.assert_array_equal(got, (a if a.ndim == 3 else a[..., None]), err_msg=name)


def test_stream_python_decoder(rng, tmp_path, monkeypatch):
    """ImageStream without the native library: the port's decoder on its
    threads, in order, the same gray and raw arrays."""
    paths = []
    for i in range(9):
        a = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
        paths.append(str(tmp_path / f"{i:03d}.png"))
        Image.fromarray(a).save(paths[-1])
    native = list(tds.ImageStream(paths, window=3))
    raw = list(tds.ImageStream(paths, gray=False))
    monkeypatch.setattr(tds, "_load_native", lambda: None)
    s = tds.ImageStream(paths, window=3, threads=2)
    assert s.decoder == "python"
    got = list(s)
    s.close()
    assert len(got) == 9
    for a, b in zip(got, native):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tds.ImageStream(paths, gray=False), raw):
        np.testing.assert_array_equal(a, b)


def test_stream_python_decoder_errors(tmp_path, monkeypatch):
    """The port's decoder processes: a file they cannot read raises in the
    reading thread with the decoder's reason, the stream reads on past it,
    and close() ends the processes, also with files still queued."""
    monkeypatch.setattr(tds, "_load_native", lambda: None)
    bad, good = str(tmp_path / "bad.png"), str(tmp_path / "good.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    chip_smoke.write_png(good, a, "adaptive")
    s = tds.ImageStream([bad, str(tmp_path / "missing.png"), good], gray=False)
    with pytest.raises(ValueError, match="not a PNG file"):
        next(s)
    with pytest.raises(ValueError, match="FileNotFoundError"):
        next(s)
    np.testing.assert_array_equal(next(s), a)
    procs = [w.proc for w in s._workers]
    s.close()
    assert all(p.poll() is not None for p in procs)
    s = tds.ImageStream([good] * 20, window=8)
    procs = [w.proc for w in s._workers]
    s.close()
    assert all(p.poll() is not None for p in procs)


def _tum_rgbd(rng, root, n=5):
    seq = root / "tum"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir(parents=True)
    rgb_lines, depth_lines, pairs = ["# rgb"], ["# depth"], []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)).save(
            seq / "rgb" / f"{i}.png")
        Image.fromarray(rng.integers(0, 6000, (16, 20), dtype=np.uint16)).save(
            seq / "depth" / f"{i}.png")
        rgb_lines.append(f"{i * 0.1:.6f} rgb/{i}.png")
        depth_lines.append(f"{i * 0.1 + 0.005:.6f} depth/{i}.png")
        pairs.append(f"{i * 0.1:.6f} rgb/{i}.png {i * 0.1 + 0.005:.6f} depth/{i}.png")
    depth_lines.append(f"{n * 0.1 + 0.5:.6f} depth/0.png")      # no rgb partner
    (seq / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (seq / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (root / "assoc.txt").write_text("\n".join(pairs[::-1]) + "\n")
    return str(seq), str(root / "assoc.txt")


def _same_items(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert len(g) == len(r) and g[0] == r[0]
        for a, b in zip(g[1:], r[1:]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_tum_loaders(rng, tmp_path):
    seq, assoc = _tum_rgbd(rng, tmp_path)
    assert tds.associate_tum(seq) == jds.associate_tum(seq)
    for args in ((seq,), (seq, assoc)):
        t, j = tds.TumRGBD(*args), jds.TumRGBD(*args)
        assert t.entries == j.entries and len(t) == len(j)
        with t:
            _same_items(t, j)
    t, j = tds.TumMonocular(seq), jds.TumMonocular(seq)
    assert t.timestamps == j.timestamps and t.decoder == "native"
    _same_items(t, j)
    t.close()


def test_kitti_loaders(rng, tmp_path):
    seq = tmp_path / "00"
    for cam in ("image_0", "image_1"):
        (seq / cam).mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (12, 20), dtype=np.uint8)).save(
                seq / cam / f"{i:06d}.png")
    (seq / "times.txt").write_text("".join(f"{i * 0.1:.6e}\n" for i in range(4)))
    for tcls, jcls in ((tds.KittiStereo, jds.KittiStereo),
                       (tds.KittiMonocular, jds.KittiMonocular)):
        t, j = tcls(str(seq)), jcls(str(seq))
        assert t.timestamps == j.timestamps
        _same_items(t, j)
        t.close()


def _euroc(rng, root, n=4, hw=(10, 14)):
    for k, cam in enumerate(("cam0", "cam1")):
        d = root / "mav0" / cam / "data"
        d.mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(n):
            ts = 1403636579763555584 + i * 50_000_000 + k * 1000   # cam1 1 us late
            Image.fromarray(rng.integers(0, 256, hw, dtype=np.uint8)).save(d / f"{ts}.png")
            lines.append(f"{ts},{ts}.png")
        (root / "mav0" / cam / "data.csv").write_text("\n".join(lines) + "\n")
    return str(root)


def test_euroc_loaders(rng, tmp_path):
    seq = _euroc(rng, tmp_path)
    t, j = tds.EurocStereo(seq), jds.EurocStereo(seq)
    assert t.entries == j.entries
    _same_items(t, j)
    t, j = tds.EurocMonocular(seq), jds.EurocMonocular(seq)
    assert t.timestamps == j.timestamps
    _same_items(t, j)
    # the rectifier path: a lens with distortion and a rotation, built from
    # the same settings blocks by each package
    yml = tmp_path / "euroc.yaml"
    K = "[20.0, 0.0, 7.0, 0.0, 20.0, 5.0, 0.0, 0.0, 1.0]"
    blocks = []
    for side, d, r in (("LEFT", "[-0.28, 0.07, 0.0002, 0.00002, 0.0]",
                        "[0.9999, -0.0012, 0.0110, 0.0012, 1.0, -0.0005, -0.0110, 0.0005, 0.9999]"),
                       ("RIGHT", "[-0.28, 0.07, -0.0001, 0.0, 0.0]",
                        "[0.9999, -0.0024, 0.0003, 0.0024, 0.9999, -0.0001, -0.0003, 0.0001, 1.0]")):
        blocks.append(f"{side}.height: 10\n{side}.width: 14\n"
                      f"{side}.D: !!opencv-matrix\n   rows: 1\n   cols: 5\n   dt: d\n   data: {d}\n"
                      f"{side}.K: !!opencv-matrix\n   rows: 3\n   cols: 3\n   dt: d\n   data: {K}\n"
                      f"{side}.R: !!opencv-matrix\n   rows: 3\n   cols: 3\n   dt: d\n   data: {r}\n"
                      f"{side}.P: !!opencv-matrix\n   rows: 3\n   cols: 4\n   dt: d\n"
                      f"   data: [19.0, 0.0, 6.5, 0.0, 0.0, 19.0, 5.2, 0.0, 0.0, 0.0, 1.0, 0.0]\n")
    yml.write_text("%YAML:1.0\n" + "".join(blocks))
    assert trectify.StereoRectifier.available(str(yml))
    t = tds.EurocStereo(seq, rectifier=trectify.StereoRectifier.from_settings(str(yml)))
    j = jds.EurocStereo(seq, rectifier=jrectify.StereoRectifier.from_settings(str(yml)))
    _same_items(t, j)
    assert next(iter(tds.EurocStereo(seq, rectifier=trectify.StereoRectifier.from_settings(
        str(yml)))))[1].dtype == np.uint8


def test_depth_map_factor(tmp_path):
    """A 16-bit depth PNG of value 5000 through the port's from_yaml +
    TumRGBD + make_frame_rgbd: every keypoint with depth is at 1.000 m.
    The reference's from_yaml keeps 5000 and its stereo_from_rgbd
    multiplies by it: 2.5e7 m at the same keypoints."""
    fx = 130.0
    world = PlateWorld(fx, fx, 80.0, 60.0, 160, 120, z0=4.0)
    gray = np.clip(np.round(world.render(np.eye(4))), 0, 255).astype(np.uint8)
    seq = tmp_path / "tum"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    Image.fromarray(gray).save(seq / "rgb" / "0.000000.png")
    Image.fromarray(np.full((120, 160), 5000, np.uint16)).save(seq / "depth" / "0.005000.png")
    (seq / "rgb.txt").write_text("0.000000 rgb/0.000000.png\n")
    (seq / "depth.txt").write_text("0.005000 depth/0.005000.png\n")
    yml = tmp_path / "TUM1.yaml"
    yml.write_text(f"%YAML:1.0\nCamera.fx: {fx}\nCamera.fy: {fx}\nCamera.cx: 80.0\n"
                   f"Camera.cy: 60.0\nCamera.width: 160\nCamera.height: 120\n"
                   f"Camera.bf: 40.0\nDepthMapFactor: 5000.0\nORBextractor.nFeatures: 250\n")
    cfg = tconfig.SlamConfig.from_yaml(str(yml), sensor=tconfig.SENSOR_RGBD)
    assert cfg.depth_map_factor == 1.0 / 5000.0
    with tds.TumRGBD(str(seq)) as ds:
        ((ts, img, depth),) = list(ds)
    assert depth.dtype == np.float32 and float(depth.max()) == 5000.0
    f = tframe.make_frame_rgbd(torch.from_numpy(img), torch.from_numpy(depth), cfg)
    d = f.depth.numpy()[f.valid.numpy()]
    assert len(d) > 100 and np.all(np.abs(d - 1.0) <= 1e-6)

    jcfg = jconfig.SlamConfig.from_yaml(str(yml), sensor=jconfig.SENSOR_RGBD)
    assert jcfg.depth_map_factor == 5000.0
    ((_, _, jdepth),) = list(jds.TumRGBD(str(seq)))
    _, jd = jstereo.stereo_from_rgbd(jnp.asarray(f.xy_raw.numpy()), jnp.asarray(f.xy.numpy()),
                                     jnp.asarray(f.valid.numpy()), jnp.asarray(jdepth),
                                     jcfg.bf, jcfg.depth_map_factor)
    jd = np.asarray(jd)[f.valid.numpy()]
    assert np.all(jd == 2.5e7)
