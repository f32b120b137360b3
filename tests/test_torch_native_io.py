"""The port's native decoder (daclip_torch/native/dio.cc through
daclip_torch/data/native_io.py) on the CPU: its PNG unfilter against
png.py's numpy rows, PNG and baseline-JPEG decodes and crops against
cv2.imdecode(IMREAD_UNCHANGED) then crop, bit for bit, files outside its set
raising ValueError and read through `read_img` as cv2 reads them, probe /
decode / decode_batch against daclip_tpu's native_io, read_imgs_cropped's
arrays and windows against daclip_tpu's, seeded mutants of well-formed
files (each decodes or raises ValueError), the packaging of the decoder's
source, and a build that cannot run."""
import fnmatch
import io
import os
import random
import re
import tomllib

import cv2
import numpy as np
import pytest
from PIL import Image

from daclip_torch.data import native_io, png
from daclip_torch.data import util as tutil
from daclip_tpu.data import native_io as jnio
from daclip_tpu.data import util as jutil
from scripts import torch_fuzz_native_io as fuzz
from tests.test_torch_data import _encode_png


def _picture(rng, h, w, c=3):
    """uint8 image of smooth waves under noise, as a photograph gives a
    JPEG encoder."""
    yy, xx = np.mgrid[:h, :w]
    waves = (np.sin(xx[..., None] / 7.0 + np.arange(c)) * np.cos(yy[..., None] / 5.0) + 1) / 2
    img = (0.6 * waves + 0.4 * rng.rand(h, w, c)) * 255
    return img.astype(np.uint8)


def _cv2(data: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return img[:, :, None] if img.ndim == 2 else img


def _crops(W, H):
    """Full, interior, edge, 1 × 1, last column and last row windows."""
    return [(0, 0, W, H), (W // 3, H // 4, max(1, W // 2), max(1, H // 2)),
            (W // 2, H // 2, W - W // 2, H - H // 2), (0, 0, 1, 1), (W - 1, H - 1, 1, 1),
            (W - 1, 0, 1, H), (0, H - 1, W, 1)]


def _assert_equals_cv2(data: bytes, what: str):
    want = _cv2(data)
    H, W = want.shape[:2]
    assert native_io.probe(data) == (W, H, 3 if want.shape[2] == 3 else 1), what
    for x0, y0, cw, ch in _crops(W, H):
        got = native_io.decode(data, crop=(x0, y0, cw, ch))
        np.testing.assert_array_equal(got, want[y0:y0 + ch, x0:x0 + cw],
                                      err_msg=f"{what} crop {(x0, y0, cw, ch)}")
    np.testing.assert_array_equal(native_io.decode(data), want, err_msg=what)


def _assert_read_img_equals_cv2(tmp_path, data: bytes, name: str):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = (want[:, :, None] if want.ndim == 2 else want[:, :, :3]).astype(np.float32) / 255.0
    np.testing.assert_array_equal(tutil.read_img(None, path), want, err_msg=name)


# -- (a) the C unfilter against png.py's numpy rows ------------------------------------------
@pytest.mark.parametrize("bpp", range(1, 9))
def test_unfilter_equals_numpy_rows(bpp):
    """Seeded rows of widths 1-64 pixels, each filter type alone and mixed,
    the C unfilter equal to png.py's plain rows; an unknown type raises."""
    rng = np.random.RandomState(bpp)
    for width in range(1, 65):
        for kinds in ([0] * 3, [1] * 3, [2] * 3, [3] * 3, [4] * 3, [4, 3, 1, 2, 0, 4]):
            rows = rng.randint(0, 256, (len(kinds), 1 + width * bpp)).astype(np.uint8)
            rows[:, 0] = kinds
            np.testing.assert_array_equal(native_io.unfilter(rows, bpp),
                                          png._unfilter_rows(rows, bpp, "x"),
                                          err_msg=f"bpp {bpp} width {width} {kinds}")
    rows = rng.randint(0, 256, (3, 1 + 4 * bpp)).astype(np.uint8)
    rows[:, 0] = [1, 5, 0]
    with pytest.raises(ValueError, match="row 1 has unknown PNG filter type 5"):
        native_io.unfilter(rows, bpp)
    with pytest.raises(ValueError, match="x.png: row 1 has unknown PNG filter type 5"):
        png._unfilter(rows, bpp, "x.png")


# -- (b) PNG ---------------------------------------------------------------------------------
PNG_SIZES = [(1, 1), (7, 9), (67, 45), (17, 250)]


@pytest.mark.parametrize("h,w", PNG_SIZES)
def test_png_decode_and_crops_equal_cv2(h, w):
    """Every row filter (png.encode's one-filter files and cv2's adaptive
    ones), 1/2/4/8-bit gray, palette at every depth, RGB, Adam7 or not, at
    odd sizes: the whole image and each window equal cv2's array, cropped."""
    rng = np.random.RandomState(h * 1000 + w)
    for c in (1, 3):
        img = _picture(rng, h, w, c)
        for filt in png.FILTERS:
            _assert_equals_cv2(png.encode(img, filt), f"{filt} {h}x{w}x{c}")
        _assert_equals_cv2(cv2.imencode(".png", img)[1].tobytes(), f"cv2 {h}x{w}x{c}")
    for interlace in (0, 1):
        for depth in (1, 2, 4, 8):
            s = rng.randint(0, 2 ** depth, (h, w, 1))
            _assert_equals_cv2(_encode_png(s, depth, 0, interlace=interlace),
                               f"gray {depth} interlace {interlace}")
            plte = rng.randint(0, 256, (2 ** depth, 3))
            _assert_equals_cv2(_encode_png(s, depth, 3, plte, interlace=interlace),
                               f"palette {depth} interlace {interlace}")
        _assert_equals_cv2(_encode_png(rng.randint(0, 256, (h, w, 3)), 8, 2,
                                       interlace=interlace), f"rgb interlace {interlace}")


def _outside_png_set(rng, h, w):
    """PNGs outside the native set: 16-bit, alpha, a tRNS palette, tRNS keys."""
    rgb = _picture(rng, h, w)
    out = {"16_gray.png": _encode_png(rng.randint(0, 65536, (h, w, 1)), 16, 0),
           "16_rgb.png": _encode_png(rng.randint(0, 65536, (h, w, 3)), 16, 2, interlace=1),
           "la.png": _encode_png(rng.randint(0, 256, (h, w, 2)), 8, 4),
           "rgba.png": cv2.imencode(".png", np.dstack([rgb, rgb[:, :, :1]]))[1].tobytes()}
    for name, im, kw in (("p_trns.png", Image.fromarray(rgb).quantize(16), {"transparency": 3}),
                         ("rgb_key.png", Image.fromarray(rgb),
                          {"transparency": tuple(int(v) for v in rgb[0, 0])}),
                         ("gray_key.png", Image.fromarray(rgb[:, :, 0]),
                          {"transparency": int(rgb[0, 0, 0])})):
        buf = io.BytesIO()
        im.save(buf, "PNG", **kw)
        out[name] = buf.getvalue()
    return out


def test_png_outside_the_set_raises_and_reads_as_cv2(tmp_path):
    """16-bit, alpha and tRNS files raise ValueError (or equal cv2), and
    `read_img` gives cv2's array of them."""
    for name, data in _outside_png_set(np.random.RandomState(3), 13, 11).items():
        try:
            got = native_io.decode(data)
        except ValueError as e:
            assert "outside the native decoder's set" in str(e), name
        else:
            np.testing.assert_array_equal(got, _cv2(data), err_msg=name)
        _assert_read_img_equals_cv2(tmp_path, data, name)
    with pytest.raises(ValueError, match="CRC"):
        data = png.encode(np.zeros((4, 4, 3), np.uint8))
        native_io.decode(data[:20] + bytes([data[20] ^ 1]) + data[21:])
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        native_io.decode(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="window"):
        native_io.decode(png.encode(np.zeros((4, 4, 3), np.uint8)), crop=(2, 0, 3, 4))


# -- (c) JPEG --------------------------------------------------------------------------------
JPEG_SIZES = [(1, 1), (7, 9), (67, 45), (250, 17), (17, 250), (512, 512)]
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _jpegs(rng, h, w, qualities=(30, 75, 95, 100)):
    """{name: bytes} written by cv2 and PIL: each quality at 4:4:4, 4:2:2,
    4:2:0 and 4:4:0 (cv2) and 4:4:4, 4:2:2, 4:2:0 (PIL), gray, with a restart
    interval, with optimised Huffman tables, with their own chroma quality."""
    out = {}
    for q in qualities:
        img = _picture(rng, h, w)
        for name, sf in SAMPLING.items():
            out[f"cv2_q{q}_{name}"] = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf])[1].tobytes()
        for sub in (0, 1, 2):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=q, subsampling=sub)
            out[f"pil_q{q}_sub{sub}"] = buf.getvalue()
        out[f"gray_q{q}"] = cv2.imencode(".jpg", img[:, :, 0],
                                         [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()
        out[f"rst_q{q}"] = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes()
        out[f"gray_rst_q{q}"] = cv2.imencode(".jpg", img[:, :, 1], [
            cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL, 3])[1].tobytes()
        out[f"optimize_q{q}"] = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]])[1].tobytes()
        out[f"chroma_q{q}"] = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_CHROMA_QUALITY, 20])[1].tobytes()
    return out


@pytest.mark.parametrize("h,w", JPEG_SIZES)
def test_jpeg_decode_and_crops_equal_cv2(h, w):
    """Baseline JPEGs from cv2 and PIL (every quality, sampling, gray,
    restarts, optimised tables) decode, whole and in each window, to cv2's
    array, bit for bit: the islow IDCT, fancy upsampling and libjpeg's
    YCbCr tables."""
    rng = np.random.RandomState(h * 1000 + w)
    for name, data in _jpegs(rng, h, w).items():
        _assert_equals_cv2(data, f"{name} {h}x{w}")


def _outside_jpeg_set(rng):
    img = _picture(rng, 24, 20)
    base = cv2.imencode(".jpg", img)[1].tobytes()
    sof = base.index(b"\xff\xc0")
    arithmetic = base[:sof + 1] + b"\xc9" + base[sof + 2:]  # SOF9: arithmetic coding
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    return {"progressive.jpg": cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
            .tobytes(),
            "411.jpg": cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1]
            .tobytes(),
            "arithmetic.jpg": arithmetic, "cmyk.jpg": buf.getvalue()}


def test_jpeg_outside_the_set_raises_and_reads_as_cv2(tmp_path):
    """Progressive, arithmetic-coded, 4:1:1 and CMYK files raise ValueError,
    and `read_img` gives cv2's array of them."""
    for name, data in _outside_jpeg_set(np.random.RandomState(4)).items():
        with pytest.raises(ValueError, match="outside the native decoder's set"):
            native_io.decode(data)
        _assert_read_img_equals_cv2(tmp_path, data, name)
    data = cv2.imencode(".jpg", _picture(np.random.RandomState(5), 40, 40))[1].tobytes()
    with pytest.raises(ValueError, match="malformed"):
        native_io.decode(data[:len(data) // 2])
    _assert_read_img_equals_cv2(tmp_path, data, "baseline.jpg")


# -- (d) against daclip_tpu's native_io --------------------------------------------------------
@pytest.mark.skipif(not jnio.available(), reason="daclip_tpu's native decoder does not build "
                    "here (g++ with libjpeg and libpng headers)")
def test_probe_decode_and_batch_equal_jax_native_io():
    """On JPEGs and 8-bit PNGs without tRNS (daclip_tpu's decoder refuses
    other depths), where it and cv2 agree: probe, decode (whole and in
    windows) and decode_batch at 1 and 4 threads equal daclip_tpu's."""
    rng = np.random.RandomState(6)
    datas = list(_jpegs(rng, 67, 45, (75,)).values())
    img = _picture(rng, 45, 38)
    datas += [png.encode(img, "paeth"), png.encode(img[:, :, 0], "average"),
              _encode_png(rng.randint(0, 256, (45, 38, 1)), 8, 3, rng.randint(0, 256, (256, 3)),
                          interlace=1)]
    crops = []
    for data in datas:
        assert native_io.probe(data) == jnio.probe(data)
        W, H, _ = jnio.probe(data)
        for crop in _crops(W, H)[:3]:
            np.testing.assert_array_equal(native_io.decode(data, crop=crop),
                                          jnio.decode(data, crop=crop))
        crops.append(_crops(W, H)[1])
    for threads in (1, 4):
        for got, want in zip(native_io.decode_batch(datas, crops, threads=threads),
                             jnio.decode_batch(datas, crops, threads=threads)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(native_io.decode_batch(datas, threads=threads),
                             jnio.decode_batch(datas, threads=threads)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="batch item 1"):
        native_io.decode_batch([datas[0], _encode_png(np.zeros((4, 4, 1)), 16, 0)])


# -- (e) read_imgs_cropped -------------------------------------------------------------------
def _pair_tree(root, rng):
    """GT/LQ pairs: baseline JPEGs, PNGs with Paeth rows, one pair that
    starts with a 16-bit PNG and one progressive JPEG (both read the other
    way), one smaller than the patch."""
    pairs = []
    for i, (kind, h, w) in enumerate([("jpg", 70, 90), ("png", 64, 80), ("jpg", 50, 66),
                                      ("png16", 60, 72), ("progressive", 66, 70),
                                      ("png", 30, 40)]):
        paths = []
        for sub in ("GT", "LQ"):
            img = _picture(rng, h, w)
            path = root / f"{i}_{sub}.{'png' if kind.startswith('png') else 'jpg'}"
            if kind == "jpg":
                data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
            elif kind == "progressive":
                data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
            elif kind == "png16" and sub == "GT":
                data = _encode_png(rng.randint(0, 65536, (h, w, 3)), 16, 2)
            else:
                data = png.encode(img, "paeth")
            path.write_bytes(data)
            paths.append(str(path))
        pairs.append(paths)
    return pairs


def test_read_imgs_cropped_equals_jax_on_jpeg_and_png(tmp_path):
    """From one random.Random seed, the port's read_imgs_cropped gives
    daclip_tpu's arrays and windows on every pair (native, read the other
    way after the draw, smaller than the patch), and leaves the stream
    where daclip_tpu's leaves it."""
    pairs = _pair_tree(tmp_path, np.random.RandomState(7))
    r1, r2 = random.Random(11), random.Random(11)
    for _ in range(2):
        for paths in pairs:
            imgs, win = tutil.read_imgs_cropped(paths, 48, r1)
            jimgs, jwin = jutil.read_imgs_cropped(paths, 48, r2)
            assert win == jwin, paths
            for a, b in zip(imgs, jimgs):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b, err_msg=str(paths))
    assert r1.random() == r2.random()


# -- malformed files ---------------------------------------------------------------------------
FUZZ_CORPUS = fuzz.corpus(0)


@pytest.mark.parametrize("name", sorted(FUZZ_CORPUS))
def test_mutated_files_decode_or_raise(name):
    """Seeded mutants of a well-formed file (a byte flipped or set in SOF,
    DHT, DQT, DRI, SOS or the scan of a JPEG, in IHDR, PLTE or IDAT of a PNG
    with its CRC fixed or stale, in a PNG's inflated rows, or the file cut
    short) decode, whole and in a window, to an array of the header's size or
    raise ValueError, in decode and in decode_batch; a header far larger than
    its data (above cv2's size limit, or within it over a few hundred bytes)
    raises ValueError. scripts/torch_fuzz_native_io.py runs the same
    mutations, more of them, under AddressSanitizer."""
    data = FUZZ_CORPUS[name]
    rng = np.random.RandomState(sorted(FUZZ_CORPUS).index(name))
    seen = {"decoded": 0, "refused": 0}
    bad = fuzz.mutants(data, rng, 60)
    for what, mutant in bad:
        seen[fuzz.check_one(mutant, rng)] += 1
    assert seen["refused"] > 0, seen
    for threads in (1, 4):
        try:
            outs = native_io.decode_batch([m for _, m in bad[:16]], threads=threads)
        except ValueError as e:
            assert "batch item" in str(e)
        else:
            assert all(o.dtype == np.uint8 for o in outs)
    for what, mutant in fuzz.oversized(data).items():
        with pytest.raises(ValueError, match="size limit|too short|truncated"):
            native_io.decode(mutant)


# -- (f) the build -----------------------------------------------------------------------------
def test_a_build_that_cannot_run_raises(monkeypatch, tmp_path):
    """With the compiler missing and no built library, every decode raises
    NativeLibraryError naming the command; nothing falls back to png.py's rows
    or to cv2. dio.cc includes no image library."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_io, "_CXX", str(tmp_path / "no-such-g++"))
    data = png.encode(np.zeros((4, 4, 3), np.uint8), "paeth")
    path = tmp_path / "x.png"
    path.write_bytes(data)
    assert not native_io.available()
    for call in (lambda: native_io.decode(data), lambda: png.decode(data),
                 lambda: tutil.read_img(None, str(path)),
                 lambda: tutil.read_imgs_cropped([str(path)], 2, random.Random(0))):
        with pytest.raises(native_io.NativeLibraryError, match="no-such-g"):
            call()
    src = open(native_io._SRC).read()
    assert set(re.findall(r"#include\s*[<\"]([^>\"]+)[>\"]", src)) <= {
        "pthread.h", "zlib.h", "cstdarg", "cstdint", "cstdio", "cstdlib", "cstring", "new",
        "vector"}


def test_a_missing_source_or_build_directory_raises_native_build_error(monkeypatch, tmp_path):
    """An installed copy without dio.cc, or a build directory that cannot be
    made, raises NativeLibraryError naming it, not a bare OSError."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_SRC", str(tmp_path / "dio.cc"))
    with pytest.raises(native_io.NativeLibraryError, match="cannot read the decoder's source"):
        native_io.load()
    monkeypatch.undo()
    monkeypatch.setattr(native_io, "_lib", None)
    (tmp_path / "file").write_text("")
    monkeypatch.setattr(native_io, "_BUILD_DIR", str(tmp_path / "file" / "build"))
    with pytest.raises(native_io.NativeLibraryError, match="cannot build into"):
        native_io.load()


def test_package_data_ships_the_decoder_source():
    """pyproject's package data for daclip_torch takes dio.cc and the CUDA
    sources, which an installed copy builds from at first use."""
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "pyproject.toml"),
              "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["daclip_torch"]
    package = os.path.dirname(os.path.dirname(native_io.__file__))
    sources = [native_io._SRC] + [os.path.join(package, "csrc", n)
                                  for n in os.listdir(os.path.join(package, "csrc"))
                                  if n.endswith((".cu", ".cuh"))]
    for path in sources:
        rel = os.path.relpath(path, package).replace(os.sep, "/")
        assert any(fnmatch.fnmatch(rel, g) and g.count("/") == rel.count("/") for g in globs), \
            (rel, globs)
