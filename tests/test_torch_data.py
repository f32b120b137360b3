"""daclip_torch's restoration data layer against daclip_tpu's on the CPU: the
PNG codec against cv2, image IO and augmentation, LMDB both ways,
create_lmdb, the noise degradations, the datasets (MDGT's on-the-fly
degradations included) over two epochs of the sampler, the loader's
batches, and the context cache on a tiny DA-CLIP."""
import os
import random
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from daclip_torch.convert import daclip_state_dict_from_jax
from daclip_torch.data import datasets as tds
from daclip_torch.data import degradations as tdeg
from daclip_torch.data import loader as tloader
from daclip_torch.data import png
from daclip_torch.data import util as tutil
from daclip_torch.data.lmdb import LmdbReader as TReader
from daclip_torch.data.lmdb import LmdbWriter as TWriter
from daclip_torch.models.clip import CLIPCfg as TorchCfg
from daclip_torch.models.clip import DaCLIP as TorchDaCLIP
from daclip_torch.models.clip import get_model_config
from daclip_torch.tools.create_lmdb import create_lmdb as t_create_lmdb
from daclip_tpu.data import datasets as jds
from daclip_tpu.data import degradations as jdeg
from daclip_tpu.data import loader as jloader
from daclip_tpu.data import util as jutil
from daclip_tpu.data.lmdb import LmdbReader as JReader
from daclip_tpu.data.lmdb import LmdbWriter as JWriter
from daclip_tpu.tools.create_lmdb import create_lmdb as j_create_lmdb
from tests.test_torch_text import NAME, jax_daclip_params

torch.set_num_threads(1)


def _image(rng, h, w, c):
    """uint8 image that is half noise, half ramps, so an encoder picks
    several row filters."""
    noise = rng.randint(0, 256, (h, w, c))
    yy, xx = np.mgrid[:h, :w]
    ramp = ((yy * 3 + xx * 5) % 256)[:, :, None]
    img = np.where(rng.rand(h, w, 1) < 0.5, ramp, noise).astype(np.uint8)
    return img[:, :, 0] if c == 1 else img


def _row_filters(path):
    """The set of PNG row filter types in a file."""
    data = open(path, "rb").read()
    chunks = list(png._chunks(data, path))
    W, H, _, ctype = struct.unpack(">IIBB", dict(chunks)[b"IHDR"][:10])
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(H, W * png._CHANNELS[ctype] + 1)
    return set(rows[:, 0].tolist())


def _assert_same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


# -- the PNG codec ----------------------------------------------------------------
CV2_CASES = [(h, w, c, level) for h, w, c in [(33, 47, 3), (17, 23, 4), (12, 13, 1),
                                              (1, 9, 3), (9, 1, 3), (1, 1, 4), (31, 5, 1)]
             for level in (0, 1, 9)]


@pytest.mark.parametrize("h,w,c,level", CV2_CASES)
def test_png_decode_equals_cv2_on_files_cv2_writes(tmp_path, h, w, c, level):
    img = _image(np.random.RandomState(h * 31 + w + c), h, w, c)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    _assert_same(png.read(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_cv2_written_files_cover_every_row_filter(tmp_path):
    seen = set()
    for i, (h, w, c, level) in enumerate(CV2_CASES):
        path = str(tmp_path / f"{i}.png")
        cv2.imwrite(path, _image(np.random.RandomState(h * 31 + w + c), h, w, c),
                    [cv2.IMWRITE_PNG_COMPRESSION, level])
        seen |= _row_filters(path)
    assert seen == {0, 1, 2, 3, 4}


def _pil_cases(rng):
    idx = rng.randint(0, 256, (20, 21)).astype(np.uint8)
    palette = list(rng.randint(0, 256, 768))
    p = Image.fromarray(idx, "P")
    p.putpalette(palette)
    yield "P", p, {}
    yield "P+tRNS", p, {"transparency": bytes(rng.randint(0, 256, 100).astype(np.uint8))}
    yield "LA", Image.fromarray(rng.randint(0, 256, (20, 21, 2)).astype(np.uint8), "LA"), {}
    yield ("RGB+tRNS", Image.fromarray(rng.randint(0, 4, (20, 21, 3)).astype(np.uint8), "RGB"),
           {"transparency": (1, 2, 3)})
    yield ("L+tRNS", Image.fromarray(rng.randint(0, 4, (20, 21)).astype(np.uint8), "L"),
           {"transparency": 2})
    yield "RGBA", Image.fromarray(rng.randint(0, 256, (7, 9, 4)).astype(np.uint8), "RGBA"), {}


@pytest.mark.parametrize("case", [c[0] for c in _pil_cases(np.random.RandomState(0))])
def test_png_decode_equals_cv2_on_palette_alpha_and_trns(tmp_path, case):
    name, im, kw = next(c for c in _pil_cases(np.random.RandomState(0)) if c[0] == case)
    path = str(tmp_path / "x.png")
    im.save(path, **kw)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    _assert_same(png.read(path), want)
    # cv2's channel counts: palette → BGR, BGRA with tRNS; gray keeps no alpha
    assert want.shape[2:] == {"P": (3,), "L+tRNS": ()}.get(name, (4,))


@pytest.mark.parametrize("filt", ["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_encode_each_filter_reads_back_in_cv2_and_the_port(tmp_path, filt, c):
    img = _image(np.random.RandomState(c), 19, 23, c)
    path = str(tmp_path / "x.png")
    png.write(path, img, filt)
    assert _row_filters(path) == {png.FILTERS[filt]}
    _assert_same(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    _assert_same(png.read(path), img)


def _patch_ihdr(data, **fields):
    """`data` with IHDR fields replaced (and its CRC redone)."""
    names = ("width", "height", "depth", "ctype", "comp", "filt", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])), **fields)
    body = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


def test_png_interlaced_16_bit_and_corrupt_files_raise(tmp_path):
    """Corrupt files raise, interlaced and 16-bit ones among them (well-formed
    ones decode: test_png_every_layout_equals_cv2_and_pil): a bad CRC, a bad
    signature, image data cut short, a colour type at a depth the spec does
    not allow; and the encoder refuses an unknown filter."""
    path = str(tmp_path / "x16.png")
    cv2.imwrite(path, (np.arange(60, dtype=np.uint16).reshape(6, 10) * 1000))
    data16 = open(path, "rb").read()
    assert png.decode(data16).dtype == np.uint16
    with pytest.raises(ValueError, match="CRC"):
        png.decode(data16[:20] + bytes([data16[20] ^ 1]) + data16[21:])
    data = png.encode(_image(np.random.RandomState(0), 8, 8, 3))
    # Adam7 rows of an 8 × 8 image take more bytes than the file's plain rows
    with pytest.raises(ValueError, match="truncated"):
        png.decode(_patch_ihdr(png.encode(np.zeros((8, 8, 3), np.uint8), "none"),
                               interlace=1), "x.png")
    adam7 = _encode_png(np.zeros((7, 5)), 16, 0, interlace=1)
    raw = zlib.decompress(dict(png._chunks(adam7, "x"))[b"IDAT"])
    with pytest.raises(ValueError, match="truncated"):   # the last pass's row cut short
        png.decode(adam7[:33] + png._chunk(b"IDAT", zlib.compress(raw[:-3])) + _END)
    with pytest.raises(ValueError, match="truncated"):
        png.decode(_patch_ihdr(data16, height=7))
    for depth, ctype in ((16, 3), (4, 2), (2, 4), (1, 6), (12, 0)):
        with pytest.raises(ValueError, match="not valid"):
            png.decode(_patch_ihdr(data, depth=depth, ctype=ctype))
    with pytest.raises(ValueError, match="not valid"):
        png.decode(_patch_ihdr(data, interlace=2))
    with pytest.raises(ValueError, match="CRC"):
        png.decode(data[:20] + bytes([data[20] ^ 1]) + data[21:])
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a" + data[6:])
    with pytest.raises(ValueError, match="filter"):
        png.encode(np.zeros((2, 2, 3), np.uint8), "adaptive")


# -- every PNG layout against cv2 and PIL -------------------------------------------
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_END = png._chunk(b"IEND", b"")


def _pack(samples, depth):
    """(h, w, C) samples → (h, rowbytes) uint8: big-endian for 16-bit,
    sub-byte samples packed from the most significant bits, rows padded."""
    h, w, C = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    per = 8 // depth
    flat = np.zeros((h, -(-w * C // per) * per), np.uint8)
    flat[:, :w * C] = samples.reshape(h, -1)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(flat.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)


def _filter(rows, bpp, first):
    """Filter each row of bytes, row y with filter (first + y) % 5."""
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, paeth]
    kinds = (first + np.arange(len(x))) % 5
    out = np.stack([(x[y] - preds[k][y]) & 0xFF for y, k in enumerate(kinds)])
    return np.concatenate([kinds[:, None], out], axis=1).astype(np.uint8)


def _encode_png(samples, depth, ctype, plte=None, trns=None, interlace=0, first=0):
    """The test's own PNG encoder: any valid (colour type, depth), Adam7 or
    not, with PLTE and tRNS chunks as given."""
    samples = samples.reshape(samples.shape[:2] + (-1,))
    H, W, C = samples.shape
    bpp = max(1, C * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(_filter(_pack(samples[y0::dy, x0::dx], depth), bpp, first).tobytes()
                   for x0, y0, dx, dy in passes if H > y0 and W > x0)
    out = png.SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                                          0, 0, interlace))
    if plte is not None:
        out += png._chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += png._chunk(b"tRNS", trns)
    return out + png._chunk(b"IDAT", zlib.compress(raw)) + _END


_SIZES = ((13, 11), (9, 17), (1, 3), (6, 1), (16, 16))


def _own_case(i, ctype, depth, trns, interlace):
    rng = np.random.RandomState(i)
    h, w = _SIZES[i % len(_SIZES)]
    C = png._CHANNELS[ctype]
    top = 2 ** depth
    s = rng.randint(0, top, (h, w, C))
    plte = key = None
    if ctype == 3:
        plte = rng.randint(0, 256, (top, 3))
        key = bytes(rng.randint(0, 256, max(1, top // 2)).astype(np.uint8))
    elif trns:
        key = struct.pack(">" + "H" * C, *s[0, 0])   # the first pixel's value, keyed out
    return _encode_png(s, depth, ctype, plte, key if trns else None, interlace, first=i)


def _pil_case(i, mode, kw):
    rng = np.random.RandomState(100 + i)
    h, w = _SIZES[i % len(_SIZES)]
    if mode == "1":
        im = Image.fromarray(rng.randint(0, 2, (h, w)).astype(bool))
    elif mode == "I;16":
        im = Image.fromarray(rng.randint(0, 65536, (h, w)).astype(np.uint16), "I;16")
    elif mode == "P":
        im = Image.fromarray(rng.randint(0, 2 ** kw.get("bits", 8), (h, w)).astype(np.uint8),
                             "P")
        im.putpalette(list(rng.randint(0, 256, 768)))
    else:
        a = rng.randint(0, 256, (h, w, len(mode))).astype(np.uint8)
        im = Image.fromarray(a[:, :, 0] if mode == "L" else a, mode)
    buf = __import__("io").BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _cv2_case(i, dtype, c, flags):
    rng = np.random.RandomState(200 + i)
    h, w = _SIZES[i % len(_SIZES)]
    img = rng.randint(0, np.iinfo(dtype).max + 1, (h, w, c)).astype(dtype)
    img = img[:, :, 0] if c == 1 else img
    if flags:
        img = (img > 127).astype(np.uint8) * 255
    ok, buf = cv2.imencode(".png", img, flags)
    assert ok
    return buf.tobytes()


_VALID = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + \
    [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)]
PNG_CASES = (
    [(f"own-c{c}-{d}bit{'-trns' if t else ''}{'-adam7' if il else ''}",
      ("own", c, d, t, il))
     for c, d in _VALID for t in ((False, True) if c in (0, 2, 3) else (False,))
     for il in (0, 1)]
    + [(f"pil-{m}{'-' + '-'.join(f'{k}{v}' for k, v in kw.items()) if kw else ''}",
        ("pil", m, kw))
       for m, kw in [("1", {}), ("L", {}), ("I;16", {}), ("P", {"bits": 1}),
                     ("P", {"bits": 2}), ("P", {"bits": 4}), ("P", {}),
                     ("P", {"bits": 4, "transparency": b"\x00\x80\xff"}),
                     ("L", {"transparency": 3}), ("LA", {}), ("RGB", {}),
                     ("RGB", {"transparency": (1, 2, 3)}), ("RGBA", {})]]
    + [(f"cv2-{np.dtype(t).name}-c{c}{'-bilevel' if f else ''}", ("cv2", t, c, f))
       for t, c, f in [(np.uint8, 1, []), (np.uint16, 1, []), (np.uint8, 3, []),
                       (np.uint16, 3, []), (np.uint8, 4, []), (np.uint16, 4, []),
                       (np.uint8, 1, [cv2.IMWRITE_PNG_BILEVEL, 1])]])


def _png_case(i, spec):
    return {"own": _own_case, "pil": _pil_case, "cv2": _cv2_case}[spec[0]](i, *spec[1:])


@pytest.mark.parametrize("i", range(len(PNG_CASES)), ids=[c[0] for c in PNG_CASES])
def test_png_every_layout_equals_cv2_and_pil(tmp_path, monkeypatch, i):
    """Every (colour type, bit depth) pair of the PNG spec, with and without
    tRNS, Adam7 or not, written by the test's encoder (each row's filter
    cycling through all five), PIL or cv2: `png.decode` gives cv2's
    IMREAD_UNCHANGED array, `decode_with_mode` PIL's mode, `imread_decoded`
    PIL's RGB, alpha and mode, `imread_color` cv2.imread's BGR, and
    `read_img` daclip_tpu's (its cv2 path; its optional native decoder is
    not the oracle)."""
    data = _png_case(i, PNG_CASES[i][1])
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got, mode = png.decode_with_mode(data, path)
    _assert_same(got, want)
    _assert_same(tutil.imread(path), want)
    _assert_same(tutil.imread_color(path), cv2.imread(path))
    with Image.open(path) as im:
        assert mode == im.mode
        pil_mode = im.mode if im.mode in tutil._DECODED_MODES else "RGB"
        alpha = np.asarray(im.getchannel("A")) if pil_mode in ("RGBA", "LA") else None
        rgb = np.asarray(im.convert("RGB"))
    dec = tutil.imread_decoded(path)
    assert dec.mode == pil_mode
    _assert_same(dec.rgb, rgb)
    assert (dec.alpha is None) == (alpha is None)
    if alpha is not None:
        _assert_same(dec.alpha, alpha)
    monkeypatch.setenv("DACLIP_TPU_NATIVE_IO", "0")
    _assert_same(tutil.read_img(None, path), jutil.read_img(None, path))


def test_png_cases_cover_the_spec():
    """The layouts above cover every valid pair, 16-bit, sub-byte, Adam7 and
    tRNS files, and PIL's modes for them."""
    own = {(c, d) for _, (kind, c, d, *_) in PNG_CASES if kind == "own"}
    assert own == set(_VALID) and len(_VALID) == 15
    modes = set()
    for i, (_, spec) in enumerate(PNG_CASES):
        modes.add(png.decode_with_mode(_png_case(i, spec))[1])
    assert modes == {"1", "L", "I;16", "P", "RGB", "LA", "RGBA"}


# -- image IO and augmentation -----------------------------------------------------
@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    """PNGs written by cv2 (gray, BGR, BGRA) of two sizes, and one JPEG."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(5)
    for i, (h, w, c) in enumerate([(40, 36, 3), (40, 36, 3), (40, 36, 1), (29, 31, 4)]):
        cv2.imwrite(str(d / f"{i}.png"), _image(rng, h, w, c))
    cv2.imwrite(str(d / "4.jpg"), _image(rng, 24, 20, 3))
    return d


def test_read_img_equals_jax(img_dir):
    for p in sorted(os.listdir(img_dir)):
        _assert_same(tutil.read_img(None, str(img_dir / p)),
                     jutil.read_img(None, str(img_dir / p)))
    assert tutil.get_paths_from_images(str(img_dir)) == jutil.get_paths_from_images(
        str(img_dir))


def test_read_img_without_cv2_reads_png_and_names_cv2_for_jpeg(img_dir, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *a, **kw)

    monkeypatch.delitem(__import__("sys").modules, "cv2")
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    assert tutil.read_img(None, str(img_dir / "0.png")).shape == (40, 36, 3)
    with pytest.raises(ImportError, match="create_lmdb"):
        tutil.read_img(None, str(img_dir / "4.jpg"))
    with pytest.raises(ImportError, match="cv2"):
        tutil.save_img(np.zeros((4, 4, 3), np.uint8), str(img_dir / "y.jpg"))


@pytest.mark.parametrize("size", [16, 40, 64])
def test_read_imgs_cropped_equals_jax(img_dir, size):
    paths = [str(img_dir / "0.png"), str(img_dir / "1.png")]
    r1, r2 = random.Random(7), random.Random(7)
    for _ in range(3):
        (a, b), win = tutil.read_imgs_cropped(paths, size, r1)
        (ja, jb), jwin = jutil.read_imgs_cropped(paths, size, r2)
        assert win == jwin
        _assert_same(a, ja)
        _assert_same(b, jb)
    assert r1.random() == r2.random()  # one randint pair a call in both


def test_augment_channel_convert_modcrop_equal_jax():
    rng = np.random.RandomState(3)
    imgs = [rng.rand(10, 14, 3).astype(np.float32), rng.rand(10, 14, 3).astype(np.float32)]
    r1, r2 = random.Random(1), random.Random(1)
    for _ in range(8):
        for a, b in zip(tutil.augment(imgs, rng=r1), jutil.augment(imgs, rng=r2)):
            _assert_same(a, b)
    # float32 on widths past and inside the vector lanes, and uint8
    for shape in [(16, 16, 3), (40, 36, 3), (7, 13, 3), (1, 300, 3)]:
        x = rng.rand(*shape).astype(np.float32)
        u = (x * 255).astype(np.uint8)
        if shape[1] % 8 == 0:   # cv2's float tail columns are computed differently
            _assert_same(tutil.channel_convert(3, "gray", [x])[0],
                         jutil.channel_convert(3, "gray", [x])[0])
        _assert_same(tutil.bgr2gray(u), cv2.cvtColor(u, cv2.COLOR_BGR2GRAY))
        _assert_same(tutil.channel_convert(3, "y", [x])[0], jutil.channel_convert(3, "y", [x])[0])
        g = x[:, :, :1]
        _assert_same(tutil.channel_convert(1, "RGB", [g])[0],
                     jutil.channel_convert(1, "RGB", [g])[0])
        for s in (2, 3, 4):
            _assert_same(tutil.modcrop(x, s), jutil.modcrop(x, s))
            _assert_same(tutil.modcrop(x[:, :, 0], s), jutil.modcrop(x[:, :, 0], s))


@pytest.mark.parametrize("scale,antialias", [(0.25, True), (0.5, False), (1 / 3, True),
                                             (2.0, True), (1.5, False)])
def test_imresize_np_equals_jax(scale, antialias):
    x = np.random.RandomState(4).rand(27, 33, 3).astype(np.float32)
    np.testing.assert_allclose(tutil.imresize_np(x, scale, antialias),
                               jutil.imresize_np(x, scale, antialias), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tutil.imresize_np(x[:, :, 0], scale, antialias),
                               jutil.imresize_np(x[:, :, 0], scale, antialias), atol=1e-5,
                               rtol=0)


# -- LMDB ---------------------------------------------------------------------------
def _lmdb_items():
    rng = np.random.RandomState(9)
    items = {f"k{i:05d}": rng.bytes(int(rng.randint(0, 40))) for i in range(2500)}
    items["big"] = rng.bytes(3 * 4096 + 123)       # an overflow chain of 4 pages
    items["edge"] = rng.bytes(2040 - 8 - 4)        # the largest value a leaf holds
    return items


@pytest.mark.parametrize("writer,reader", [(TWriter, JReader), (JWriter, TReader)],
                         ids=["port_writes", "jax_writes"])
def test_lmdb_written_by_one_package_reads_in_the_other(tmp_path, writer, reader):
    items = _lmdb_items()
    with writer(str(tmp_path / "db")) as w:
        for k, v in items.items():
            w.put(k, v)
    env = reader(str(tmp_path / "db"))
    assert env.entries == len(items)
    with env.begin() as txn:
        for k, v in items.items():
            assert bytes(txn.get(k)) == v
    assert env.get("absent") is None
    assert list(env.keys()) == sorted(k.encode() for k in items)
    base = env._page(env._root)
    assert not base[1] & 0x02   # the root is a branch page: a tree of two levels or more
    env.close()
    with open(tmp_path / "db" / "data.mdb", "rb") as f:
        port = f.read()
    other = JWriter if writer is TWriter else TWriter
    with other(str(tmp_path / "db2")) as w:
        for k, v in items.items():
            w.put(k, v)
    with open(tmp_path / "db2" / "data.mdb", "rb") as f:
        assert f.read() == port   # both writers give the same file


def test_create_lmdb_equals_jax(img_dir, tmp_path):
    pngs = tmp_path / "pngs"
    pngs.mkdir()
    for p in sorted(os.listdir(img_dir)):
        if p.endswith(".png"):
            (pngs / p).write_bytes((img_dir / p).read_bytes())
    tk = t_create_lmdb(str(pngs), str(tmp_path / "t" / "db"), verbose=False)
    jk = j_create_lmdb(str(pngs), str(tmp_path / "j" / "db"), verbose=False)
    assert tk == jk
    for name in ("data.mdb", "meta_info.pkl"):
        assert ((tmp_path / "t" / "db" / name).read_bytes()
                == (tmp_path / "j" / "db" / name).read_bytes())
    keys, sizes = tutil.get_image_paths("lmdb", str(tmp_path / "t" / "db"))
    env = tutil.open_lmdb(str(tmp_path / "t" / "db"))
    for k, s in zip(keys, sizes):
        size = [int(v) for v in s.split("_")]
        _assert_same(tutil.read_img(env, k, size), jutil.read_img(None, str(pngs / f"{k}.png")))


# -- noise --------------------------------------------------------------------------
def test_noise_degradations_equal_jax():
    img = np.random.RandomState(2).rand(12, 10, 3).astype(np.float32)
    for fn in ("add_gaussian_noise", "random_add_gaussian_noise", "add_poisson_noise",
               "random_add_poisson_noise"):
        for kw in ({}, {"gray_noise": True} if fn.startswith("add") else {"gray_prob": 1.0},
                   {"rounds": True}, {"clip": False}):
            _assert_same(getattr(tdeg, fn)(img, rng=random.Random(3), **kw),
                         getattr(jdeg, fn)(img, rng=random.Random(3), **kw))


# -- datasets and the loader ----------------------------------------------------------
@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """An MD tree (two types, 3 pairs each, 40 × 36), an LQGT folder pair
    of 3 at 36 × 36 and its LMDBs, all PNG written by cv2."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(11)
    for t in ("noisy", "rainy"):
        for sub in ("GT", "LQ"):
            (root / "md" / t / sub).mkdir(parents=True)
            for i in range(3):
                cv2.imwrite(str(root / "md" / t / sub / f"{i}.png"), _image(rng, 40, 36, 3))
    for sub in ("GT", "LQ"):
        (root / "lqgt" / sub).mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(root / "lqgt" / sub / f"{i:03d}.png"), _image(rng, 36, 36, 3))
        t_create_lmdb(str(root / "lqgt" / sub), str(root / "lmdb" / sub), verbose=False)
    return root


def _dataset_opts(root):
    md = dict(mode="MD", dataroot=str(root / "md"), distortion=["noisy", "rainy"],
              patch_size=16, data_type="img", clip_size=32, seed=5, color="RGB")
    lqgt = dict(mode="LQGT", dataroot_GT=str(root / "lqgt" / "GT"),
                dataroot_LQ=str(root / "lqgt" / "LQ"), patch_size=16, data_type="img",
                clip_size=32, seed=6)
    mdgt = dict(mode="MDGT", dataroot_GT=str(root / "lqgt" / "GT"), patch_size=16,
                color="RGB", clip_size=32, seed=8)
    lmdb = dict(lqgt, dataroot_GT=str(root / "lmdb" / "GT"),
                dataroot_LQ=str(root / "lmdb" / "LQ"), data_type="lmdb")
    return {"MD_train": dict(md, phase="train"), "MD_val": dict(md, phase="val"),
            "LQGT_train": dict(lqgt, phase="train"), "LQGT_test": dict(lqgt, phase="test"),
            "LQGT_lmdb_train": dict(lmdb, phase="train"),
            "LQGT_lmdb_test": dict(lmdb, phase="test"),
            "LQ": dict(mode="LQ", dataroot_LQ=str(root / "lqgt" / "LQ"), clip_size=32),
            "GT_train": dict(mode="GT", dataroot_GT=str(root / "lqgt" / "GT"), phase="train",
                             patch_size=16, sigma=15, clip_size=32, seed=7),
            "MDGT_train": dict(mdgt, phase="train"), "MDGT_val": dict(mdgt, phase="val")}


def _assert_samples_equal(s, j):
    assert s.keys() == j.keys()
    for k in s:
        if k == "LQ_clip":
            np.testing.assert_allclose(s[k], j[k], atol=1e-6, rtol=0)
        elif isinstance(s[k], np.ndarray):
            _assert_same(s[k], j[k])
        else:
            assert s[k] == j[k]


@pytest.mark.parametrize("case", ["MD_train", "MD_val", "LQGT_train", "LQGT_test",
                                  "LQGT_lmdb_train", "LQGT_lmdb_test", "LQ", "GT_train",
                                  "MDGT_train", "MDGT_val"])
def test_dataset_samples_equal_jax_over_two_epochs(trees, case):
    opt = _dataset_opts(trees)[case]
    ours, ref = tds.create_dataset(dict(opt)), jds.create_dataset(dict(opt))
    assert len(ours) == len(ref)
    sampler = tloader.IterSampler(len(ours), ratio=2)
    jsampler = jloader.IterSampler(len(ref), ratio=2)
    for epoch in range(2):
        sampler.set_epoch(epoch)
        jsampler.set_epoch(epoch)
        idx = list(sampler)
        assert idx == list(jsampler)
        for i in idx:
            _assert_samples_equal(ours[i], ref[i])


def test_loader_batches_equal_jax(trees):
    opt = _dataset_opts(trees)["MD_train"]
    ours = tloader.DataLoader(tds.create_dataset(dict(opt)), batch_size=4,
                              sampler=tloader.IterSampler(6, ratio=3), num_workers=0)
    ref = jloader.DataLoader(jds.create_dataset(dict(opt)), batch_size=4,
                             sampler=jloader.IterSampler(6, ratio=3), num_workers=0)
    assert len(ours) == len(ref) == 4
    for epoch in range(2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        n = 0
        for b, jb in zip(ours, ref):
            _assert_samples_equal(b, jb)
            n += 1
        assert n == 4
    # threads give batches of the same shapes and paths from the same sampler
    threaded = tloader.DataLoader(tds.create_dataset(dict(opt)), batch_size=4,
                                  sampler=tloader.IterSampler(6, ratio=3), num_workers=3)
    batches = list(threaded)
    assert [b["GT"].shape for b in batches] == [(4, 16, 16, 3)] * 4


def test_to_device_gives_nchw():
    batch = {"LQ": np.zeros((2, 8, 6, 3), np.float32), "image_context": np.ones((2, 5)),
             "LQ_path": ["a", "b"]}
    out = tloader.to_device(batch, "cpu")
    assert set(out) == {"LQ", "image_context"}
    assert out["LQ"].shape == (2, 3, 8, 6) and out["LQ"].is_contiguous()
    assert out["image_context"].shape == (2, 5)
    assert set(tloader.to_device(batch, "cpu", keys=("LQ",))) == {"LQ"}


def test_mdgt_loader_batches_equal_jax_and_an_unknown_mode_raises(trees):
    """MDGT through the loader at 0 workers (its degradations draw from the
    dataset's one Random), against daclip_tpu's batches."""
    opt = dict(_dataset_opts(trees)["MDGT_train"], lq_cache=2)
    ours = tloader.DataLoader(tds.create_dataset(dict(opt)), batch_size=2,
                              sampler=tloader.IterSampler(3, ratio=2), num_workers=0)
    ref = jloader.DataLoader(jds.create_dataset(dict(opt)), batch_size=2,
                             sampler=jloader.IterSampler(3, ratio=2), num_workers=0)
    for epoch in range(2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for b, jb in zip(ours, ref):
            _assert_samples_equal(b, jb)
    with pytest.raises(NotImplementedError, match="not recognized"):
        tds.create_dataset({"mode": "XY"})


def test_context_cache_equals_jax(trees):
    """`_precompute_contexts` over LQGT's full-image views with a tiny seeded
    DA-CLIP in float32, against daclip_tpu's on the same weights."""
    from daclip_torch.cli.train_restoration import _precompute_contexts as t_pre
    from daclip_tpu.cli.train_restoration import _precompute_contexts as j_pre
    from daclip_tpu.models import CLIPCfg as JaxCfg
    from daclip_tpu.models import DaCLIP as JaxDaCLIP
    import logging

    jparams = jax_daclip_params(use_predictor=False)
    cfg = get_model_config(NAME)
    tmodel = TorchDaCLIP(TorchCfg.from_dict(cfg)).eval()
    tmodel.load_state_dict(daclip_state_dict_from_jax(jparams), strict=True)
    jmodel = JaxDaCLIP(JaxCfg.from_dict(cfg), dtype=jnp.float32)

    @torch.no_grad()
    def t_fn(views):
        x = tloader.to_device({"v": views}, "cpu")["v"]
        return tmodel.encode_image(x, control=True, normalize=True)

    j_fn = jax.jit(lambda v: jmodel.apply({"params": jparams}, v, control=True,
                                          normalize=True, method=jmodel.encode_image))
    opt = dict(_dataset_opts(trees)["LQGT_train"], clip_size=32)
    log = logging.getLogger("test")
    ours = t_pre(tds.create_dataset(dict(opt)), t_fn, log, chunk=2)
    ref = j_pre(jds.create_dataset(dict(opt)), j_fn, log, chunk=2)
    for a, b in ((ours.image_ctx, ref.image_ctx), (ours.text_ctx, ref.text_ctx)):
        assert a.shape == b.shape == (3, 32)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    s, j = ours[1], ref[1]
    assert "LQ_clip" not in s and s.keys() == j.keys()
    _assert_same(s["GT"], j["GT"])
    assert s["image_context"].shape == (32,)
