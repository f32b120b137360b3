"""PNG decode and encode with the stdlib's zlib and numpy: the PNG half of
`cv2.imread` / `cv2.imwrite`, for machines without cv2 or PIL.

`decode` returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns for
every valid (colour type, bit depth) pair, interlaced (Adam7) or not: uint8,
or uint16 for a 16-bit file; a 2-D array for gray (1, 2 and 4-bit gray
scaled to 0-255, as libpng expands it), BGR for colour, BGRA where the file
has alpha (gray+alpha gives four channels, the gray value in each of B, G
and R), palette images at any depth expanded to BGR, or to BGRA when a tRNS
chunk gives the palette alpha; a tRNS colour key on a truecolour image
becomes an alpha channel too (0 or the depth's maximum), as libpng's
`tRNS_to_alpha` makes it, and a gray one is dropped.
`decode_with_mode` also gives the mode PIL opens the file in ("1" for 1-bit
gray, "L", "I;16" for 16-bit gray, "RGB", "P", "LA", and "RGBA" for RGBA
and for 16-bit gray+alpha; a tRNS chunk changes no mode), which decides how
PIL resizes it.

Row filters work on bytes, the left neighbour `max(1, channels·depth/8)`
bytes back. None and Up are one operation a row, Sub a per-byte-of-pixel
`np.cumsum(..., dtype=np.uint8)` (a sum modulo 256). Average and Paeth take
the pixel to their left, already unfiltered, so they loop over the row's
pixels, each step vectorised across the pixel's bytes; they are far slower
than the others (PERF.md records the cost per filter).

`encode` writes 8-bit gray, BGR or BGRA (colour types 0, 2 and 6) with one
filter for every row: "none", "sub", "up", "average" or "paeth" (no
adaptive choice).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
PIL_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes, name: str):
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8: pos + 8 + length]
        if len(body) != length:
            break
        crc, = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG ends before its IEND chunk")


def _paeth_row(d: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Undo Paeth on one row of (pixels, bytes a pixel): out[x] = d[x] +
    paeth(out[x-1], up[x], up[x-1]). pa = |b - c| needs no left pixel, so it
    is taken for the row at once; pb = |a - c| and pc = |a - c + b - c| per
    pixel."""
    W = d.shape[0]
    b = up.astype(np.int16)
    c = np.zeros_like(b)
    c[1:] = b[:-1]
    bc = b - c
    pa = np.abs(bc)
    d = d.astype(np.int16)
    out = np.empty_like(d)
    out[0] = (d[0] + b[0]) & 0xFF        # a = c = 0: the predictor is b
    for x in range(1, W):
        ac = out[x - 1] - c[x]
        pb = np.abs(ac)
        pc = np.abs(ac + bc[x])
        pred = np.where((pa[x] <= pb) & (pa[x] <= pc), out[x - 1],
                        np.where(pb <= pc, b[x], c[x]))
        out[x] = (d[x] + pred) & 0xFF
    return out.astype(np.uint8)


def _average_row(d: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Undo Average on one row of (pixels, bytes a pixel):
    out[x] = d[x] + (out[x-1] + up[x]) // 2."""
    W = d.shape[0]
    b = up.astype(np.int16)
    d = d.astype(np.int16)
    out = np.empty_like(d)
    out[0] = (d[0] + (b[0] >> 1)) & 0xFF
    for x in range(1, W):
        out[x] = (d[x] + ((out[x - 1] + b[x]) >> 1)) & 0xFF
    return out.astype(np.uint8)


def _unfilter(rows: np.ndarray, bpp: int, name: str) -> np.ndarray:
    """(H, 1 + rowbytes) filtered rows → (H, rowbytes) bytes; a pixel is
    `bpp` bytes, the unit the filters' left neighbour steps by."""
    H = rows.shape[0]
    out = np.empty((H, rows.shape[1] - 1), np.uint8)
    prev = np.zeros((out.shape[1] // bpp, bpp), np.uint8)
    for y in range(H):
        kind = int(rows[y, 0])
        d = rows[y, 1:].reshape(-1, bpp)
        if kind == 0:
            cur = d
        elif kind == 1:
            cur = np.cumsum(d, axis=0, dtype=np.uint8)
        elif kind == 2:
            cur = d + prev              # uint8 arithmetic wraps modulo 256
        elif kind == 3:
            cur = _average_row(d, prev)
        elif kind == 4:
            cur = _paeth_row(d, prev)
        else:
            raise ValueError(f"{name}: row {y} has unknown PNG filter type {kind}")
        out[y] = cur.reshape(-1)
        prev = out[y].reshape(-1, bpp)
    return out


def _rowbytes(W: int, C: int, depth: int) -> int:
    return (W * C * depth + 7) // 8


def _samples(rows: np.ndarray, W: int, C: int, depth: int) -> np.ndarray:
    """(h, rowbytes) unfiltered bytes → (h, W, C) samples: uint16 for 16-bit,
    else uint8 (sub-byte samples unpacked, most significant bits first, not
    scaled)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, W, C)
    if depth == 8:
        return rows.reshape(h, W, C)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :W * C].reshape(h, W, C)


def _image_data(raw: np.ndarray, W: int, H: int, C: int, depth: int, interlace: int,
                name: str) -> np.ndarray:
    """The decompressed IDAT stream → (H, W, C) samples; an Adam7 file's
    passes are unfiltered one by one, each at its own width, and scattered."""
    bpp = max(1, C * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.zeros((H, W, C), dtype) if interlace else None
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        n = ph * (_rowbytes(pw, C, depth) + 1)
        if raw.size < pos + n:
            raise ValueError(f"{name}: PNG image data is truncated")
        rows = _unfilter(raw[pos:pos + n].reshape(ph, -1), bpp, name)
        pos += n
        sub = _samples(rows, pw, C, depth)
        if not interlace:
            return sub
        img[y0::dy, x0::dx] = sub
    return img


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes → array as `cv2.imread(..., IMREAD_UNCHANGED)` gives it."""
    return decode_with_mode(data, name)[0]


def decode_with_mode(data: bytes, name: str = "<bytes>"):
    """(`decode`'s array, the PIL mode of the file)."""
    if not is_png(data):
        raise ValueError(f"{name}: not a PNG file (bad signature)")
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and not kind[0] & 0x20:
            raise ValueError(f"{name}: unknown critical PNG chunk {kind!r}")
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} is not valid")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{name}: PNG colour type {ctype} at bit depth {depth} is not valid")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: PNG interlace method {interlace} is not valid")
    C = _CHANNELS[ctype]
    mode = PIL_MODES[ctype]
    img = _image_data(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8),
                      W, H, C, depth, interlace, name)
    top = (1 << depth) - 1              # the depth's maximum sample

    if ctype == 0:                     # gray; a tRNS key is dropped, as cv2 does
        if depth < 8:                   # libpng's expansion: ×255, ×85 or ×17
            img = img * np.uint8(255 // top)
        mode = {1: "1", 16: "I;16"}.get(depth, mode)
        return img[:, :, 0], mode
    if ctype == 2:
        bgr = img[:, :, ::-1]
        if trns is None:
            return np.ascontiguousarray(bgr), mode
        key = np.asarray(struct.unpack(">HHH", trns[:6]), np.int64)
        alpha = np.where((img == key).all(axis=2), 0, top).astype(img.dtype)
        return np.concatenate([bgr, alpha[:, :, None]], axis=2), mode
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG has no PLTE chunk")
        idx = img[:, :, 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette index out of range")
        bgr = palette[idx][:, :, ::-1]
        if trns is None:
            return np.ascontiguousarray(bgr), mode
        lut = np.full(256, 255, np.uint8)
        lut[:len(trns)] = np.frombuffer(trns, np.uint8)
        return np.concatenate([bgr, lut[idx][:, :, None]], axis=2), mode
    if ctype == 4:                     # gray + alpha → B = G = R = gray, A
        return np.ascontiguousarray(img[:, :, [0, 0, 0, 1]]), "RGBA" if depth == 16 else mode
    return np.ascontiguousarray(img[:, :, [2, 1, 0, 3]]), mode   # RGBA → BGRA


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(img: np.ndarray, kind: int) -> np.ndarray:
    """(H, W, C) uint8 → (H, W·C) filtered bytes, one filter for every row."""
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        upleft = np.zeros_like(x)
        upleft[1:, 1:] = x[:-1, :-1]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((x - pred) & 0xFF).astype(np.uint8).reshape(img.shape[0], -1)


def encode(img: np.ndarray, filter: str = "up", level: int = 6) -> bytes:
    """uint8 gray (H, W) or (H, W, 1), BGR or BGRA → PNG bytes, each row
    filtered with `filter` (a key of FILTERS)."""
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encode takes uint8, got {img.dtype}")
    if filter not in FILTERS:
        raise ValueError(f"PNG encode filter must be one of {sorted(FILTERS)}, got {filter!r}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"PNG encode takes gray, BGR or BGRA, got shape {img.shape}")
    H, W, C = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[C]
    rgb = img[:, :, [2, 1, 0, 3][:C]] if C > 1 else img
    kind = FILTERS[filter]
    rows = np.concatenate([np.full((H, 1), kind, np.uint8), _filter_rows(rgb, kind)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray, filter: str = "up", level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode(img, filter, level))
