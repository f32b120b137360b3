"""Seeded mutation fuzz of the port's native image decoder
(daclip_torch/native/dio.cc through daclip_torch/data/native_io.py).

Builds dio.cc with AddressSanitizer and UndefinedBehaviorSanitizer, then, in
a child process that preloads the ASan runtime, decodes mutants of a seed
corpus of JPEG and PNG files, whole, in a window and in decode_batch. A
mutant flips or sets a byte inside one named part of a file (JPEG SOF, DHT,
DQT, DRI, SOS and the entropy-coded data; PNG IHDR, PLTE and IDAT, the CRC
fixed or not, and the inflated rows themselves), cuts the file short, or
writes a header far larger than its data. Each must decode to an array of
the size its header gives or raise ValueError; a sanitizer report or a
crash fails the run. tests/test_torch_native_io.py runs the same corpus and
mutations, fewer of them, without the sanitizers.

Usage: python scripts/torch_fuzz_native_io.py [--iterations 20000] [--seed 0]
           [--out DIR]
Needs g++ with libasan and libubsan, zlib's header, cv2 and PIL. Prints one
JSON line of counts.
"""
import argparse
import io
import json
import os
import pathlib
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from daclip_torch.data import native_io, png  # noqa: E402

SANITIZE = ("-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
            "-fno-sanitize-recover=undefined", "-fPIC", "-shared", "-std=c++17")


def _picture(rng, h, w, c=3):
    yy, xx = np.mgrid[:h, :w]
    waves = (np.sin(xx[..., None] / 5.0 + np.arange(c)) * np.cos(yy[..., None] / 3.0) + 1) / 2
    return ((0.6 * waves + 0.4 * rng.rand(h, w, c)) * 255).astype(np.uint8)


def _png(samples, depth, ctype, plte=None, interlace=0):
    """A PNG of `samples` (h, w, c) at any valid depth, rows unfiltered,
    Adam7 or not."""
    H, W, C = samples.shape
    passes = (((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),))
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub.reshape(sub.shape[0], -1):
            bits = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
            raw += b"\0" + np.packbits(bits.reshape(-1)).tobytes()
    out = png.SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                                          0, 0, interlace))
    if plte is not None:
        out += png._chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    return out + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b"")


def corpus(seed: int = 0) -> dict:
    """{name: bytes}: baseline JPEGs (4:2:0, 4:4:4 with restarts, 4:2:2 with
    optimised tables, 4:4:0, gray) and PNGs (every filter, palette, sub-byte
    gray, Adam7) of a few odd sizes."""
    import cv2
    from PIL import Image

    rng = np.random.RandomState(seed)
    img = _picture(rng, 21, 27)
    jpg = lambda im, *kv: cv2.imencode(".jpg", im, list(kv))[1].tobytes()  # noqa: E731
    out = {"jpeg_420": jpg(img, cv2.IMWRITE_JPEG_QUALITY, 75),
           "jpeg_444_rst": jpg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                               cv2.IMWRITE_JPEG_RST_INTERVAL, 1),
           "jpeg_440": jpg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
           "jpeg_gray_rst": jpg(img[:, :, 0], cv2.IMWRITE_JPEG_RST_INTERVAL, 2)}
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90, subsampling=1, optimize=True)
    out["jpeg_422_optimised"] = buf.getvalue()
    out["png_paeth"] = png.encode(img, "paeth")
    out["png_gray_average"] = png.encode(img[:, :, 0], "average")
    out["png_palette_adam7"] = _png(rng.randint(0, 16, (13, 11, 1)), 4, 3,
                                    rng.randint(0, 256, (16, 3)), interlace=1)
    out["png_gray1"] = _png(rng.randint(0, 2, (9, 17, 1)), 1, 0)
    out["png_rgb_adam7"] = _png(rng.randint(0, 256, (10, 9, 3)), 8, 2, interlace=1)
    return out


def _jpeg_parts(data: bytes):
    """[(name, start, end)] of the marker segments' bodies and the
    entropy-coded data."""
    names = {0xC0: "SOF", 0xC1: "SOF", 0xC4: "DHT", 0xDB: "DQT", 0xDD: "DRI", 0xDA: "SOS"}
    parts, pos = [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        m, n = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m in names:
            parts.append((names[m], pos + 4, pos + 2 + n))
        pos += 2 + n
        if m == 0xDA:
            parts.append(("scan", pos, len(data) - 2))
            break
    return parts


def _png_chunks(data: bytes):
    """[(kind, start of length, body start, body end)]."""
    out, pos = [], 8
    while pos + 12 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        out.append((data[pos + 4:pos + 8].decode("latin-1"), pos, pos + 8, pos + 8 + n))
        pos += 12 + n
    return out


def _with_chunk(data: bytes, chunk, body: bytes, crc: bool = True) -> bytes:
    kind, at, b0, b1 = chunk
    new = png._chunk(kind.encode("latin-1"), body)
    if not crc:
        new = new[:-4] + data[b1:b1 + 4]
    return data[:at] + new + data[b1 + 4:]


def mutants(data: bytes, rng, n: int):
    """`n` seeded mutants of one JPEG or PNG file: [(what, bytes)]."""
    out = []
    is_png = data.startswith(png.SIGNATURE)
    parts = ([c for c in _png_chunks(data) if c[0] in ("IHDR", "PLTE", "IDAT")] if is_png
             else _jpeg_parts(data))
    for _ in range(n):
        kind = rng.randint(8)
        if kind == 0:
            cut = int(rng.randint(1, len(data)))
            out.append((f"cut at {cut}", data[:cut]))
            continue
        part = parts[rng.randint(len(parts))]
        if not is_png:
            name, b0, b1 = part
            if b1 <= b0:
                continue
            at = int(rng.randint(b0, b1))
            v = data[at] ^ int(rng.randint(1, 256)) if kind < 6 else (0, 0xFF)[kind % 2]
            out.append((f"{name} byte {at} = {v}", data[:at] + bytes([v]) + data[at + 1:]))
            continue
        name, _, b0, b1 = part
        body = bytearray(data[b0:b1])
        if name == "IDAT" and kind >= 5:  # the inflated rows: filter types and samples
            rows = bytearray(zlib.decompress(bytes(body)))
            at = int(rng.randint(len(rows)))
            rows[at] = int(rng.randint(256)) if kind == 5 else rows[at] ^ 0xFF
            if kind == 7:
                rows = rows[:int(rng.randint(len(rows)))]
            out.append((f"IDAT row byte {at}", _with_chunk(data, part, zlib.compress(bytes(rows)))))
            continue
        if not body:
            continue
        at = int(rng.randint(len(body)))
        body[at] ^= int(rng.randint(1, 256))
        out.append((f"{name} byte {at}, CRC {'fixed' if kind != 1 else 'stale'}",
                    _with_chunk(data, part, bytes(body), crc=kind != 1)))
    return out


def oversized(data: bytes):
    """Headers far larger than their data: {what: bytes}. Every one must
    raise ValueError."""
    out = {}
    if data.startswith(png.SIGNATURE):
        ihdr = _png_chunks(data)[0]
        body = data[ihdr[2]:ihdr[3]]
        for W, H in ((2 ** 31 - 1, 1), (1, 2 ** 31 - 1), (65535, 65535), (30000, 30000)):
            for interlace in (0, 1):
                out[f"IHDR {W}x{H} interlace {interlace}"] = _with_chunk(
                    data, ihdr, struct.pack(">II", W, H) + body[8:12] + bytes([interlace]))
    else:
        name, b0, _ = next(p for p in _jpeg_parts(data) if p[0] == "SOF")
        for W, H in ((65535, 65535), (32768, 32768), (65535, 16384), (8, 65535)):
            out[f"SOF {W}x{H}"] = data[:b0 + 1] + struct.pack(">HH", H, W) + data[b0 + 5:]
    return out


def check_one(data: bytes, rng) -> str:
    """Probe and decode one file, whole and in a seeded window. Returns
    "decoded" or "refused"; anything else than an array of the header's
    size or a ValueError is an error."""
    try:
        W, H, C = native_io.probe(data)
    except ValueError:
        return "refused"
    x0, y0 = int(rng.randint(W)), int(rng.randint(H))
    window = (x0, y0, int(rng.randint(1, W - x0 + 1)), int(rng.randint(1, H - y0 + 1)))
    seen = "refused"
    for crop in (window, None):
        try:
            got = native_io.decode(data, crop=crop)
        except ValueError:
            continue
        want = (H, W, C) if crop is None else (crop[3], crop[2], C)
        if got.shape != want or got.dtype != np.uint8:
            raise AssertionError(f"decoded to {got.shape} {got.dtype}, not {want}")
        seen = "decoded"
    return seen


def _child(lib: str, iterations: int, seed: int) -> dict:
    native_io.load(lib)
    rng = np.random.RandomState(seed)
    seeds = corpus(seed)
    counts = {"decoded": 0, "refused": 0, "oversized_refused": 0, "batches": 0}
    for name, data in seeds.items():
        for what, bad in oversized(data).items():
            try:
                native_io.decode(bad)
            except ValueError:
                counts["oversized_refused"] += 1
            else:
                raise AssertionError(f"{name}: {what} decoded")
    per_file = max(1, iterations // len(seeds))
    for name, data in seeds.items():
        batch = []
        for what, bad in mutants(data, rng, per_file):
            counts[check_one(bad, rng)] += 1
            batch.append(bad)
            if len(batch) == 16:
                try:
                    native_io.decode_batch(batch, threads=4)
                except ValueError:
                    pass
                counts["batches"] += 1
                batch = []
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iterations", type=int, default=20000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="directory for the sanitizer build")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.child, args.iterations, args.seed)))
        return
    out = args.out or tempfile.mkdtemp(prefix="dio_fuzz_")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libdio_sanitized.so")
    subprocess.run(["g++", *SANITIZE, "-o", lib, native_io._SRC, "-lz", "-lpthread"],
                   check=True)
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                          text=True, check=True).stdout.strip()
    env = dict(os.environ, LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1")
    res = subprocess.run([sys.executable, __file__, "--child", lib, "--iterations",
                          str(args.iterations), "--seed", str(args.seed)], env=env)
    sys.exit(res.returncode)


if __name__ == "__main__":
    main()
