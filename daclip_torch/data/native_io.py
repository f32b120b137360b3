"""ctypes binding of the native image decoder (`daclip_torch/native/dio.cc`).

Counterpart of `daclip_tpu/data/native_io.py`, with its API: `available`,
`probe`, `decode`, `decode_file` and `decode_batch`. A `crop` is
`(x0, y0, w, h)`. An image comes back as cv2 gives it, as HWC BGR uint8
for colour and HW1 uint8 for gray: `cv2.imdecode(buf, IMREAD_UNCHANGED)` of
the whole file, then cropped, bit for bit.

`dio.cc` includes zlib and pthread and no image library, so it builds
wherever g++ and zlib's header are. It decodes
  * PNG: 8-bit gray and RGB, palette without tRNS, 1/2/4-bit gray, Adam7
    or not, any filter mix;
  * JPEG: baseline and extended-sequential Huffman (SOF0/SOF1), 8-bit
    samples, 1 or 3 components in one scan with sampling factors 1 or 2
    (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart intervals, any size, YCbCr as
    libjpeg-turbo decodes it (islow IDCT, fancy upsampling).
Any other file (16-bit, alpha or tRNS PNG; progressive, arithmetic,
12-bit, lossless, CMYK or RGB-stored JPEG) raises `ValueError`, and the
caller reads it another way (`data/util.read_img`), as does a header above
cv2's size limit or far larger than its data. A crop decodes only what
the window needs: PNG rows up to its last, JPEG MCUs up to its last and the
IDCT only on its blocks and their upsampling context.

The library is built at first use with `g++ -O3 -fPIC -shared ... -lz
-lpthread` into `daclip_torch/native/build/`, the file named by a hash of
the source, the flags and the compiler's version and published by an
atomic rename, so that processes building at once do not collide. So every
PNG or JPEG read needs g++, zlib's header and a writable build directory.
Nothing is built at import; the CLIs and the serving predictor call `load()`
at start-up, so that no request or step waits on the build. A build or load
that fails (no compiler, no source, a read-only directory) raises
`NativeLibraryError` with the cause; nothing falls back to another decoder for
it. The calls release the
GIL (ctypes), and `decode_batch` decodes on a pthread pool. `calls` counts
the images decoded (`decode`, each item of `decode_batch`) and the
`unfilter` calls, for a caller that checks which path its data took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "dio.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "native", "build")
_CXX = "g++"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_LIBS = ("-lz", "-lpthread")
_MSG_LEN = 256
_ERRORS = {-1: "not a JPEG or PNG file", -2: "outside the native decoder's set",
           -3: "malformed image", -4: "crop window outside the image", -5: "out of memory"}

_lock = threading.Lock()
_lib = None
calls = {"decode": 0, "unfilter": 0}


def _count(key: str, n: int = 1):
    with _lock:
        calls[key] += n


class NativeLibraryError(RuntimeError):
    """The decoder library could not be built or loaded."""


def _run(cmd, what: str):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeLibraryError(f"{' '.join(cmd)} could not run ({what}): {e}") from e


def build_library(src_path: str, stem: str, libs: Sequence[str] = ()) -> str:
    """The path of the shared library g++ builds from `src_path`, building
    it into the build directory when it is not there. The name hashes the
    source, the flags and the compiler's version, so a build directory
    carried to another machine is not taken for its own; the file is
    published by an atomic rename, so processes building at once do not
    collide. Raises `NativeLibraryError` when it cannot build."""
    try:
        with open(src_path, "rb") as f:
            src = f.read()
    except OSError as e:
        raise NativeLibraryError(f"cannot read the decoder's source {src_path}: {e}") from e
    compiler = _run([_CXX, "--version"], "the compiler's version").stdout
    tag = hashlib.sha256(src + " ".join(_FLAGS + tuple(libs)).encode()
                         + compiler.encode()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"{stem}_{tag}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        cmd = [_CXX, *_FLAGS, "-o", tmp, src_path, *libs]
        res = _run(cmd, "the build")
        if res.returncode != 0:
            raise NativeLibraryError(f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    except OSError as e:
        raise NativeLibraryError(f"cannot build into {_BUILD_DIR}: {e}") from e
    return out


def _library_path() -> str:
    """The decoder library's path, building it when it is not there."""
    return build_library(_SRC, "libdio", _LIBS)


def load(path: Optional[str] = None):
    """The loaded library, built first when it is not there. `path` loads
    that file instead of the build (a sanitizer build, say)."""
    global _lib
    with _lock:
        if _lib is not None and path is None:
            return _lib
        path = path or _library_path()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeLibraryError(f"cannot load {path}: {e}") from e
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.dio_probe.restype = ctypes.c_int
        lib.dio_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t, c_int_p, c_int_p, c_int_p,
                                  ctypes.c_char_p]
        lib.dio_decode_crop.restype = ctypes.c_int
        lib.dio_decode_crop.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_char_p]
        lib.dio_batch_decode_crop.restype = None
        lib.dio_batch_decode_crop.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            c_int_p, ctypes.POINTER(ctypes.c_void_p), c_int_p, ctypes.c_char_p, ctypes.c_int]
        lib.dio_png_unfilter.restype = ctypes.c_int
        lib.dio_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.dio_msg_len.restype = ctypes.c_int
        if lib.dio_msg_len() != _MSG_LEN:
            raise NativeLibraryError(f"{path}: message length {lib.dio_msg_len()} != {_MSG_LEN}")
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here (the port's callers do not
    ask: they call, and a build that fails raises)."""
    try:
        load()
    except NativeLibraryError:
        return False
    return True


def _error(rc: int, msg, what: str = "") -> ValueError:
    text = msg.value.decode(errors="replace") if msg is not None else ""
    return ValueError(f"{what}{_ERRORS.get(rc, f'error {rc}')}: {text}")


def probe(data: bytes):
    """(w, h, c) of an encoded JPEG or PNG from its header alone; c is 3 for
    colour, 1 for gray."""
    lib = load()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    rc = lib.dio_probe(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), msg)
    if rc != 0:
        raise _error(rc, msg, "probe: ")
    return w.value, h.value, c.value


def _window(crop, W: int, H: int):
    return (0, 0, W, H) if crop is None else tuple(int(v) for v in crop)


def decode(data: bytes, crop=None) -> np.ndarray:
    """JPEG or PNG bytes → (h, w, 3) BGR or (h, w, 1) gray uint8, of the whole
    image or of the window `crop` = (x0, y0, w, h), equal to cv2's full
    decode then cropped. Raises ValueError for a file outside the decoder's
    set (the caller reads it another way) or a window outside the image."""
    lib = load()
    W, H, C = probe(data)
    x0, y0, cw, ch = _window(crop, W, H)
    if cw < 1 or ch < 1:
        raise ValueError(f"crop window {crop} is empty")
    out = np.empty((ch, cw, C), np.uint8)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    rc = lib.dio_decode_crop(data, len(data), x0, y0, cw, ch, out.ctypes.data, msg)
    if rc < 0:
        raise _error(rc, msg)
    _count("decode")
    return out


def decode_file(path: str, crop=None) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read(), crop=crop)


def decode_batch(datas: Sequence[bytes], crops=None, threads: Optional[int] = None):
    """`decode` of each item (with `crops[i]`), on a pool of `threads`
    pthreads (the CPU count when None) without the GIL. Raises ValueError
    naming the first item that fails."""
    lib = load()
    n = len(datas)
    crops = [None] * n if crops is None else list(crops)
    if len(crops) != n:
        raise ValueError(f"{n} images and {len(crops)} crops")
    params = np.empty((n, 4), np.int32)
    outs = []
    bufs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_size_t * n)(*(len(d) for d in datas))
    ptrs = (ctypes.c_void_p * n)()
    rcs = (ctypes.c_int * n)()
    msgs = ctypes.create_string_buffer(_MSG_LEN * n)
    for i, data in enumerate(datas):
        try:
            W, H, C = probe(data)
        except ValueError as e:
            raise ValueError(f"batch item {i}: {e}") from None
        params[i] = _window(crops[i], W, H)
        if params[i, 2] < 1 or params[i, 3] < 1:
            raise ValueError(f"batch item {i}: crop window {crops[i]} is empty")
        outs.append(np.empty((params[i, 3], params[i, 2], C), np.uint8))
        ptrs[i] = outs[-1].ctypes.data
    lib.dio_batch_decode_crop(n, bufs, lens, params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                              ptrs, rcs, msgs, int(threads or os.cpu_count() or 1))
    for i in range(n):
        if rcs[i] < 0:
            text = msgs.raw[i * _MSG_LEN:(i + 1) * _MSG_LEN].split(b"\0", 1)[0]
            raise ValueError(f"batch item {i}: {_ERRORS.get(rcs[i], rcs[i])}: "
                             f"{text.decode(errors='replace')}")
    _count("decode", n)
    return outs


def unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG rows (h, 1 + rowbytes) uint8, each led by its filter type →
    (h, rowbytes) unfiltered bytes; the left neighbour is `bpp` bytes back.
    Raises ValueError naming the first row with an unknown filter type."""
    lib = load()
    rows = np.ascontiguousarray(rows, np.uint8)
    if rows.ndim != 2 or rows.shape[1] < 1 or bpp < 1:
        raise ValueError(f"unfilter takes (h, 1 + rowbytes) rows and bpp >= 1, got "
                         f"{rows.shape} and {bpp}")
    h, stride = rows.shape
    out = np.empty((h, stride - 1), np.uint8)
    rc = lib.dio_png_unfilter(rows.ctypes.data, h, stride, bpp, out.ctypes.data)
    if rc < 0:
        y = -rc - 1
        raise ValueError(f"row {y} has unknown PNG filter type {int(rows[y, 0])}")
    _count("unfilter")
    return out
