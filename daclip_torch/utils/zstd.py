"""ctypes binding of the native zstd decoder (`daclip_torch/native/zstd.cc`).

Zstandard frames are how orbax's tensorstore stores a checkpoint: every
OCDBT manifest and B-tree node body, and every zarr chunk written with the
default `{"id": "zstd"}` compressor. The decoder is the whole of RFC 8878
but dictionaries, written from the format alone, so reading a checkpoint
needs no compression library; `crc32c` checks OCDBT's footers.

The library is built at first use with g++ into `daclip_torch/native/build/`
as `data/native_io`'s decoder is (`native_io.build_library`); a build that
fails raises `NativeLibraryError`. The calls release the GIL (ctypes), so
threads decode chunks at once. Every malformed or truncated input raises
`ZstdError`, and nothing of its output is returned.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from daclip_torch.data import native_io

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "zstd.cc")
_MSG_LEN = 256

_lock = threading.Lock()
_lib = None


class ZstdError(ValueError):
    """A zstd input that is malformed, truncated or of another size than
    expected."""


def load(path: Optional[str] = None):
    """The loaded library, built first when it is not there. `path` loads
    that file instead of the build (a sanitizer build, say)."""
    global _lib
    with _lock:
        if _lib is not None and path is None:
            return _lib
        path = path or native_io.build_library(_SRC, "libzstd_dec")
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise native_io.NativeLibraryError(f"cannot load {path}: {e}") from e
        lib.dz_decompress.restype = ctypes.c_int64
        lib.dz_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                      ctypes.c_size_t, ctypes.c_char_p]
        lib.dz_content_size.restype = ctypes.c_int64
        lib.dz_content_size.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p]
        lib.dz_crc32c.restype = ctypes.c_uint32
        lib.dz_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.dz_msg_len.restype = ctypes.c_int
        if lib.dz_msg_len() != _MSG_LEN:
            raise native_io.NativeLibraryError(
                f"{path}: message length {lib.dz_msg_len()} != {_MSG_LEN}")
        _lib = lib
        return lib


def _pointer(data) -> tuple:
    """(address, length, keep-alive) of a bytes-like input."""
    view = memoryview(data).cast("B")
    if isinstance(data, bytes):
        return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value, len(data), data
    buf = (ctypes.c_char * len(view)).from_buffer_copy(view) if view.readonly else \
        (ctypes.c_char * len(view)).from_buffer(view)
    return ctypes.addressof(buf), len(view), buf


def content_size(data) -> Optional[int]:
    """The sum of the frames' content sizes, or None when a frame does not
    state its size."""
    lib = load()
    ptr, n, keep = _pointer(data)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    r = lib.dz_content_size(ptr, n, msg)
    del keep
    if r == -2:
        raise ZstdError(f"zstd: {msg.value.decode(errors='replace')}")
    return None if r < 0 else int(r)


def _run(lib, data, address: int, cap: int) -> int:
    ptr, n, keep = _pointer(data)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    r = lib.dz_decompress(ptr, n, address, cap, msg)
    del keep
    if r == -1:
        raise ZstdError(f"zstd: {msg.value.decode(errors='replace')}")
    return int(r)


def decompress_into(data, out: torch.Tensor) -> torch.Tensor:
    """Decodes `data` (every frame) into the contiguous CPU tensor `out`,
    whose byte size must be the decoded size exactly."""
    if out.device.type != "cpu" or not out.is_contiguous():
        raise ValueError("decompress_into takes a contiguous CPU tensor")
    cap = out.numel() * out.element_size()
    got = _run(load(), data, out.data_ptr(), cap)
    if got != cap:
        raise ZstdError(f"zstd: decoded {'more than' if got < 0 else got} bytes, "
                        f"{cap} expected")
    return out


def decompress(data, limit: int = 1 << 30) -> bytes:
    """Decodes `data` (every frame) to bytes. The output is sized by the
    frames' content sizes when they state them, else grown up to `limit`
    bytes; a larger output raises."""
    lib = load()
    size = content_size(data)
    if size is not None and size > limit:
        raise ZstdError(f"zstd: content size {size} exceeds the limit {limit}")
    cap = size if size is not None else min(limit, max(4 * len(data), 1 << 16))
    while True:
        out = torch.empty(max(cap, 1), dtype=torch.uint8)
        got = _run(lib, data, out.data_ptr(), cap)
        if got >= 0:
            return out[:got].numpy().tobytes()
        if size is not None or cap >= limit:
            raise ZstdError(f"zstd: decoded output exceeds {cap} bytes")
        cap = min(limit, cap * 4)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a bytes-like input."""
    ptr, n, keep = _pointer(data)
    r = int(load().dz_crc32c(ptr, n))
    del keep
    return r
