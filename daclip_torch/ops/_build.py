"""Build and bind the hand-written CUDA kernels in `daclip_torch/csrc/`.

Every `*.cu` source is compiled by `nvcc` into its own object, all at once,
and the objects are linked into one shared library with a plain C interface
(no PyTorch headers), loaded with `ctypes`. The library lives in
`daclip_torch/csrc/build/`, named by a hash of the sources and flags, so a
checkout builds once at first use and rebuilds only when a source changes.

Nothing here runs at import: `library()` is called by a kernel wrapper the
first time it launches on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
# C signatures of the exported launchers; each returns a cudaError_t
SIGNATURES = {
    # x, g_pre, w_qkv, part_m, part_s, part_ctx, B, n, C, rows, is_bf16, stream
    "daclip_wrap_stats": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # part_m, part_s, part_ctx, w_attn, ctx|null, s|null, m|null, B, n_parts, n,
    # is_bf16, stream
    "daclip_wrap_combine": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, g_pre, w_qkv, w_attn, w_out, b_out, g_out, out, B, n, C, is_bf16, stream
    "daclip_wrap_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, dout, g_pre, w_qkv, w_attn, w_out, b_out, g_out, dy_spill, attn_spill,
    # part_dw, part_dgout, part_dbout, B, n, C, rows, is_bf16, stream
    "daclip_wrap_bwd1": [_P] * 13 + [_I, _I, _I, _I, _I, _P],
    # part_dw, ctx, s, dctx, ds, B, n_parts, n, is_bf16, stream
    "daclip_wrap_bwd_mid": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, dout, g_pre, w_qkv, w_attn, w_out, dctx, ds, m, dy_spill, dx, xn_spill,
    # dqkv_spill, part_dgpre, B, n, C, rows, is_bf16, stream
    "daclip_wrap_bwd2": [_P] * 14 + [_I, _I, _I, _I, _I, _P],
    # a, b, part, R, K1, K2, rows_per_split, splits, is_bf16, stream
    "daclip_wrap_wgrad": [_P, _P, _P, _L, _I, _I, _L, _I, _I, _P],
    # xn, w_qkv, w_out, b_out, g_out, part_m, part_s, part_ctx, w_attn, out,
    # B, n, C, rows, is_bf16, stream
    "daclip_linattn_fused_v4": [_P] * 10 + [_I, _I, _I, _I, _I, _P],
    # qkv, part_m, part_s, part_ctx, w_attn, out, B, n, rows, is_bf16, stream
    "daclip_linattn_core": [_P] * 6 + [_I, _I, _I, _I, _P],
    # x, skip|null, w, y, R, Kx, Ks, O, is_bf16, stream
    "daclip_dual_conv1x1": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # x, w, y, B, H, W, C, O, is_bf16, stream
    "daclip_conv3x3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, lse|null, B, N, H, D, scale, is_bf16, stream
    "daclip_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, o, dout, lse, dsum, dq, dk, dv, B, N, H, D, scale, is_bf16, stream
    "daclip_flash_bwd": [_P] * 10 + [_I, _I, _I, _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = pathlib.Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels of daclip_torch "
                           "are built from source at first use and need the "
                           "CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(target: pathlib.Path) -> None:
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    cus = sorted(CSRC.glob("*.cu"))
    objs = [tmp / (cu.stem + ".o") for cu in cus]
    # one nvcc per source, all started together
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for cu, o in zip(cus, objs)]
    logs = [p.communicate()[0] for p in procs]
    for cu, p, log in zip(cus, procs, logs):
        (tmp / (cu.stem + ".log")).write_text(log)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu.name}:\n{log}")
    lib_tmp = tmp / target.name
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(lib_tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (BUILD_DIR / (target.stem + ".log")).write_text("\n".join(logs))
    os.replace(lib_tmp, target)  # atomic: other processes see all or nothing
    shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libdaclip_kernels-{_digest()}.so"
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
