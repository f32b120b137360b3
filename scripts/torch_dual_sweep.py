"""Time the two tile shapes of the port's bf16 dual 1×1 kernel on one CUDA card.

  python scripts/torch_dual_sweep.py [--repeats N]

Run from the repository root. The shipped launcher, `daclip_dual_conv1x1`,
picks its tile shape by itself. So this script builds a second, small library
from `daclip_torch/csrc/pointwise.cu` (into the ignored build directory) whose
one entry point launches the tile shape it is told: Small, 64 rows × 64
outputs with the weights resident, or Large, 256 × 128 with the weights
streamed. For each bf16 shape of chip_smoke.py's DUAL_SHAPES and
TRAIN_DUAL_SHAPES, in the single form (y = x·w), it prints one JSON line:
for Small, Large, the launcher (`dual_conv1x1`) and `torch.matmul` on the same
operands, the device time per call (torch.profiler, 10 calls) as the median,
least and most of N repeats taken in turn; each tile shape's max error over
the plain version's max and whether a second call gives the same bytes. A tile
shape the card cannot launch at a shape (resident weights past K = 1024)
prints its cudaError_t. The last line names the card and its power limit.
"""
import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from daclip_torch.ops import _build  # noqa: E402
from daclip_torch.ops import pointwise as pw  # noqa: E402

HARNESS = r"""
#include "pointwise.cu"

// y = x·w with tile shape Large (large != 0) or Small.
extern "C" int sweep_dual(const void* x, const void* w, void* y, int R, int K, int O, int large,
                          void* stream) {
  int dev = 0, sms = 0;
  const cudaError_t err = current_sms(dev, sms);
  if (err != cudaSuccess) return (int)err;
  auto st = (cudaStream_t)stream;
  return large ? launch_wgmma<tc::Large>(x, nullptr, w, y, R, K, 0, O, dev, sms, st)
               : launch_wgmma<tc::Small>(x, nullptr, w, y, R, K, 0, O, dev, sms, st);
}
"""


def harness():
    """The sweep's library, built from the checkout's pointwise.cu."""
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "sweep_dual.cu", out / "libsweep_dual.so"
    src.write_text(HARNESS)
    # -fno-gnu-unique: else the launchers' once-a-device caches (static locals
    # of inline functions) are one object across both libraries, and the
    # kernel library would skip the shared-memory opt-in of its own kernels
    build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique",
                            "-shared", "-I", str(_build.CSRC), str(src), "-o", str(lib)],
                           capture_output=True, text=True)
    if build.returncode != 0:
        sys.exit(f"torch_dual_sweep: nvcc failed:\n{build.stdout}{build.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.sweep_dual.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dll.sweep_dual.restype = ctypes.c_int
    return dll


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    repeats = ap.parse_args().repeats
    if not torch.cuda.is_available():
        sys.exit("torch_dual_sweep: no CUDA device")
    dll = harness()
    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = [(R, cx + cs_, O) for R, cx, cs_, O, dtype in cs.DUAL_SHAPES + cs.TRAIN_DUAL_SHAPES
              if dtype == torch.bfloat16]
    for R, K, O in shapes:
        x = torch.randn(R, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(K, O, generator=gen, device="cuda") * K ** -0.5).to(torch.bfloat16)
        want = pw.dual_conv1x1_reference(x.float(), None, w.float())

        def tile(large):
            y = torch.empty((R, O), dtype=x.dtype, device=x.device)
            err = dll.sweep_dual(x.data_ptr(), w.data_ptr(), y.data_ptr(), R, K, O, large,
                                 torch.cuda.current_stream().cuda_stream)
            return err, y

        row = dict(shape=[R, K, O])
        calls = {"launcher": lambda: pw.dual_conv1x1(x, None, w),
                 "matmul": lambda: torch.matmul(x, w)}
        for name, large in (("small", 0), ("large", 1)):
            err, got = tile(large)
            if err:
                row[f"{name}_cuda_error"] = err
                continue
            torch.cuda.synchronize()
            row[f"{name}_max_rel_err"] = cs.rel_err(got, want)
            row[f"{name}_repeats_bitwise"] = torch.equal(got, tile(large)[1])
            calls[name] = lambda large=large: tile(large)
        times = {name: [] for name in calls}
        for _ in range(repeats):  # in turn, so that a drift of the clocks hits each alike
            for name, fn in calls.items():
                times[name].append(cs.device_ms(fn, "" if name == "matmul"
                                                else "daclip::pointwise::"))
        for name, ts in times.items():
            ts = [t for t in ts if t is not None]
            row[f"{name}_device_ms"] = dict(median=float(np.median(ts)), least=min(ts),
                                            most=max(ts), n=len(ts))
        row["launcher_over_matmul"] = (row["launcher_device_ms"]["median"]
                                       / row["matmul_device_ms"]["median"])
        cs.emit(**row)
        del x, w, want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
