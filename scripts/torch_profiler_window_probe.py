"""How often a torch.profiler window around a few small CUDA calls records
no kernel at all, with and without host time padded inside the window
before and after the calls (as `chip_smoke.profiled` pads it).

Each round opens one window per pad setting, in turn, around ten calls of
SDPA at the Wild-IR UNet's training-step site (B 16, 256 tokens, 16 heads
of 32, bf16), and counts the windows that hold no device kernel and the
runs of three such windows in a row (what fails chip_smoke's `device_ms`
before its retakes grew a pad). Then 100 unpadded windows that also record
the host's ops give how long after the window's first op the first kernel
starts, and how long before its last op the last one ends.

Usage (on a machine with a CUDA card): python scripts/torch_profiler_window_probe.py [--rounds 400]
Prints the card's name and power limit, then one JSON line.
"""
import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

PADS = {"none": (0.0, 0.0), "after_5ms": (0.0, 0.005), "both_5ms": (0.005, 0.005),
        "both_20ms": (0.02, 0.02)}


def window(fn, before, after, iters=10, host=False):
    """The kernels one window records around `iters` calls of `fn`, and
    with `host` the gaps between them and the window's own op."""
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        time.sleep(before)
        with record_function("calls"):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        time.sleep(after)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    out = dict(kernels=len(kernels))
    calls = [e for e in events if e.name == "calls" and e.device_type != DeviceType.CUDA]
    if host and calls and kernels:
        out["first_kernel_after_us"] = (min(e.time_range.start for e in kernels)
                                        - calls[0].time_range.start)
        out["last_kernel_before_us"] = (calls[0].time_range.end
                                        - max(e.time_range.end for e in kernels))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=400)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    q, k, v = [torch.randn(16, 16, 256, 32, device="cuda", dtype=torch.bfloat16)
               for _ in range(3)]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
    sdpa()
    torch.cuda.synchronize()
    stats = {name: dict(windows=0, empty=0, runs_of_3=0) for name in PADS}
    streak = dict.fromkeys(PADS, 0)
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        for name, (before, after) in PADS.items():
            empty = window(sdpa, before, after)["kernels"] == 0
            stats[name]["windows"] += 1
            stats[name]["empty"] += empty
            streak[name] = streak[name] + 1 if empty else 0
            stats[name]["runs_of_3"] += streak[name] == 3
    gaps = [window(sdpa, 0.0, 0.0, host=True) for _ in range(100)]
    kept = [g for g in gaps if "first_kernel_after_us" in g]
    print(json.dumps(dict(
        torch=torch.__version__, rounds=args.rounds, seconds=time.perf_counter() - t0,
        pads=stats, host_windows=len(gaps), host_windows_empty=len(gaps) - len(kept),
        first_kernel_after_us_min=min((g["first_kernel_after_us"] for g in kept), default=None),
        last_kernel_before_us_min=min((g["last_kernel_before_us"] for g in kept),
                                      default=None))))


if __name__ == "__main__":
    main()
