"""Time the port's bf16 flash kernels (forward #2, backward #4) on one CUDA
card beside an older checkout's build of the same kernels.

  python scripts/torch_flash_hopper.py --parent DIR

It builds the kernel library, prints the flash kernels' `ptxas -v` lines and
ptxas's advisories on them, then prints, per shape, the device time
(chip_smoke.device_ms: CUDA events around ten calls queued behind a sleep)
of the forward (keeping the lse at B = 16, as training does) and of the
backward with its kernels' split (torch.profiler), of SDPA (forward, and
backward through autograd), and of the kernels built from DIR (a checkout's
`daclip_torch/ops` and `daclip_torch/csrc`, e.g. `git archive` of the
parent commit: launchers of the same C signatures) in the order parent,
this, this, parent. One JSON line per reading, each with the card's name
and power limit. chip_smoke.py holds these kernels against their plain
versions; this script only times them.
"""
import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (its helpers; main() does not run)
from daclip_torch.ops import _build  # noqa: E402

# (B, N, H, D): serve, train, Wild-IR, shard_tiles and the backward's shapes
FWD_SHAPES = [(1, 1024, 8, 32), (1, 1024, 16, 32), (16, 1024, 8, 32), (16, 1024, 16, 32),
              (1, 256, 8, 32), (1, 256, 16, 32), (16, 256, 8, 32), (16, 256, 16, 32),
              (8, 2304, 16, 32), (4, 2304, 8, 32)]
BWD_SHAPES = [(16, 1024, 8, 32), (16, 1024, 16, 32), (16, 256, 8, 32), (16, 256, 16, 32),
              (2, 1000, 4, 64)]


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def build():
    lib = _build.library()
    log = pathlib.Path(lib._name).with_suffix(".log")
    lines = [ln for ln in cs.ptxas_summary(log.read_text() if log.exists() else "")
             if ln.startswith(("flash::", "flash_bwd::"))]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    emit(phase="build", nvcc=nvcc, ptxas=lines)
    advisories = [ln for ln in log.read_text().splitlines()
                  if "flash" in ln and ("C75" in ln or "arning" in ln)] if log.exists() else []
    emit(phase="advisories", lines=advisories[:40])
    return lib


def fwd_call(lib, q, k, v, H, D, lse=True):
    """The forward launcher of `lib` on (q, k, v)."""
    B, N, _ = q.shape
    out = torch.empty_like(q)
    l = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if lse else None
    _build.check(lib.daclip_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if l is None else l.data_ptr(), B, N, H, D, D ** -0.5, 1,
        torch.cuda.current_stream().cuda_stream), "daclip_flash_fwd")
    return out, l


def bwd_call(lib, q, k, v, out, dout, lse, H, D):
    B, N, _ = q.shape
    dsum = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, N, H, D, D ** -0.5, 1]
    _build.check(lib.daclip_flash_bwd(*args, torch.cuda.current_stream().cuda_stream),
                 "daclip_flash_bwd")
    return dq, dk, dv


def inputs(B, N, H, D, seed, n=4):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, N, H * D, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(n)]


def parent_lib(root):
    spec = importlib.util.spec_from_file_location(
        "parent_build", pathlib.Path(root) / "daclip_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # -fno-gnu-unique: else a launcher's once-a-device shared memory opt-in
    # (a static local of a template both libraries hold) is shared, and the
    # second library's kernels launch without theirs
    mod.NVCC_FLAGS = [*mod.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique"]
    return mod.library()


def profile_split(fn, iters=10):
    """Device ms a call of each kernel that `fn` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][-60:]: e.device_time_total / iters / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def sdpa_fwd(q, k, v, H, D):
    B, N, _ = q.shape
    heads = lambda t: t.view(B, N, H, D).transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(heads(q), heads(k), heads(v))


def time_all(lib, plib, card):
    for i, (B, N, H, D) in enumerate(FWD_SHAPES):
        q, k, v = inputs(B, N, H, D, 50 + i, 3)
        row = dict(phase="time_fwd", shape=[B, N, H, D], card=card,
                   exp_floor_ms=B * H * N * N / cs.EXP_PER_S * 1e3,
                   bound_ms=cs.bound_ms(4 * B * N * H * D * 2, 4 * B * H * N * N * D,
                                        torch.bfloat16)[0])
        train = B == 16  # the training step keeps the lse
        new = lambda: fwd_call(lib, q, k, v, H, D, lse=train)
        old = lambda: fwd_call(plib, q, k, v, H, D, lse=train)
        for name, fn in (("parent", old), ("this", new), ("this", new), ("parent", old)):
            row.setdefault(name, []).append(cs.device_ms(fn, "daclip::flash::"))
        row["sdpa"] = cs.device_ms(sdpa_fwd(q, k, v, H, D), "")
        emit(**row)
    for i, (B, N, H, D) in enumerate(BWD_SHAPES):
        q, k, v, dout = inputs(B, N, H, D, 70 + i)
        out, lse = fwd_call(lib, q, k, v, H, D)
        row = dict(phase="time_bwd", shape=[B, N, H, D], card=card,
                   exp_floor_ms=2 * B * H * N * N / cs.EXP_PER_S * 1e3,
                   bound_ms=cs.bound_ms(8 * B * N * H * D * 2, 10 * B * H * N * N * D,
                                        torch.bfloat16)[0])
        new = lambda: bwd_call(lib, q, k, v, out, dout, lse, H, D)
        old = lambda: bwd_call(plib, q, k, v, out, dout, lse, H, D)
        for name, fn in (("parent", old), ("this", new), ("this", new), ("parent", old)):
            row.setdefault(name, []).append(cs.device_ms(fn, "daclip::flash_bwd::"))
        row["split"] = profile_split(new)
        heads = lambda t: t.view(B, N, H, D).transpose(1, 2)
        qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k, v))
        oh = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
        row["sdpa"] = cs.device_ms(
            lambda: torch.autograd.grad(oh, (qh, kh, vh), heads(dout), retain_graph=True), "")
        emit(**row)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout whose daclip_torch/ops and csrc build the other kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_flash_hopper: no CUDA device")
    card = smi()
    emit(phase="device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    time_all(build(), parent_lib(args.parent), card)
    emit(phase="done")


if __name__ == "__main__":
    main()
