"""Drive the PyTorch/CUDA port (daclip_torch) on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing JSON lines:
  0 device   the card (nvidia-smi name and power limit), torch and CUDA versions
  1 build    nvcc builds daclip_torch/csrc/*.cu (one process per source); no
             instantiation of the linear-attention kernels may spill
  2 kernels  each kernel against its plain PyTorch version at every shape the
             restore path gives it (the wrap also on inputs where the
             attention is as large as the bias, at each shape), the flash
             forward also at the training step's shapes keeping its lse (held
             against torch.logsumexp); the wrap and flash called twice (the
             bytes must repeat);
             times (median of CUDA-event timed calls after warm-up, and the
             device time of the kernels alone from torch.profiler), the bound,
             and for flash the one-call PyTorch yardstick
             (scaled_dot_product_attention, timed here only, event and device)
  2b kernels_alt  the kernels of the UNet's other wirings, each against its
             plain version: linear_attention_fused (v4), attn_wrap_fused (v3,
             with and without prenorm/residual) at the six sites on
             production-like and balanced inputs plus a ragged and an f32
             case; the attention core linear_attention at the six sites (its
             path: one call at each, counted), each linear-attention kernel
             called twice (the bytes must repeat); dual_conv1x1 at the four
             res_conv shapes of the nine sites, both forms, plus ragged and
             f32 cases and five at the bf16 kernel's tile edges, each called
             twice (the bytes must repeat), with torch.matmul as the single
             form's yardstick (event and device); then linear_attention_fused
             and dual_conv1x1's single form at the (v4, pointwise) training
             step's shapes (B=16)
  2c kernels_conv  conv3x3 against its plain version at the 15 shapes of the
             production UNet's 44 3×3 stride-1 convs at 256² (B=1), the three
             largest at B=16, a ragged and an f32 case and four at the bf16
             kernel's tile edges (its path: one call at each, counted), each
             called twice (the bytes must repeat), with cuDNN's conv2d on the
             channels_last view as the yardstick (timed here only); then both
             device times summed over the 44 sites
  3 fixture  the committed golden fixture replayed through the kernels in f32,
             in the default wiring and in (v4, pointwise) and (v3, pointwise)
  4 serve    the production restore path at full width (ViT-B-32 DaCLIP, UNet
             nf=64 ch_mult 1,2,4,8, context 512, bf16, 100 posterior steps) on
             seeded random weights: four requests through DACLIPRestorer, with
             the kernels' launch counts per request
  4b serve_alt  the same weights in (v4, pointwise), (v3, pointwise) and (v5,
             pointwise): one full-width bf16 UNet forward each against the v5
             wiring's (limit: 3× the v5 bf16 forward's own distance from its
             f32 forward), then two 256² requests each with their launch
             counts and a UNet forward profile each; two v5 requests before
             and two after the other wirings are the yardstick in the phase
  4c forward_conv  one full-width bf16 v5 UNet forward with the output of
             each of its 44 3×3 stride-1 Conv2d replaced by conv3x3's (forward
             hooks registered here, not by the package): each site against
             the module's own output, exactly 44 launches, the forward against
             serve_alt's plain one (limit: 3× the v5 bf16 forward's distance
             from its f32 forward)
  5 profile  one sampler step (a UNet forward at 256²): wall time, device
             kernel time by name, by the port's kernel namespaces and that of
             the 3×3 convs (torch.profiler)
  6 kernels_bwd  at every shape of the training step (B=16, 256²; the wrap
             also on balanced inputs), one f32 case each with TF32 off, the
             ragged wrap: the forward as training calls it (keeping the
             backward's statistics) against the plain forward, then each
             backward kernel against its plain backward, every gradient
             relative to its own max (dW_qkv per q/k/v block), flash also
             at N of 65 and 129; the wrap's forward and backward and flash's
             backward called twice (the bytes must repeat); event and device
             times, bounds, for flash the backward of
             scaled_dot_product_attention as the yardstick, and at each wrap
             site its weight-gradient launch (dW_qkv = xnᵀ·dqkv) against an
             f32 matmul and beside torch.matmul(xn.T, dqkv) (timed here only)
  7 train_check  a small UNet (a wrap and a SpatialTransformer) in f32: the
             loss and every parameter gradient through the kernels against
             the same through the plain versions, then 8 AdamW steps on one
             fixed batch and (t, noise) draw must lower the loss
  8 train    the production training step at full width (B=16, 256², nf 64,
             ch_mult 1,2,4,8, context 512, bf16, remat, AdamW + cosine + EMA)
             on seeded weights with the frozen DaCLIP's contexts: 2 warm-up
             and 5 timed steps, kernel calls per step; then a checkpoint
             whose EMA UNet restores a 256² image through DACLIPRestorer
  9 profile_train  torch.profiler over one full-width training step
 10 train_alt  the same step in the (v4, pointwise) wiring: 2 warm-up and 3
             timed steps, peak memory, kernel calls per step, a profile of
             one step
(train_check runs the default wiring, then (v4, pointwise) and (v3, pointwise).)
Then each kernel's device time over its library call's (kernels_vs_library),
the per-kernel summary line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero;
without a CUDA device it exits non-zero before printing any result.
"""
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "parity" / "fixtures" / "e2e"

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

WRAP_SHAPES = [  # (B, n, C, dtype): the six sites at 256² plus a ragged and f32 case
    (1, 65536, 64, torch.bfloat16), (1, 16384, 64, torch.bfloat16),
    (1, 16384, 128, torch.bfloat16), (1, 4096, 128, torch.bfloat16),
    (1, 4096, 256, torch.bfloat16), (2, 3001, 96, torch.bfloat16),
    (1, 1024, 32, torch.float32)]
FLASH_SHAPES = [  # (B, N, H, D, dtype): down3 and mid/up3 at 256², the fixture's mid
    (1, 1024, 8, 32, torch.bfloat16), (1, 1024, 16, 32, torch.bfloat16),
    (1, 256, 2, 32, torch.float32)]
# the training step's forward at down3 and mid/up3 (B=16), keeping the lse
FLASH_TRAIN_SHAPES = [(16, 1024, 8, 32, torch.bfloat16), (16, 1024, 16, 32, torch.bfloat16)]
LIMITS = {("wrap", torch.bfloat16): 0.1, ("wrap", torch.float32): 1e-3,
          # relative to the output's max: the core's output is the attention
          # alone; the 1×1 rounds once to bf16 (half a step is 2^-8 of a value);
          # flash rounds its output once to bf16 as well (read: 2-3e-3 of max on
          # the H100 at every shape, N = 65 to 1024)
          ("flash", torch.bfloat16): 8e-3, ("flash", torch.float32): 1e-5,
          ("core", torch.bfloat16): 2e-2, ("core", torch.float32): 1e-4,
          ("dual", torch.bfloat16): 1e-2, ("dual", torch.float32): 1e-5,
          # the 3×3 conv rounds once to bf16 too; the sums run in another order
          ("conv", torch.bfloat16): 1e-2, ("conv", torch.float32): 1e-5}
# dual_conv1x1 at the res_conv sites of the UNet at 256² (rows = H·W at B=1;
# K = Cx + Cs: the up level's x and its skip, the final block's x and x_skip):
# (rows, Cx, Cs, O) — up3 ×2, up2 ×2, up1 ×2, up0 ×2 and final; a ragged and an
# f32 case; then the bf16 kernel's tile edges: Kx, Ks and O not multiples of 8
# (element copies), a row past 65 tiles with O = 200 (a ragged last panel) and
# a ragged last K slice, 16 K slices (four turns of the ring), one row past a
# tile with an odd O, and K past the 16 slices its 64 × 64 tiles hold resident
# (the 256 × 128 tiles at a narrow O, a ragged last K slice)
DUAL_SHAPES = [(1024, 512, 256, 512, torch.bfloat16), (4096, 256, 128, 256, torch.bfloat16),
               (16384, 128, 64, 128, torch.bfloat16), (65536, 64, 64, 64, torch.bfloat16),
               (3001, 96, 40, 72, torch.bfloat16), (4096, 64, 64, 64, torch.float32),
               (1000, 36, 20, 50, torch.bfloat16), (4161, 64, 40, 200, torch.bfloat16),
               (2048, 512, 512, 96, torch.bfloat16), (65, 24, 16, 33, torch.bfloat16),
               (257, 640, 520, 40, torch.bfloat16)]
# the (v4, pointwise) training step's shapes (B=16, 256²): linear_attention_fused
# at the five (B, n, C) of the six sites, dual_conv1x1's single form at 16× the
# rows of the four res_conv shapes
TRAIN_WRAP_SHAPES = [(16, n, C, dtype) for _, n, C, dtype in WRAP_SHAPES[:5]]
TRAIN_DUAL_SHAPES = [(16 * R, cx, cs, O, dtype) for R, cx, cs, O, dtype in DUAL_SHAPES[:4]]
# the 3×3 stride-1 convs of the production UNet (nf 64, ch_mult 1,2,4,8) at 256²:
# (H = W, C, O, sites), the 15 distinct shapes of its 44 sites (13 at 256², 9 at
# 128², 9 at 64², 13 at 32²)
CONV_SITES = [(256, 64, 64, 8), (256, 128, 64, 4), (256, 64, 3, 1),
              (128, 64, 64, 4), (128, 192, 128, 2), (128, 128, 128, 2), (128, 256, 128, 1),
              (64, 128, 128, 4), (64, 384, 256, 2), (64, 256, 256, 2), (64, 512, 256, 1),
              (32, 256, 256, 4), (32, 256, 512, 1), (32, 512, 512, 6), (32, 768, 512, 2)]
CONV_SITES_PER_FORWARD = 44
# (B, H, W, C, O, dtype): the sites at B=1; the three largest at the training
# batch (other grid sizes, up to 1,048,576 pixels); a ragged bf16 and an f32
# case; then the bf16 kernel's tile edges: W of 65 and 33 (a second, or a
# mostly empty, 64-pixel tile column), odd H, O = 200 (four 64-output tiles,
# the last ragged); C = 96 and 160 on its large tile, C = 520 (a ragged last
# 32-channel slice, K split over a cluster) and 40 on its small one
CONV_SHAPES = ([(1, s, s, C, O, torch.bfloat16) for s, C, O, _ in CONV_SITES]
               + [(16, 256, 256, 64, 64, torch.bfloat16), (16, 256, 256, 128, 64, torch.bfloat16),
                  (16, 32, 32, 768, 512, torch.bfloat16), (2, 37, 45, 6, 72, torch.bfloat16),
                  (2, 33, 40, 64, 48, torch.float32),
                  (4, 67, 65, 96, 200, torch.bfloat16), (2, 37, 33, 160, 200, torch.bfloat16),
                  (1, 31, 33, 520, 200, torch.bfloat16), (2, 9, 65, 40, 72, torch.bfloat16)])
ALT_CONFIGS = {"v4_pointwise": dict(linear_attention="v4", pointwise=True),
               "v3_pointwise": dict(linear_attention="v3", pointwise=True),
               "v5_pointwise": dict(linear_attention="v5", pointwise=True)}
# an alt wiring's bf16 forward may differ from the v5 wiring's by at most this
# many times the v5 bf16 forward's own max distance from its f32 forward
ALT_FORWARD_FACTOR = 3.0
# the backward kernels at the training step's shapes: (B, n, C) of the six
# wrap sites at 256² and B=16 (down0/up0 share a shape), the ragged case, an
# f32 case, and C=512 (the context-free UNet's level 3, the kernel's 32-row
# tiles); flash at down3 and mid/up3, an f32 case, dim_head 64 with a
# ragged N, and N of 65 and 129 at both dim_heads
WRAP_BWD_SHAPES = [
    (16, 65536, 64, torch.bfloat16), (16, 16384, 64, torch.bfloat16),
    (16, 16384, 128, torch.bfloat16), (16, 4096, 128, torch.bfloat16),
    (16, 4096, 256, torch.bfloat16), (2, 3001, 96, torch.bfloat16),
    (2, 4096, 64, torch.float32), (2, 1024, 512, torch.bfloat16)]
FLASH_BWD_SHAPES = [(16, 1024, 8, 32, torch.bfloat16), (16, 1024, 16, 32, torch.bfloat16),
                    (2, 1024, 4, 32, torch.float32), (2, 1000, 4, 64, torch.bfloat16),
                    # the bf16 kernels' tile edges: one key/query past a 64-row tile
                    (2, 65, 4, 32, torch.bfloat16), (2, 129, 4, 32, torch.bfloat16),
                    (2, 65, 4, 64, torch.bfloat16), (2, 129, 4, 64, torch.bfloat16)]
# each gradient's max |kernel − plain| over its own max |plain|, the plain
# backward in f32 on the same inputs; set at about 3× (bf16) and 5× (f32) the
# worst reading of the first H100 runs (0.0063 wrap, 0.0044 flash in bf16,
# balanced inputs included; 1.8e-6 and 9e-7 in f32 with TF32 off)
BWD_LIMITS = {("wrap", torch.bfloat16): 2e-2, ("wrap", torch.float32): 1e-5,
              ("flash", torch.bfloat16): 2e-2, ("flash", torch.float32): 1e-5}
# the weight-gradient launch (f32 sums of bf16 products over up to 1,048,576
# rows, in another order) against an f32 matmul, relative to its max
WGRAD_LIMIT = 1e-4
TRAIN_CHECK_LIMIT = 1e-4  # worst per-tensor relative gradient error, f32 (read: 2e-6)
# the forward's log-sum-exp against torch.logsumexp of the f32 logits (read:
# 1.4e-6 in bf16, from f32 sums of exponentials on the SFU)
LSE_LIMIT = 1e-4
WRAP_MEAN_LIMIT_BF16 = 1e-2
# on balanced wrap inputs the attention's share of the output (the plain
# output minus the plain output with no attention) must be of order 1
SIGNAL_MIN = 0.3


def emit(**kw):
    print(json.dumps(kw), flush=True)


def kernel_counters():
    """Every kernel wrapper, whose `launches` counts its kernel's launches, by
    the key the summary line uses."""
    from daclip_torch.ops import flash_attention as fa
    from daclip_torch.ops import linear_attention as la
    from daclip_torch.ops import pointwise as pw
    from daclip_torch.ops.conv3x3 import conv3x3

    return {"wrap": la.attn_wrap, "flash": fa.flash_self_attention,
            "wrap_bwd": la.attn_wrap_bwd, "flash_bwd": fa.flash_self_attention_bwd,
            "fused_v4": la.linear_attention_fused, "wrap_fused": la.attn_wrap_fused,
            "core": la.linear_attention, "dual": pw.dual_conv1x1, "conv3x3": conv3x3}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {key: fn.launches for key, fn in kernel_counters().items()}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, iters=20, warmup=3):
    """Median of `iters` CUDA-event timed calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, match, iters=10):
    """Device time per call of `fn` of the kernels whose name holds `match`
    (torch.profiler, after one warm-up call). Unlike `time_ms`, which times
    a call between two CUDA events, it leaves out the wrapper's host time,
    which a small kernel can take less than."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that records none of the kernels is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and match in e.name)
        if us:
            return us / iters / 1e3
    return None


def bound_ms(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(log):
    """One line per compiled kernel of an `nvcc -Xptxas -v` log: its name
    (namespace::function<template arguments>, read off the mangled symbol;
    a configuration struct's arguments stand for the struct), registers,
    stack, spills and shared memory."""
    out, name, props = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (_ZN\w+)", ln)
        if m:
            sym = m.group(1)
            parts, i = [], 3
            while i < len(sym) and sym[i].isdigit():
                j = i
                while sym[j].isdigit():
                    j += 1
                n = int(sym[i:j])
                parts.append(sym[j:j + n])
                i = j + n
            targs = re.match(r"I(.*?)EE", sym[i:])
            args = [{"13__nv_bfloat16": "bf16", "f": "f32"}.get(a, a.strip("LiE"))
                    for a in re.findall(r"13__nv_bfloat16|Li-?\d+E|f(?=L|E|f|1)",
                                        targs.group(1) + "E" if targs else "")]
            name = "::".join(parts[1:]) + (f"<{','.join(args)}>" if args else "")
        elif name and "stack frame" in ln:
            props = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split('Used', 1)[1].strip()}; {props}")
            name, props = None, ""
    return out


def psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


# -- phase 2 -------------------------------------------------------------------
def wrap_case(B, n, C, dtype, gen, balanced):
    """Inputs for one wrap site.

    Production-like: the reference divides the attention by s·n, so here
    attn·W_out is ~1e-7 of the out-projection bias and the out-LN sees
    little else. These inputs check the kernel as the UNet calls it, but a
    wrong attention would hide under any limit. Balanced: a bias of unit
    std, and v scaled so that attn·W_out has the same std (plain version,
    f32). A wrong softmax, mask or scale, or a skipped attention, then moves
    the output by ~0.3-0.8 on average."""
    from daclip_torch.ops import linear_attention as la

    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x, g_pre, g_out = rnd(B, n, C), 1 + 0.1 * rnd(C), 1 + 0.1 * rnd(C)
    w_qkv, w_out, b_out = rnd(C, 384) * C ** -0.5, rnd(128, C) * 128 ** -0.5, rnd(C)
    if balanced:
        qkv = la._channel_ln(x, g_pre) @ w_qkv
        w_qkv[:, 2 * la.HID:] /= float((la.linear_attention_reference(qkv) @ w_out).std())
    else:
        b_out *= 0.1
    return [a.to(dtype).contiguous() for a in (x, g_pre, w_qkv, w_out, b_out, g_out)]


def attention_share(want, x, b_out, g_out):
    """Mean |plain output − the plain output with the attention left out|."""
    from daclip_torch.ops.linear_attention import _channel_ln

    return float((want - x - _channel_ln(b_out.expand_as(x), g_out)).abs().mean())


def run_kernels():
    from daclip_torch.ops import flash_attention as fa
    from daclip_torch.ops import linear_attention as la

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"wrap": [], "flash": []}
    for (B, n, C, dtype), balanced in [(s, b) for s in WRAP_SHAPES for b in (False, True)]:
        args = wrap_case(B, n, C, dtype, gen, balanced)
        got = la.attn_wrap(*args)
        torch.cuda.synchronize()
        repeats = torch.equal(la.attn_wrap(*args), got)
        fargs = [a.float() for a in args]
        want = la.attn_wrap_reference(*fargs)
        err = (got.float() - want).abs()
        limit = LIMITS[("wrap", dtype)]
        row = dict(phase="kernels", kernel="attn_wrap", shape=[B, n, C],
                   dtype=str(dtype).split(".")[-1], balanced=balanced,
                   max_abs_err=float(err.max()), mean_abs_err=float(err.mean()), limit=limit,
                   repeats_bitwise=repeats,
                   attention_share=attention_share(want, fargs[0], fargs[4], fargs[5]))
        if not balanced:  # time each shape once
            esize = args[0].element_size()
            nbytes = (2 * B * n * C + C * 384 + 128 * C + 3 * C) * esize
            bms, by = bound_ms(nbytes, 2 * B * n * (512 * C + 8192), dtype)
            row.update(kernel_ms=time_ms(lambda: la.attn_wrap(*args)),
                       device_ms=device_ms(lambda: la.attn_wrap(*args), "daclip::wrap::"),
                       plain_ms=time_ms(lambda: la.attn_wrap_reference(*args)),
                       bound_ms=bms, bound_by=by, library_ms=None)
        emit(**row)
        rows["wrap"].append(row)
        what = f"wrap {B, n, C, dtype}" + (" balanced" if balanced else "")
        check(torch.isfinite(got).all().item(), f"{what} not finite")
        check(repeats, f"{what}: two calls differ")
        check(row["max_abs_err"] <= limit, f"{what} max err {row['max_abs_err']}")
        if dtype == torch.bfloat16:
            check(row["mean_abs_err"] <= WRAP_MEAN_LIMIT_BF16,
                  f"{what} mean err {row['mean_abs_err']}")
        if balanced:
            check(row["attention_share"] >= SIGNAL_MIN,
                  f"{what}: the attention's share {row['attention_share']} is too small")

    for (B, N, H, D, dtype), train in ([(s, False) for s in FLASH_SHAPES]
                                       + [(s, True) for s in FLASH_TRAIN_SHAPES]):
        q, k, v = [torch.randn(B, N, H * D, generator=gen, device="cuda").to(dtype)
                   for _ in range(3)]
        # serving calls the forward alone, training keeps each query's lse
        fwd = ((lambda: fa._forward_kernel(q, k, v, H, D, True)) if train
               else (lambda: (fa.flash_self_attention(q, k, v, H, D), None)))
        got, lse = fwd()
        torch.cuda.synchronize()
        again, lse2 = fwd()
        repeats = torch.equal(got, again) and (lse is None or torch.equal(lse, lse2))
        want = fa.attention_reference(q.float(), k.float(), v.float(), H, D)
        err = rel_err(got, want)
        limit = LIMITS[("flash", dtype)]
        heads = lambda t: t.view(B, N, H, D).transpose(1, 2)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            heads(q), heads(k), heads(v))
        bms, by = bound_ms(4 * B * N * H * D * q.element_size(), 4 * B * H * N * N * D, dtype)
        row = dict(phase="kernels", kernel="flash_self_attention", shape=[B, N, H, D],
                   dtype=str(dtype).split(".")[-1], path="train" if train else "serve",
                   max_rel_err=err, max_abs_err=float((got.float() - want).abs().max()),
                   limit=limit, repeats_bitwise=repeats,
                   kernel_ms=time_ms(fwd), device_ms=device_ms(fwd, "daclip::flash::"),
                   plain_ms=time_ms(lambda: fa.attention_reference(q, k, v, H, D)),
                   bound_ms=bms, bound_by=by, library_ms=time_ms(lib),
                   library_device_ms=device_ms(lib, ""))
        if lse is not None:
            qh, kh = heads(q.float()), heads(k.float())
            want_lse = torch.logsumexp(qh @ kh.transpose(-1, -2) * D ** -0.5, dim=-1)
            row["lse_max_abs_err"] = float((lse - want_lse).abs().max())
            check(row["lse_max_abs_err"] <= LSE_LIMIT,
                  f"flash {B, N, H, D, dtype} lse err {row['lse_max_abs_err']}")
        emit(**row)
        rows["flash"].append(row)
        check(err <= limit, f"flash {B, N, H, D, dtype} rel err {err}")
        check(repeats, f"flash {B, N, H, D, dtype}: two calls differ")
        del q, k, v, got, again, lse, lse2, want
    return rows


# -- phase 2b ------------------------------------------------------------------
def fused_share(want, b_out, g_out):
    """Mean |plain output − the plain output with the attention left out|,
    without a residual."""
    from daclip_torch.ops.linear_attention import _channel_ln

    return float((want - _channel_ln(b_out.expand_as(want), g_out)).abs().mean())


def linattn_bound(B, n, C, esize, dtype):
    """The bound of the wrap's math on (B, n, C): x in, out out, the weights
    once; 2·B·n·(512·C + 8192) FLOP (q/k/v, ctx, ·W, to_out)."""
    nbytes = (2 * B * n * C + C * 384 + 128 * C + 3 * C) * esize
    return bound_ms(nbytes, 2 * B * n * (512 * C + 8192), dtype)


def run_kernels_alt():
    """The kernels of the UNet's other wirings against their plain versions."""
    from daclip_torch.ops import linear_attention as la
    from daclip_torch.ops import pointwise as pw

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"fused_v4": [], "wrap_fused": [], "core": [], "dual": []}
    kernels = {  # key → (name, kernel, plain, takes the raw x)
        "fused_v4": ("linear_attention_fused", la.linear_attention_fused,
                     la.fused_composition_reference, False),
        "wrap_fused": ("attn_wrap_fused", la.attn_wrap_fused, la.attn_wrap_reference, True),
        "wrap_fused_xn": ("attn_wrap_fused", lambda xn, *w: la.attn_wrap_fused(
            xn, None, *w, prenorm_residual=False), la.fused_composition_reference, False)}
    for (B, n, C, dtype), balanced in [(s, b) for s in WRAP_SHAPES for b in (False, True)]:
        x, g_pre, *w = wrap_case(B, n, C, dtype, gen, balanced)
        xn = la._channel_ln(x, g_pre)
        for key, (name, kernel, plain, raw) in kernels.items():
            args = [x, g_pre, *w] if raw else [xn, *w]
            got = kernel(*args)
            torch.cuda.synchronize()
            repeats = torch.equal(kernel(*args), got)
            fargs = [a.float() for a in args]
            want = plain(*fargs)
            err = (got.float() - want).abs()
            share = (attention_share(want, fargs[0], fargs[-2], fargs[-1]) if raw
                     else fused_share(want, fargs[-2], fargs[-1]))
            limit = LIMITS[("wrap", dtype)]
            row = dict(phase="kernels_alt", kernel=name, shape=[B, n, C],
                       dtype=str(dtype).split(".")[-1], balanced=balanced,
                       prenorm_residual=raw if name == "attn_wrap_fused" else None,
                       max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
                       limit=limit, repeats_bitwise=repeats, attention_share=share)
            if not balanced:
                bms, by = linattn_bound(B, n, C, x.element_size(), dtype)
                row.update(kernel_ms=time_ms(lambda: kernel(*args)),
                           device_ms=device_ms(lambda: kernel(*args), "daclip::wrap::"),
                           plain_ms=time_ms(lambda: plain(*args)),
                           bound_ms=bms, bound_by=by, library_ms=None)
            emit(**row)
            rows["fused_v4" if key == "fused_v4" else "wrap_fused"].append(row)
            what = f"{name} {B, n, C, dtype}" + (" raw x" if raw else "") + (
                " balanced" if balanced else "")
            check(torch.isfinite(got).all().item(), f"{what} not finite")
            check(repeats, f"{what}: two calls differ")
            check(row["max_abs_err"] <= limit, f"{what} max err {row['max_abs_err']}")
            if dtype == torch.bfloat16:
                check(row["mean_abs_err"] <= WRAP_MEAN_LIMIT_BF16,
                      f"{what} mean err {row['mean_abs_err']}")
            if balanced:
                check(share >= SIGNAL_MIN, f"{what}: the attention's share {share} is too small")
            del got, want, err, fargs

    # the attention core: its path is one call at each of the six sites
    # (down0 and up0 share the first shape), counted from 0; then the ragged
    # and f32 cases
    qkvs = []
    for B, n, C, dtype in WRAP_SHAPES:
        x, g_pre, w_qkv, *_ = wrap_case(B, n, C, dtype, gen, False)
        qkvs.append((la._channel_ln(x, g_pre) @ w_qkv).contiguous())
    la.linear_attention.launches = 0
    outs = [la.linear_attention(q) for q in qkvs[:1] + qkvs[:5]][1:]
    torch.cuda.synchronize()
    core_path = la.linear_attention.launches
    check(core_path == 6, f"core path launched {core_path} times, expected 6")
    outs += [la.linear_attention(q) for q in qkvs[5:]]
    for qkv, got in zip(qkvs, outs):
        B, n, _ = qkv.shape
        dtype = qkv.dtype
        repeats = torch.equal(la.linear_attention(qkv), got)
        want = la.linear_attention_reference(qkv.float())
        err = float((got.float() - want).abs().max() / want.abs().max())
        limit = LIMITS[("core", dtype)]
        esize = qkv.element_size()
        bms, by = bound_ms(B * n * (384 + 128) * esize, 2 * B * n * 8192, dtype)
        row = dict(phase="kernels_alt", kernel="linear_attention", shape=[B, n, 384],
                   dtype=str(dtype).split(".")[-1], max_rel_err=err,
                   max_abs_err=float((got.float() - want).abs().max()), limit=limit,
                   repeats_bitwise=repeats,
                   kernel_ms=time_ms(lambda: la.linear_attention(qkv)),
                   device_ms=device_ms(lambda: la.linear_attention(qkv), "daclip::wrap::"),
                   plain_ms=time_ms(lambda: la.linear_attention_reference(qkv)),
                   bound_ms=bms, bound_by=by, library_ms=None)
        emit(**row)
        rows["core"].append(row)
        check(torch.isfinite(got).all().item(), f"core {B, n, dtype} not finite")
        check(err <= limit, f"core {B, n, dtype} rel err {err}")
        check(repeats, f"core {B, n, dtype}: two calls differ")
    del qkvs, outs

    for R, cx, cs, O, dtype in DUAL_SHAPES:
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
        x, skip, w = rnd(R, cx), rnd(R, cs), rnd(cx + cs, O) * (cx + cs) ** -0.5
        xcat = torch.cat([x, skip], dim=1)
        for form, args in (("dual", (x, skip, w)), ("single", (xcat, None, w))):
            got = pw.dual_conv1x1(*args)
            torch.cuda.synchronize()
            repeats = torch.equal(pw.dual_conv1x1(*args), got)
            want = pw.dual_conv1x1_reference(*[None if a is None else a.float() for a in args])
            err = float((got.float() - want).abs().max() / want.abs().max())
            limit = LIMITS[("dual", dtype)]
            bms, by = bound_ms((R * (cx + cs) + R * O + (cx + cs) * O) * x.element_size(),
                               2 * R * (cx + cs) * O, dtype)
            lib = (lambda: torch.matmul(xcat, w)) if form == "single" else None
            row = dict(phase="kernels_alt", kernel="dual_conv1x1", form=form,
                       shape=[R, cx, cs, O], dtype=str(dtype).split(".")[-1],
                       max_rel_err=err, max_abs_err=float((got.float() - want).abs().max()),
                       limit=limit, repeats_bitwise=repeats,
                       kernel_ms=time_ms(lambda: pw.dual_conv1x1(*args)),
                       device_ms=device_ms(lambda: pw.dual_conv1x1(*args), "daclip::pointwise::"),
                       plain_ms=time_ms(lambda: pw.dual_conv1x1_reference(*args)),
                       bound_ms=bms, bound_by=by, library_ms=lib and time_ms(lib),
                       library_device_ms=lib and device_ms(lib, ""))
            emit(**row)
            rows["dual"].append(row)
            check(torch.isfinite(got).all().item(), f"dual_conv1x1 {form} {R, cx, cs, O} "
                  "not finite")
            check(err <= limit, f"dual_conv1x1 {form} {R, cx, cs, O, dtype} rel err {err}")
            check(repeats, f"dual_conv1x1 {form} {R, cx, cs, O, dtype}: two calls differ")

    # the training step's shapes (B=16): linear_attention_fused at the five
    # (n, C) of the six sites, production-like and balanced, and the single
    # form the UNet calls at 16× the res_conv rows. attn_wrap_fused launches
    # the v5 wrap's forward or linear_attention_fused's, both held here or
    # in kernels_bwd at B=16.
    for (B, n, C, dtype), balanced in [(s, b) for s in TRAIN_WRAP_SHAPES for b in (False, True)]:
        x, g_pre, *w = wrap_case(B, n, C, dtype, gen, balanced)
        args = [la._channel_ln(x, g_pre), *w]
        del x, g_pre
        got = la.linear_attention_fused(*args)
        torch.cuda.synchronize()
        repeats = torch.equal(la.linear_attention_fused(*args), got)
        fargs = [a.float() for a in args]
        want = la.fused_composition_reference(*fargs)
        err = (got.float() - want).abs()
        share = fused_share(want, fargs[-2], fargs[-1])
        limit = LIMITS[("wrap", dtype)]
        row = dict(phase="kernels_alt", kernel="linear_attention_fused", path="train",
                   shape=[B, n, C], dtype=str(dtype).split(".")[-1], balanced=balanced,
                   max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
                   limit=limit, repeats_bitwise=repeats, attention_share=share)
        if not balanced:
            bms, by = linattn_bound(B, n, C, args[0].element_size(), dtype)
            row.update(kernel_ms=time_ms(lambda: la.linear_attention_fused(*args), iters=10),
                       plain_ms=time_ms(lambda: la.fused_composition_reference(*args),
                                        iters=5, warmup=1),
                       bound_ms=bms, bound_by=by, library_ms=None)
        emit(**row)
        rows["fused_v4"].append(row)
        what = f"linear_attention_fused {B, n, C, dtype}" + (" balanced" if balanced else "")
        check(torch.isfinite(got).all().item(), f"{what} not finite")
        check(repeats, f"{what}: two calls differ")
        check(row["max_abs_err"] <= limit, f"{what} max err {row['max_abs_err']}")
        check(row["mean_abs_err"] <= WRAP_MEAN_LIMIT_BF16,
              f"{what} mean err {row['mean_abs_err']}")
        if balanced:
            check(share >= SIGNAL_MIN, f"{what}: the attention's share {share} is too small")
        del got, want, err, fargs, args
        torch.cuda.empty_cache()

    for R, cx, cs, O, dtype in TRAIN_DUAL_SHAPES:
        K = cx + cs
        x = torch.randn(R, K, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(K, O, generator=gen, device="cuda") * K ** -0.5).to(dtype)
        got = pw.dual_conv1x1(x, None, w)
        torch.cuda.synchronize()
        repeats = torch.equal(pw.dual_conv1x1(x, None, w), got)
        want = pw.dual_conv1x1_reference(x.float(), None, w.float())
        abs_err = float((got.float() - want).abs().max())
        err = abs_err / float(want.abs().max())
        limit = LIMITS[("dual", dtype)]
        bms, by = bound_ms((R * K + R * O + K * O) * x.element_size(), 2 * R * K * O, dtype)
        row = dict(phase="kernels_alt", kernel="dual_conv1x1", form="single", path="train",
                   shape=[R, cx, cs, O], dtype=str(dtype).split(".")[-1], max_rel_err=err,
                   max_abs_err=abs_err, limit=limit, repeats_bitwise=repeats,
                   kernel_ms=time_ms(lambda: pw.dual_conv1x1(x, None, w), iters=10),
                   device_ms=device_ms(lambda: pw.dual_conv1x1(x, None, w),
                                       "daclip::pointwise::"),
                   plain_ms=time_ms(lambda: pw.dual_conv1x1_reference(x, None, w), iters=10),
                   bound_ms=bms, bound_by=by,
                   library_ms=time_ms(lambda: torch.matmul(x, w), iters=10),
                   library_device_ms=device_ms(lambda: torch.matmul(x, w), ""))
        emit(**row)
        rows["dual"].append(row)
        check(torch.isfinite(got).all().item(), f"dual_conv1x1 single {R, K, O} not finite")
        check(err <= limit, f"dual_conv1x1 single {R, K, O, dtype} rel err {err}")
        check(repeats, f"dual_conv1x1 single {R, K, O, dtype}: two calls differ")
        del x, w, got, want
    return rows, core_path


# -- phase 2c ------------------------------------------------------------------
def run_kernels_conv():
    """conv3x3 against its plain version (in f32 on the same inputs) at every
    shape of CONV_SHAPES, and against itself (a second call on the same
    inputs must give the same bytes); cuDNN's conv2d on the free
    channels_last NCHW view of the same x, with the weight in (O, C, 3, 3), is
    the yardstick (timed here only). Then the device times of both summed over
    the 44 sites of one serving forward (B=1 rows at their site counts). Its
    path here is the first call at each shape, counted."""
    from daclip_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, path = [], 0
    for B, H, W, C, O, dtype in CONV_SHAPES:
        x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(3, 3, C, O, generator=gen, device="cuda") * (9 * C) ** -0.5).to(dtype)
        before = conv3x3.launches
        got = conv3x3(x, w)
        torch.cuda.synchronize()
        path += conv3x3.launches - before
        repeats = torch.equal(conv3x3(x, w), got)
        want = conv3x3_reference(x.float(), w.float())
        abs_err = float((got.float() - want).abs().max())
        err = abs_err / float(want.abs().max())
        limit = LIMITS[("conv", dtype)]
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1)
        lib_err = rel_err(lib().permute(0, 2, 3, 1), want)
        iters = 10 if B * H * W >= 2 ** 20 else 20
        bms, by = bound_ms((B * H * W * (C + O) + 9 * C * O) * x.element_size(),
                           2 * B * H * W * 9 * C * O, dtype)
        row = dict(phase="kernels_conv", kernel="conv3x3", shape=[B, H, W, C, O],
                   dtype=str(dtype).split(".")[-1], max_rel_err=err, max_abs_err=abs_err,
                   limit=limit, repeats_bitwise=repeats,
                   kernel_ms=time_ms(lambda: conv3x3(x, w), iters=iters),
                   device_ms=device_ms(lambda: conv3x3(x, w), "daclip::conv3x3::"),
                   plain_ms=time_ms(lambda: conv3x3_reference(x, w), iters=iters),
                   bound_ms=bms, bound_by=by, library_ms=time_ms(lib, iters=iters),
                   library_device_ms=device_ms(lib, ""), library_max_rel_err=lib_err)
        emit(**row)
        rows.append(row)
        check(torch.isfinite(got).all().item(), f"conv3x3 {B, H, W, C, O} not finite")
        check(err <= limit, f"conv3x3 {B, H, W, C, O, dtype} rel err {err}")
        check(repeats, f"conv3x3 {B, H, W, C, O, dtype}: two calls differ")
        del x, w, got, want, x_nchw, w_oihw
    torch.cuda.empty_cache()
    check(path == len(CONV_SHAPES), f"conv3x3 path launched {path} times, "
          f"expected {len(CONV_SHAPES)}")
    # one serving forward's 44 sites: the B=1 rows at their site counts
    sites = {(H, C, O): n for H, C, O, n in CONV_SITES}
    per_site = [(sites[(r["shape"][1], *r["shape"][3:])], r) for r in rows
                if r["shape"][0] == 1 and r["dtype"] == "bfloat16"
                and (r["shape"][1], *r["shape"][3:]) in sites][:len(CONV_SITES)]
    total = {key: sum(n * r[key] for n, r in per_site)
             for key in ("device_ms", "library_device_ms", "bound_ms")}
    emit(phase="kernels_conv_sum", what="device ms summed over the 44 3x3 sites of one "
         "serving forward (B=1, 256x256), each shape's row times its site count",
         sites=sum(n for n, _ in per_site), kernel_device_ms=total["device_ms"],
         cudnn_device_ms=total["library_device_ms"], bound_ms=total["bound_ms"],
         kernel_over_cudnn=total["device_ms"] / total["library_device_ms"])
    check(sum(n for n, _ in per_site) == CONV_SITES_PER_FORWARD, "site counts")
    return {"conv3x3": rows}, path


# -- phase 3 -------------------------------------------------------------------
def run_fixture():
    from daclip_torch.convert import infer_unet_arch, load_torch_state_dict
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.sde import IRSDE

    meta = json.loads((FIXTURE / "meta.json").read_text())
    arrs = np.load(FIXTURE / "arrays.npz")
    daclip = DaCLIP(CLIPCfg.from_dict(get_model_config(meta["model_name"])))
    daclip.load_state_dict(load_torch_state_dict(str(FIXTURE / "daclip.pt")), strict=True)
    daclip.cuda().eval()
    sd = load_torch_state_dict(str(FIXTURE / "unet.pth"))
    arch = {k: v for k, v in infer_unet_arch(sd).items() if k not in ("in_nc", "out_nc")}
    sde = IRSDE(max_sigma=meta["max_sigma"], T=meta["T"], schedule=meta["schedule"],
                eps=meta["eps"])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3))).cuda()
    with torch.no_grad():
        img_ctx, degra_ctx = daclip.encode_image(dev(arrs["img4clip"][None]), control=True)
    # the kernels each wiring must run (flash at the SpatialTransformers)
    wirings = {"v5": ({}, ("wrap", "flash")),
               "v4_pointwise": (ALT_CONFIGS["v4_pointwise"], ("fused_v4", "dual", "flash")),
               "v3_pointwise": (ALT_CONFIGS["v3_pointwise"], ("wrap_fused", "dual", "flash"))}
    for wiring, (config, need) in wirings.items():
        unet = ConditionalUNet(**arch, **config)
        unet.load_state_dict(sd, strict=True)
        unet.cuda().eval()
        reset_counts()
        with torch.no_grad():
            out = sde.reverse_posterior(unet, dev(arrs["x_T"][None]), dev(arrs["lq"][None]),
                                        noises=dev(arrs["noises"]), text_context=degra_ctx,
                                        image_context=img_ctx)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        ours = out[0].cpu().numpy().transpose(1, 2, 0)
        row = dict(phase="fixture", wiring=wiring, psnr_vs_ref_out=psnr(ours, arrs["ref_out"]),
                   psnr_vs_gt=psnr(ours, arrs["gt"]), ref_psnr_vs_gt=meta["ref_psnr_vs_gt"],
                   launches=counts)
        emit(**row)
        check(row["psnr_vs_ref_out"] > 40.0, f"fixture replay ({wiring}) below 40 dB vs ref_out")
        check(set(counts) == set(need), f"fixture replay ({wiring}) launched {counts}, "
              f"expected exactly {need}")


# -- phase 4 -------------------------------------------------------------------
def seeded_state_dict(factory, seed):
    """Reference-named state dict of `factory()` filled from a seed, on the
    card, with no zero tensor: fan-in scaled weights, norm gains near 1,
    small biases. Tensors shared by two names (DaCLIP's visual alias) stay
    shared."""
    with torch.device("meta"):
        module = factory()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out, by_id = {}, {}
    for key, p in module.state_dict(keep_vars=True).items():
        if id(p) not in by_id:
            shape = tuple(p.shape)
            leaf = key.rsplit(".", 1)[-1]
            r = torch.randn(shape, generator=gen, device="cuda")
            if key.endswith(".g") or (leaf == "weight" and len(shape) == 1):
                t = 1 + 0.1 * r
            elif leaf == "logit_scale":
                t = torch.full(shape, float(np.log(1 / 0.07)), device="cuda")
            elif len(shape) >= 2:
                t = r * float(np.prod(shape[1:])) ** -0.5
            else:
                t = 0.02 * r
            by_id[id(p)] = t
        out[key] = by_id[id(p)]
    return out


def run_serve():
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.ops import flash_attention as fa
    from daclip_torch.ops import linear_attention as la
    from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig

    # production: ViT-B-32, nf 64, (1,2,4,8), ctx 512, bf16, T=100; the default
    # wiring whatever the DACLIP_TPU_* variables say
    cfg = RestorerConfig(linear_attention="v5", pointwise=False)
    t0 = time.perf_counter()
    unet_sd = seeded_state_dict(lambda: ConditionalUNet(
        nf=cfg.nf, ch_mult=cfg.ch_mult, context_dim=cfg.context_dim,
        use_degra_context=True, use_image_context=True), seed=1)
    daclip_sd = seeded_state_dict(lambda: DaCLIP(CLIPCfg.from_dict(
        get_model_config(cfg.model_name))), seed=2)
    check(all(bool(t.abs().max() > 0) for sd in (unet_sd, daclip_sd) for t in sd.values()),
          "a weight tensor is all zero")
    restorer = DACLIPRestorer(cfg, unet_sd, daclip_sd, device="cuda")
    emit(phase="serve_setup", seconds=time.perf_counter() - t0,
         unet_params=sum(p.numel() for p in restorer.unet.parameters()),
         daclip_params=sum(p.numel() for p in restorer.daclip.parameters()))

    rng = np.random.RandomState(0)
    img = lambda h, w: rng.rand(h, w, 3).astype(np.float32)
    # warm-up: one 256² restore, then one UNet forward at each request's shape
    restorer.restore(img(256, 256), seed=0)
    with torch.no_grad():
        for h, w, b in ((256, 320, 1), (256, 256, 2), (512, 384, 2)):
            x = torch.rand(b, 3, h, w, device="cuda")
            c = torch.rand(b, cfg.context_dim, device="cuda")
            restorer.unet(x, x, torch.full((b,), 50.0, device="cuda"), c, c)
    torch.cuda.synchronize()

    requests = [
        ("restore_256x256", lambda: [restorer.restore(img(256, 256), seed=1)], [(256, 256, 3)]),
        ("restore_200x300", lambda: [restorer.restore(img(200, 300), seed=2)], [(200, 300, 3)]),
        ("restore_batch_2x256x256",
         lambda: restorer.restore_batch([img(256, 256), img(256, 256)], seed=3),
         [(256, 256, 3)] * 2),
        ("restore_tiled_480x640", lambda: [restorer.restore(img(480, 640), seed=4)],
         [(480, 640, 3)]),
    ]
    steps = restorer.sde.sample_T
    totals = {"wrap": 0, "flash": 0}
    for name, fn, shapes in requests:
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        la.attn_wrap.launches = fa.flash_self_attention.launches = 0
        t0 = time.perf_counter()
        outs = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        wrap_n, flash_n = la.attn_wrap.launches, fa.flash_self_attention.launches
        totals["wrap"] += wrap_n
        totals["flash"] += flash_n
        finite = all(np.isfinite(o.astype(np.float32)).all() for o in outs)
        emit(phase="serve", request=name, latency_ms=ms, sampler_runs=1, steps=steps,
             wrap_launches=wrap_n, flash_launches=flash_n, finite=bool(finite),
             output_shapes=[list(o.shape) for o in outs],
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             memory_allocated_before=resident)
        check([o.shape for o in outs] == shapes, f"{name} output shapes")
        check(finite, f"{name} output not finite")
        check(wrap_n == 6 * steps and flash_n == 3 * steps,
              f"{name}: {wrap_n} wrap / {flash_n} flash launches, expected "
              f"{6 * steps} / {3 * steps} for one {steps}-step sampler run")
    return restorer, totals, (unet_sd, daclip_sd)


# -- phase 4b ------------------------------------------------------------------
def run_serve_alt(restorer, sds):
    """The production weights in each other wiring: one full-width bf16 UNet
    forward against the v5 wiring's (limit ALT_FORWARD_FACTOR × the v5 bf16
    forward's max distance from the f32 v5 forward, TF32 off), then two 256²
    requests through DACLIPRestorer with their launch counts and a profile of
    one UNet forward."""
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig

    unet_sd, daclip_sd = sds
    cfg = restorer.cfg
    gen = torch.Generator(device="cuda").manual_seed(8)
    xt, cond = (torch.rand(1, 3, 256, 256, generator=gen, device="cuda") for _ in range(2))
    c = torch.randn(1, cfg.context_dim, generator=gen, device="cuda")
    t = torch.full((1,), 50.0, device="cuda")
    with torch.no_grad():
        ref = restorer.unet(xt, cond, t, c, c)
        unet32 = ConditionalUNet(nf=cfg.nf, ch_mult=cfg.ch_mult, context_dim=cfg.context_dim,
                                 use_degra_context=True, use_image_context=True)
        unet32.load_state_dict(unet_sd, strict=True)
        out32 = unet32.cuda().eval()(xt, cond, t, c, c)
    del unet32
    floor = float((ref - out32).abs().max())
    limit = ALT_FORWARD_FACTOR * floor
    emit(phase="serve_alt_forward", wiring="v5", max_abs_err_vs_f32=floor,
         mean_abs_err_vs_f32=float((ref - out32).abs().mean()), output_max=float(ref.abs().max()))
    img = np.random.RandomState(5).rand(256, 256, 3).astype(np.float32)
    steps = restorer.sde.sample_T
    totals = {}
    route = {"v4": "fused_v4", "v3": "wrap_fused", "v5": "wrap"}

    def requests(r, wiring, want, n=2, yardstick=False):
        """n 256² requests through `r`, each counted from 0; the v5 ones
        (yardstick) before and after the other wirings bracket them in this
        phase (host time spreads run to run)."""
        for i in range(n):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            res = r.restore(img, seed=1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k: v for k, v in read_counts().items() if v}
            emit(phase="serve_alt", wiring=wiring, request=f"restore_256x256#{i}",
                 latency_ms=ms, steps=steps, launches=counts,
                 finite=bool(np.isfinite(res).all()), output_shape=list(res.shape),
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 memory_allocated_before=resident)
            check(res.shape == (256, 256, 3) and np.isfinite(res).all(),
                  f"{wiring} request output")
            check(counts == want, f"{wiring} request launched {counts}, expected {want}")
            if not yardstick:
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v

    v5_want = {"wrap": 6 * steps, "flash": 3 * steps}
    requests(restorer, "v5", v5_want, yardstick=True)
    for wiring, config in ALT_CONFIGS.items():
        alt = DACLIPRestorer(RestorerConfig(**config), unet_sd, daclip_sd, device="cuda")
        with torch.no_grad():
            out = alt.unet(xt, cond, t, c, c)
        err = float((out - ref).abs().max())
        emit(phase="serve_alt_forward", wiring=wiring, max_abs_err_vs_v5=err,
             mean_abs_err_vs_v5=float((out - ref).abs().mean()),
             max_abs_err_vs_f32=float((out - out32).abs().max()), limit=limit)
        check(bool(torch.isfinite(out).all()), f"{wiring} forward not finite")
        check(err <= limit, f"{wiring} forward differs from v5 by {err} (limit {limit})")
        requests(alt, wiring, {route[config["linear_attention"]]: 6 * steps,
                               "flash": 3 * steps, "dual": 9 * steps})
        run_profile(alt, wiring=wiring)
        del alt, out
        torch.cuda.empty_cache()
    requests(restorer, "v5_after", v5_want, yardstick=True)
    return totals, dict(args=(xt, cond, t, c, c), ref=ref, limit=limit)


# -- phase 4c ------------------------------------------------------------------
def run_forward_conv(unet, fwd):
    """One full-width bf16 v5 UNet forward with every 3×3 stride-1 Conv2d's
    output replaced, through a forward hook registered here, by conv3x3 on
    the module's input (its NHWC view; the bias, where the module has one,
    added outside the kernel). Each site is held against the module's own
    output, the forward against serve_alt's plain one (`fwd`). Returns the
    kernel's launches in that forward."""
    from daclip_torch.ops.conv3x3 import conv3x3, conv3x3_weight

    sites = []

    def substitute(module, inputs, output):
        x = inputs[0]
        xh = x.permute(0, 2, 3, 1)
        copied = not xh.is_contiguous()
        y = conv3x3(xh.contiguous() if copied else xh, conv3x3_weight(module.weight.to(x.dtype)))
        if module.bias is not None:
            y = y + module.bias.to(y.dtype)
        y = y.permute(0, 3, 1, 2)
        sites.append(dict(shape=[*xh.shape, y.shape[1]], copied=copied,
                          max_rel_err=rel_err(y, output)))
        return y

    convs = [m for m in unet.modules() if isinstance(m, torch.nn.Conv2d)
             and m.kernel_size == (3, 3) and m.stride == (1, 1) and m.padding == (1, 1)]
    handles = [m.register_forward_hook(substitute) for m in convs]
    try:
        reset_counts()
        with torch.no_grad():
            out = unet(*fwd["args"])
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
    finally:
        for h in handles:
            h.remove()
    launches = counts.get("conv3x3", 0)
    err = float((out - fwd["ref"]).abs().max())
    limit = LIMITS[("conv", torch.bfloat16)]
    worst = max(s["max_rel_err"] for s in sites)
    emit(phase="forward_conv", sites=len(convs), launches=counts,
         max_abs_err_vs_plain_forward=err, forward_limit=fwd["limit"],
         worst_site_rel_err=worst, site_limit=limit,
         copied_views=sum(s["copied"] for s in sites), per_site=sites)
    check(len(convs) == CONV_SITES_PER_FORWARD,
          f"{len(convs)} 3×3 stride-1 convs, expected {CONV_SITES_PER_FORWARD}")
    counts_by_shape = {}
    for site in sites:  # (1, H, W, C, O) → (H, C, O)
        key = (site["shape"][1], site["shape"][3], site["shape"][4])
        counts_by_shape[key] = counts_by_shape.get(key, 0) + 1
    check(counts_by_shape == {(H, C, O): n for H, C, O, n in CONV_SITES},
          f"the forward's 3×3 sites {counts_by_shape} differ from CONV_SITES")
    check(launches == CONV_SITES_PER_FORWARD,
          f"forward_conv launched conv3x3 {launches} times, expected {CONV_SITES_PER_FORWARD}")
    check(bool(torch.isfinite(out).all()), "forward_conv output not finite")
    check(worst <= limit, f"a conv3x3 site differs from its Conv2d by {worst} of its max")
    check(err <= fwd["limit"], f"forward_conv differs from the plain forward by {err} "
          f"(limit {fwd['limit']})")
    return launches


def run_profile(restorer, forwards=5, wiring="v5"):
    """Where one sampler step's time goes: one ConditionalUNet forward at 256²,
    B=1, bf16 — host wall time unprofiled, then the device kernels that
    torch.profiler records, summed by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(1, 3, 256, 256, device="cuda")
    c = torch.rand(1, restorer.cfg.context_dim, device="cuda")
    t = torch.full((1,), 50.0, device="cuda")
    step = lambda: restorer.unet(x, x, t, c, c)
    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(forwards):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / forwards
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(forwards):
                step()
            torch.cuda.synchronize()
    by_name, launches, ours = {}, 0, {}
    conv_us, conv_calls = 0.0, 0  # the 3×3 convs: aten::conv2d with a (O, C, 3, 3) weight
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            if "daclip::" in e.name:  # the port's kernels by namespace (wrap, flash, …)
                ns = e.name.split("daclip::", 1)[1].split("::", 1)[0]
                ours[ns] = ours.get(ns, 0.0) + e.time_range.elapsed_us() / forwards / 1e3
        elif (e.name == "aten::conv2d" and len(e.input_shapes) > 1
              and list(e.input_shapes[1][-2:]) == [3, 3]):
            conv_calls += 1
            total = getattr(e, "device_time_total", None)  # cuda_time_total before torch 2.4
            conv_us += e.cuda_time_total if total is None else total
    kernel_ms = sum(by_name.values()) / forwards / 1e3
    conv_ms = conv_us / forwards / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit(phase="profile", wiring=wiring, what="one ConditionalUNet forward, 256x256, B=1, bf16",
         wall_ms_per_forward=wall_ms,
         device_kernel_ms_per_forward=kernel_ms if launches else None,
         device_busy_share=kernel_ms / wall_ms if launches else None,
         kernels_per_forward=launches / forwards,
         conv3x3_calls_per_forward=conv_calls / forwards,
         conv3x3_device_ms_per_forward=conv_ms if launches else None,
         conv3x3_share_of_device=conv_ms / kernel_ms if launches else None,
         daclip_ms_per_forward_by_namespace=ours,
         top=[dict(name=k[:90], ms_per_forward=v / forwards / 1e3) for k, v in top])


# -- phase 6 -------------------------------------------------------------------
def rel_err(got, want):
    """max |got − want| over max |want|, in f32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def wrap_grads(grads):
    """The wrap's six gradients by name, dW_qkv split into its q, k, v blocks
    so that a wrong dk cannot hide behind a large dq."""
    dx, dg_pre, dw_qkv, dw_out, db_out, dg_out = grads
    return dict(dx=dx, dg_pre=dg_pre, dw_q=dw_qkv[:, :128], dw_k=dw_qkv[:, 128:256],
                dw_v=dw_qkv[:, 256:], dw_out=dw_out, db_out=db_out, dg_out=dg_out)


def wgrad_yardstick(la, B, n, C, dtype, gen):
    """The weight-gradient launch alone at a wrap site, dW_qkv = xnᵀ·dqkv over
    the B·n rows (the larger of its two products), beside its one-call
    yardstick torch.matmul(xn.T, dqkv) on the same inputs (timed here only;
    device ms from torch.profiler)."""
    from daclip_torch.ops import _build

    xn = torch.randn(B * n, C, generator=gen, device="cuda").to(dtype)
    dqkv = torch.randn(B * n, 3 * la.HID, generator=gen, device="cuda").to(dtype)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    kernel = lambda: la._wgrad(lib, xn, dqkv, stream)
    library = lambda: torch.matmul(xn.t(), dqkv)
    got = kernel()
    want = torch.matmul(xn.float().t(), dqkv.float())  # f32, TF32 off
    err = rel_err(got, want)
    del want
    check(err <= WGRAD_LIMIT, f"wgrad {B * n, C, 3 * la.HID} rel err {err}")
    return dict(wgrad_rel_err=err,
                wgrad_ms=time_ms(kernel, iters=10),
                wgrad_device_ms=device_ms(kernel, "wgrad"),
                wgrad_library_ms=time_ms(library, iters=10),
                wgrad_library_device_ms=device_ms(library, ""))


def run_kernels_bwd():
    from daclip_torch.ops import flash_attention as fa
    from daclip_torch.ops import linear_attention as la

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {"wrap_bwd": [], "flash_bwd": []}
    for (B, n, C, dtype), balanced in [(s, b) for s in WRAP_BWD_SHAPES for b in (False, True)]:
        args = wrap_case(B, n, C, dtype, gen, balanced)
        dout = torch.randn(B, n, C, generator=gen, device="cuda").to(dtype)
        out, stats = la._forward_kernel(*args, keep_stats=True)
        got = wrap_grads(la.attn_wrap_bwd(*args, dout, stats=stats))
        torch.cuda.synchronize()
        # both calls again: forward (output and kept statistics) and backward
        out2, stats2 = la._forward_kernel(*args, keep_stats=True)
        again = wrap_grads(la.attn_wrap_bwd(*args, dout, stats=stats2))
        fwd_repeats = torch.equal(out, out2) and all(
            torch.equal(a, b) for a, b in zip(stats, stats2))
        repeats = all(torch.equal(got[k], again[k]) for k in got)
        del out2, stats2, again
        fargs = [a.float() for a in args]
        want_out = la.attn_wrap_reference(*fargs)
        fwd_err = (out.float() - want_out).abs()
        share = attention_share(want_out, fargs[0], fargs[4], fargs[5])
        fwd = dict(max_abs_err=float(fwd_err.max()), mean_abs_err=float(fwd_err.mean()),
                   limit=LIMITS[("wrap", dtype)], repeats_bitwise=fwd_repeats)
        del out, want_out, fwd_err
        want = wrap_grads(la.attn_wrap_bwd_reference(*fargs, dout.float()))
        errs = {k: rel_err(got[k], want[k]) for k in got}
        abs_err = max(float((got[k].float() - want[k]).abs().max()) for k in got)
        finite = all(bool(torch.isfinite(g).all()) for g in got.values())
        del want, fargs
        limit = BWD_LIMITS[("wrap", dtype)]
        row = dict(phase="kernels_bwd", kernel="attn_wrap_bwd", shape=[B, n, C],
                   dtype=str(dtype).split(".")[-1], balanced=balanced, forward=fwd,
                   rel_err=errs, max_rel_err=max(errs.values()), max_abs_err=abs_err,
                   limit=limit, repeats_bitwise=repeats, attention_share=share)
        if not balanced:
            row.update(wgrad_yardstick(la, B, n, C, dtype, gen))
            esize = args[0].element_size()
            nbytes = (3 * B * n * C + 2 * (C * 384 + 128 * C + 3 * C)) * esize
            bms, by = bound_ms(nbytes, 2 * B * n * (1536 * C + 20480), dtype)
            row.update(kernel_ms=time_ms(lambda: la.attn_wrap_bwd(*args, dout, stats=stats),
                                         iters=10),
                       device_ms=device_ms(lambda: la.attn_wrap_bwd(*args, dout, stats=stats),
                                           "daclip::wrap_bwd::", iters=5),
                       plain_ms=time_ms(lambda: la.attn_wrap_bwd_reference(*args, dout),
                                        iters=5, warmup=1),
                       bound_ms=bms, bound_by=by, library_ms=None)
        emit(**row)
        rows["wrap_bwd"].append(row)
        what = f"wrap bwd {B, n, C, dtype}" + (" balanced" if balanced else "")
        check(fwd["max_abs_err"] <= fwd["limit"], f"{what}: forward max err {fwd}")
        check(fwd_repeats, f"{what}: two forward calls differ")
        check(repeats, f"{what}: two backward calls differ")
        if dtype == torch.bfloat16:
            check(fwd["mean_abs_err"] <= WRAP_MEAN_LIMIT_BF16, f"{what}: forward mean err {fwd}")
        check(finite, f"{what} not finite")
        check(row["max_rel_err"] <= limit, f"{what} rel err {errs}")
        if balanced:
            check(share >= SIGNAL_MIN, f"{what}: the attention's share {share} is too small")
        del got, args, dout, stats
        torch.cuda.empty_cache()

    for B, N, H, D, dtype in FLASH_BWD_SHAPES:
        q, k, v, dout = [torch.randn(B, N, H * D, generator=gen, device="cuda").to(dtype)
                         for _ in range(4)]
        out, lse = fa._forward_kernel(q, k, v, H, D, True)
        bwd = lambda: fa.flash_self_attention_bwd(q, k, v, out, dout, H, D, lse=lse)
        got = dict(zip(("dq", "dk", "dv"), bwd()))
        torch.cuda.synchronize()
        repeats = all(torch.equal(a, b) for a, b in zip(got.values(), bwd()))
        want_out = fa.attention_reference(q.float(), k.float(), v.float(), H, D)
        fwd = dict(max_rel_err=rel_err(out, want_out),
                   max_abs_err=float((out.float() - want_out).abs().max()),
                   limit=LIMITS[("flash", dtype)])
        want = fa.attention_bwd_reference(q.float(), k.float(), v.float(), want_out,
                                          dout.float(), H, D)
        errs = {kk: rel_err(got[kk], w) for kk, w in zip(got, want)}
        abs_err = max(float((got[kk].float() - w).abs().max()) for kk, w in zip(got, want))
        del want, want_out
        limit = BWD_LIMITS[("flash", dtype)]
        heads = lambda t: t.view(B, N, H, D).transpose(1, 2)
        qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k, v))
        oh = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
        doh = heads(dout)
        lib = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)
        bms, by = bound_ms(8 * B * N * H * D * q.element_size(), 10 * B * H * N * N * D, dtype)
        row = dict(phase="kernels_bwd", kernel="flash_self_attention_bwd",
                   shape=[B, N, H, D], dtype=str(dtype).split(".")[-1], forward=fwd,
                   rel_err=errs, max_rel_err=max(errs.values()), max_abs_err=abs_err,
                   limit=limit, repeats_bitwise=repeats,
                   kernel_ms=time_ms(bwd, iters=10),
                   device_ms=device_ms(bwd, "daclip::flash_bwd::"),
                   plain_ms=time_ms(lambda: fa.attention_bwd_reference(
                       q, k, v, out, dout, H, D), iters=5, warmup=1),
                   bound_ms=bms, bound_by=by, library_ms=time_ms(lib, iters=10),
                   # its event time holds autograd's host time
                   library_device_ms=device_ms(lib, ""))
        emit(**row)
        rows["flash_bwd"].append(row)
        check(fwd["max_rel_err"] <= fwd["limit"],
              f"flash {B, N, H, D, dtype}: forward rel err {fwd}")
        check(all(bool(torch.isfinite(g).all()) for g in got.values()),
              f"flash bwd {B, N, H, D, dtype} not finite")
        check(row["max_rel_err"] <= limit, f"flash bwd {B, N, H, D, dtype} rel err {errs}")
        check(repeats, f"flash bwd {B, N, H, D, dtype}: two calls differ")
        del q, k, v, dout, out, lse, got, qh, kh, vh, oh, doh, bwd
        torch.cuda.empty_cache()
    return rows


# -- phase 7 -------------------------------------------------------------------
# the kernels each wiring's training step must launch
TRAIN_KERNELS = {"v5": ("wrap", "wrap_bwd", "flash", "flash_bwd"),
                 "v4_pointwise": ("fused_v4", "dual", "flash", "flash_bwd"),
                 "v3_pointwise": ("wrap_fused", "dual", "flash", "flash_bwd")}


def run_train_check(wiring="v5"):
    """A small UNet in f32 (TF32 off) whose level 0 runs the linear attention
    (in `wiring`) and whose level 1 and middle run SpatialTransformers: the
    loss and every gradient through the kernels against the plain versions,
    swapped into the UNet module here only; then 8 AdamW steps on one fixed
    draw."""
    from daclip_torch.models import unet as unet_mod
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.ops import flash_attention as fa
    from daclip_torch.ops import linear_attention as la
    from daclip_torch.ops import pointwise as pw
    from daclip_torch.sde import IRSDE
    from daclip_torch.train.restoration import (RestorationTrainConfig, init_state, loss_fn,
                                                make_train_step)

    kw = dict(nf=32, ch_mult=(1, 2), context_dim=64, use_degra_context=True,
              use_image_context=True, spatial_attn_min_level=1)
    net = ConditionalUNet(**kw, **ALT_CONFIGS.get(wiring, {}))
    net.load_state_dict(seeded_state_dict(lambda: ConditionalUNet(**kw), seed=5))
    net.train()
    sde = IRSDE(max_sigma=50, T=100)
    cfg = RestorationTrainConfig(niter=50, lr_G=1e-3, warmup_iter=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    gt = torch.rand(2, 3, 64, 64, generator=gen, device="cuda")
    lq = (gt + 0.1 * torch.randn(gt.shape, generator=gen, device="cuda")).clamp(0, 1)
    tctx, ictx = (torch.randn(2, 64, generator=gen, device="cuda") for _ in range(2))
    t, xt = sde.generate_random_states(gt, lq, torch.Generator(device="cuda").manual_seed(7))
    state = init_state(net, cfg, device="cuda")
    step = make_train_step(net, sde, cfg, device="cuda")

    def grads():
        net.zero_grad(set_to_none=True)
        loss = loss_fn(net, sde, cfg, xt, lq, gt, t, tctx, ictx)
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()
                             if p.grad is not None}

    reset_counts()
    loss_k, g_k = grads()
    calls = {k: read_counts()[k] for k in TRAIN_KERNELS[wiring]}
    plain = dict(attn_wrap=la.attn_wrap_reference, flash_self_attention=fa.attention_reference,
                 linear_attention_fused=la.fused_composition_reference,
                 attn_wrap_fused=la.attn_wrap_reference,
                 dual_conv1x1=pw.dual_conv1x1_reference)
    saved = {name: getattr(unet_mod, name) for name in plain}
    for name, fn in plain.items():
        setattr(unet_mod, name, fn)
    try:
        loss_p, g_p = grads()
    finally:
        for name, fn in saved.items():
            setattr(unet_mod, name, fn)
    check(set(g_k) == set(g_p), "kernel and plain runs give gradients to different tensors")
    errs = {k: rel_err(g_k[k], g_p[k]) for k in g_p if float(g_p[k].abs().max()) > 0}
    worst = max(errs, key=errs.get)

    losses = []
    for _ in range(8):  # the same (t, noise) draw each step
        state, m = step(state, dict(LQ=lq, GT=gt, text_context=tctx, image_context=ictx),
                        torch.Generator(device="cuda").manual_seed(7))
        losses.append(float(m["loss"]))
    row = dict(phase="train_check", wiring=wiring, unet=kw, loss_kernels=loss_k,
               loss_plain=loss_p, tensors=len(errs), worst_tensor=worst,
               worst_rel_err=errs[worst], limit=TRAIN_CHECK_LIMIT, calls=calls,
               adamw_losses=losses)
    emit(**row)
    check(all(c > 0 for c in calls.values()), f"train_check did not run every kernel: {calls}")
    check(abs(loss_k - loss_p) <= TRAIN_CHECK_LIMIT * abs(loss_p), "train_check loss differs")
    check(errs[worst] <= TRAIN_CHECK_LIMIT, f"train_check gradient of {worst}: {errs[worst]}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"8 AdamW steps did not lower the loss: {losses}")


# -- phase 8 -------------------------------------------------------------------
def run_train(steps=5, warmup=2, wiring="v5"):
    """The production training step at full width, as the JAX CLI composes it
    (cli/train_restoration.py:156-260): seeded UNet and DaCLIP weights,
    seeded 16 × 256² LQ/GT batches and their 224² CLIP views; the UNet in
    `wiring`. In the default wiring a checkpoint of the result restores."""
    import gc
    import tempfile

    from daclip_torch.convert import load_torch_state_dict
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig
    from daclip_torch.sde import IRSDE
    from daclip_torch.train.restoration import (RestorationTrainConfig, init_state,
                                                make_train_step)
    from daclip_torch.transforms import clip_transform
    from daclip_torch.utils.checkpoint import save_checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    B, P = 16, 256
    kw = dict(nf=64, ch_mult=(1, 2, 4, 8), context_dim=512, use_degra_context=True,
              use_image_context=True)
    unet = ConditionalUNet(dtype=torch.bfloat16, remat=P >= 256, **kw,
                           **ALT_CONFIGS.get(wiring, {}))
    unet.load_state_dict(seeded_state_dict(lambda: ConditionalUNet(**kw), seed=11))
    unet.train()
    clip_cfg = CLIPCfg.from_dict(get_model_config("daclip_ViT-B-32"))
    daclip_sd = seeded_state_dict(lambda: DaCLIP(clip_cfg), seed=12)
    daclip = DaCLIP(clip_cfg, dtype=torch.bfloat16)
    daclip.load_state_dict(daclip_sd, strict=True)
    daclip.cuda().eval().requires_grad_(False)
    sde = IRSDE(max_sigma=50, T=100, schedule="cosine", eps=0.005)
    cfg = RestorationTrainConfig()  # AdamW 2e-4, cosine, betas (0.9, 0.99), EMA 0.995/10
    state = init_state(unet, cfg, device="cuda")
    train_step = make_train_step(unet, sde, cfg, device="cuda")

    rng = np.random.RandomState(0)
    gt_np = rng.rand(B, P, P, 3).astype(np.float32)
    lq_np = np.clip(gt_np + 0.1 * rng.randn(B, P, P, 3), 0, 1).astype(np.float32)
    views_np = np.stack([clip_transform(im, clip_cfg.vision.image_size) for im in lq_np])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).cuda()
    gt, lq, views = dev(gt_np), dev(lq_np), dev(views_np)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def full_step():
        with torch.no_grad():
            img_f, degra_f = daclip.encode_image(views, control=True, normalize=True)
        batch = dict(LQ=lq, GT=gt, text_context=degra_f.float(), image_context=img_f.float())
        return train_step(state, batch, gen)

    fwd = 2 if unet.remat else 1  # remat runs each checkpointed forward twice
    want_calls = dict(zip(TRAIN_KERNELS[wiring], {
        "v5": (6 * fwd, 6, 3 * fwd, 3),
        "v4_pointwise": (6 * fwd, 9 * fwd, 3 * fwd, 3)}[wiring]))
    for _ in range(warmup):
        full_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records, totals = [], {}
    for i in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        _, m = full_step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        calls = {k: v for k, v in read_counts().items() if v}
        for k, v in calls.items():
            totals[k] = totals.get(k, 0) + v
        rec = dict(step=state.step, ms=ms, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]), lr=m["lr"], calls=calls)
        records.append(rec)
        emit(phase="train_step", wiring=wiring, **rec)
        check(np.isfinite([rec["loss"], rec["grad_norm"]]).all(), f"step {i} not finite")
        check(calls == want_calls, f"step {i}: kernel calls {calls}, expected {want_calls} "
              f"with remat={unet.remat}")
    step_ms = float(np.median([r["ms"] for r in records]))
    row = dict(phase="train" if wiring == "v5" else "train_alt", wiring=wiring,
               config=dict(B=B, patch=P, remat=unet.remat, dtype="bfloat16",
                           optimizer=cfg.optimizer, lr=cfg.lr_G, **kw,
                           **ALT_CONFIGS.get(wiring, {})),
               unet_params=sum(p.numel() for p in unet.parameters()),
               ms_per_step=[r["ms"] for r in records], median_ms_per_step=step_ms,
               samples_per_s=B * 1e3 / step_ms,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               calls_per_step=want_calls, ema_step=state.ema.step)
    if wiring != "v5":
        emit(**row)
        return full_step, step_ms, totals

    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, unet, state)
        restorer = DACLIPRestorer(RestorerConfig(), load_torch_state_dict(path), daclip_sd,
                                  device="cuda")
    out = restorer.restore(np.random.RandomState(1).rand(P, P, 3).astype(np.float32), seed=0,
                           return_uint8=False)
    row.update(restore_shape=list(out.shape), restore_finite=bool(np.isfinite(out).all()))
    emit(**row)
    check(row["restore_shape"] == [P, P, 3] and row["restore_finite"],
          "the saved EMA UNet did not restore a finite 256² image")
    del restorer
    return full_step, step_ms, totals


# -- phase 9 -------------------------------------------------------------------
def run_profile_train(full_step, step_ms, wiring="v5"):
    """Where one full-width training step's device time goes (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        full_step()
        torch.cuda.synchronize()
    by_name, launches, ours = {}, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            if "daclip::" in e.name:  # the port's kernels by namespace (wrap, flash_bwd, …)
                ns = e.name.split("daclip::", 1)[1].split("::", 1)[0]
                ours[ns] = ours.get(ns, 0.0) + e.time_range.elapsed_us() / 1e3
    kernel_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit(phase="profile_train", wiring=wiring,
         what="one training step, B=16, 256x256, bf16, remat",
         wall_ms_per_step_unprofiled=step_ms,
         device_kernel_ms_per_step=kernel_ms if launches else None,
         device_busy_share=kernel_ms / step_ms if launches else None,
         kernels_per_step=launches, daclip_ms_by_namespace=ours,
         top=[dict(name=k[:90], ms=v / 1e3) for k, v in top])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import daclip_torch  # noqa: F401  fails outside a checkout of the repo
    from daclip_torch.ops import _build

    if len(sys.argv) != 1:
        sys.exit(f"usage: {sys.argv[0]} (no arguments: every phase runs)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit(phase="device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib = _build.library()
    log = pathlib.Path(lib._name).with_suffix(".log")  # this library's build
    ptxas = ptxas_summary(log.read_text() if log.exists() else "")
    emit(phase="build", seconds=time.perf_counter() - t0, library=str(lib._name), ptxas=ptxas)
    # no instantiation of the linear-attention kernels may spill registers
    linattn = [ln for ln in ptxas if ln.startswith(("wrap::", "wrap_bwd::"))]
    spills = [ln for ln in linattn if not (re.search(r"(?<!\d)0 bytes spill stores", ln)
                                           and re.search(r"(?<!\d)0 bytes spill loads", ln))]
    check(linattn, "the build log names no linear-attention kernel")
    check(not spills, f"linear-attention kernels spill: {spills}")

    rows = run_kernels()
    alt_rows, core_path = run_kernels_alt()
    rows.update(alt_rows)
    conv_rows, conv_path = run_kernels_conv()
    rows.update(conv_rows)
    run_fixture()
    restorer, serve_totals, sds = run_serve()
    run_profile(restorer)
    serve_alt_totals, fwd = run_serve_alt(restorer, sds)
    forward_conv = run_forward_conv(restorer.unet, fwd)
    del restorer, sds, fwd
    rows.update(run_kernels_bwd())
    for wiring in TRAIN_KERNELS:
        run_train_check(wiring)
    full_step, step_ms, train_totals = run_train()
    run_profile_train(full_step, step_ms)
    del full_step
    full_step, step_ms, train_alt_totals = run_train(steps=3, wiring="v4_pointwise")
    run_profile_train(full_step, step_ms, wiring="v4_pointwise")
    del full_step

    # launches on each main path, each counted from 0 just before its run:
    # serve (the four requests), serve_alt (two requests per other wiring),
    # train (five timed steps), train_alt (three); for the attention core and
    # the 3×3 conv, which no model wiring calls, their paths in the kernels_alt
    # and kernels_conv phases, and the conv's in the hooked forward_conv
    paths = dict(serve=serve_totals, serve_alt=serve_alt_totals, train=train_totals,
                 train_alt=train_alt_totals, kernels=dict(core=core_path),
                 kernels_conv=dict(conv3x3=conv_path), forward_conv=dict(conv3x3=forward_conv))
    by_path = {key: {path: n[key] for path, n in paths.items() if n.get(key)}
               for key in kernel_counters()}
    bf16 = lambda key: [x for x in rows[key] if x["dtype"] == "bfloat16"]
    abs_err = {key: max(x["max_abs_err"] for x in bf16(key)) for key in rows}
    for fwd, bwd in (("wrap", "wrap_bwd"), ("flash", "flash_bwd")):
        # the forward also as training calls it, checked in kernels_bwd
        abs_err[fwd] = max(abs_err[fwd], *(x["forward"]["max_abs_err"] for x in bf16(bwd)))
    emit(phase="kernels_vs_library", what="each kernel's device ms over the one PyTorch call's "
         "on the same inputs (torch.profiler), where one computes the same function",
         rows=[dict(kernel=r["kernel"], shape=r["shape"], path=r.get("path"), form=r.get("form"),
                    over_library=r["device_ms"] / r["library_device_ms"])
               for key in ("flash", "dual", "flash_bwd", "conv3x3") for r in rows[key]
               if r.get("device_ms") and r.get("library_device_ms")])
    summary = []
    la_py, la_cu = "daclip_tpu/ops/linear_attention.py", "daclip_torch/csrc/linear_attention.cu"
    for key, name_, src, replaces, pick in (
            ("wrap", "attn_wrap", la_cu, f"{la_py}:491", 0),
            ("flash", "flash_self_attention", "daclip_torch/csrc/flash_attention.cu",
             "daclip_tpu/ops/flash_attention.py:68", 1),
            ("wrap_bwd", "attn_wrap_bwd", "daclip_torch/csrc/linear_attention_bwd.cu",
             f"{la_py}:885", 0),
            ("flash_bwd", "flash_self_attention_bwd",
             "daclip_torch/csrc/flash_attention_bwd.cu",
             "daclip_tpu/ops/flash_attention.py:199", 1),
            ("fused_v4", "linear_attention_fused", la_cu, f"{la_py}:310", 0),
            ("wrap_fused", "attn_wrap_fused", la_cu, f"{la_py}:199", 0),
            ("core", "linear_attention", la_cu, f"{la_py}:91", 0),
            ("dual", "dual_conv1x1", "daclip_torch/csrc/pointwise.cu",
             "daclip_tpu/ops/pointwise.py:121", 7),
            ("conv3x3", "conv3x3", "daclip_torch/csrc/conv3x3.cu",
             "daclip_tpu/ops/conv3x3.py:64", 0)):
        # the largest site of its path (dual: the single form; conv3x3: level 0)
        r = rows[key][pick]
        entry = dict(name=name_, route="cuda", source=src, replaces=replaces,
                     launches=sum(by_path[key].values()), launches_by_path=by_path[key],
                     shape=r["shape"], max_abs_err=abs_err[key])
        if "bwd" in key:
            entry.update(max_rel_err=max(x["max_rel_err"] for x in bf16(key)),
                         rel_err_is="max over gradients of max |kernel - plain| / max |plain|")
        elif key in ("flash", "core", "dual", "conv3x3"):
            rels = [x["max_rel_err"] for x in bf16(key)]
            if key == "flash":  # the forward also as training calls it
                rels += [x["forward"]["max_rel_err"] for x in bf16("flash_bwd")]
            entry.update(max_rel_err=max(rels), rel_err_is="max |kernel - plain| / max |plain|")
        check(entry["launches"] > 0, f"{name_} was launched no time on its path")
        if key == "wrap_bwd":  # its weight-gradient launch beside torch.matmul
            entry.update({k: r[k] for k in ("wgrad_ms", "wgrad_device_ms", "wgrad_library_ms",
                                            "wgrad_library_device_ms")})
        summary.append(dict(entry, ms=r["kernel_ms"], device_ms=r.get("device_ms"),
                            plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"],
                            library_device_ms=r.get("library_device_ms")))
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
