"""Drive the PyTorch/CUDA port (daclip_torch) on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing JSON lines:
  0 device   the card (nvidia-smi name and power limit), torch and CUDA versions
  1 build    nvcc builds daclip_torch/csrc/*.cu (one process per source)
  2 kernels  each kernel against its plain PyTorch version at every shape the
             restore path gives it (the wrap also on inputs where the
             attention is as large as the bias, at each shape); times (median of CUDA-event timed runs
             after warm-up), the bound, and for flash the one-call PyTorch
             yardstick (scaled_dot_product_attention, timed here only)
  3 fixture  the committed golden fixture replayed through the kernels in f32
  4 serve    the production restore path at full width (ViT-B-32 DaCLIP, UNet
             nf=64 ch_mult 1,2,4,8, context 512, bf16, 100 posterior steps) on
             seeded random weights: four requests through DACLIPRestorer, with
             the kernels' launch counts per request
  5 profile  one sampler step (a UNet forward at 256²): wall time, device
             kernel time by name (torch.profiler)
Then the per-kernel summary line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero;
without a CUDA device it exits non-zero before printing any result.
"""
import json
import pathlib
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
LIMITS = {("wrap", torch.bfloat16): 0.1, ("wrap", torch.float32): 1e-3,
          ("flash", torch.bfloat16): 2e-2, ("flash", torch.float32): 1e-4}
WRAP_MEAN_LIMIT_BF16 = 1e-2
# on balanced wrap inputs the attention's share of the output (the plain
# output minus the plain output with no attention) must be of order 1
SIGNAL_MIN = 0.3


def emit(**kw):
    print(json.dumps(kw), flush=True)


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


def bound_ms(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
        fargs = [a.float() for a in args]
        want = la.attn_wrap_reference(*fargs)
        err = (got.float() - want).abs()
        limit = LIMITS[("wrap", dtype)]
        row = dict(phase="kernels", kernel="attn_wrap", shape=[B, n, C],
                   dtype=str(dtype).split(".")[-1], balanced=balanced,
                   max_abs_err=float(err.max()), mean_abs_err=float(err.mean()), limit=limit,
                   attention_share=attention_share(want, fargs[0], fargs[4], fargs[5]))
        if not balanced:  # time each shape once
            esize = args[0].element_size()
            nbytes = (2 * B * n * C + C * 384 + 128 * C + 3 * C) * esize
            bms, by = bound_ms(nbytes, 2 * B * n * (512 * C + 8192), dtype)
            row.update(kernel_ms=time_ms(lambda: la.attn_wrap(*args)),
                       plain_ms=time_ms(lambda: la.attn_wrap_reference(*args)),
                       bound_ms=bms, bound_by=by, library_ms=None)
        emit(**row)
        rows["wrap"].append(row)
        what = f"wrap {B, n, C, dtype}" + (" balanced" if balanced else "")
        check(torch.isfinite(got).all().item(), f"{what} not finite")
        check(row["max_abs_err"] <= limit, f"{what} max err {row['max_abs_err']}")
        if dtype == torch.bfloat16:
            check(row["mean_abs_err"] <= WRAP_MEAN_LIMIT_BF16,
                  f"{what} mean err {row['mean_abs_err']}")
        if balanced:
            check(row["attention_share"] >= SIGNAL_MIN,
                  f"{what}: the attention's share {row['attention_share']} is too small")

    for B, N, H, D, dtype in FLASH_SHAPES:
        q, k, v = [torch.randn(B, N, H * D, generator=gen, device="cuda").to(dtype)
                   for _ in range(3)]
        got = fa.flash_self_attention(q, k, v, H, D)
        torch.cuda.synchronize()
        want = fa.attention_reference(q.float(), k.float(), v.float(), H, D)
        err = float((got.float() - want).abs().max())
        limit = LIMITS[("flash", dtype)]
        heads = lambda t: t.view(B, N, H, D).transpose(1, 2)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            heads(q), heads(k), heads(v))
        bms, by = bound_ms(4 * B * N * H * D * q.element_size(), 4 * B * H * N * N * D, dtype)
        row = dict(phase="kernels", kernel="flash_self_attention", shape=[B, N, H, D],
                   dtype=str(dtype).split(".")[-1], max_abs_err=err, limit=limit,
                   kernel_ms=time_ms(lambda: fa.flash_self_attention(q, k, v, H, D)),
                   plain_ms=time_ms(lambda: fa.attention_reference(q, k, v, H, D)),
                   bound_ms=bms, bound_by=by, library_ms=time_ms(lib))
        emit(**row)
        rows["flash"].append(row)
        check(err <= limit, f"flash {B, N, H, D, dtype} max err {err}")
    return rows


# -- phase 3 -------------------------------------------------------------------
def run_fixture():
    from daclip_torch.convert import infer_unet_arch, load_torch_state_dict
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.ops import flash_attention as fa
    from daclip_torch.ops import linear_attention as la
    from daclip_torch.sde import IRSDE

    meta = json.loads((FIXTURE / "meta.json").read_text())
    arrs = np.load(FIXTURE / "arrays.npz")
    daclip = DaCLIP(CLIPCfg.from_dict(get_model_config(meta["model_name"])))
    daclip.load_state_dict(load_torch_state_dict(str(FIXTURE / "daclip.pt")), strict=True)
    sd = load_torch_state_dict(str(FIXTURE / "unet.pth"))
    arch = infer_unet_arch(sd)
    unet = ConditionalUNet(**{k: v for k, v in arch.items() if k not in ("in_nc", "out_nc")})
    unet.load_state_dict(sd, strict=True)
    daclip.cuda().eval()
    unet.cuda().eval()
    sde = IRSDE(max_sigma=meta["max_sigma"], T=meta["T"], schedule=meta["schedule"],
                eps=meta["eps"])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3))).cuda()
    la.attn_wrap.launches = fa.flash_self_attention.launches = 0
    with torch.no_grad():
        img_ctx, degra_ctx = daclip.encode_image(dev(arrs["img4clip"][None]), control=True)
        out = sde.reverse_posterior(unet, dev(arrs["x_T"][None]), dev(arrs["lq"][None]),
                                    noises=dev(arrs["noises"]), text_context=degra_ctx,
                                    image_context=img_ctx)
    torch.cuda.synchronize()
    ours = out[0].cpu().numpy().transpose(1, 2, 0)
    row = dict(phase="fixture", psnr_vs_ref_out=psnr(ours, arrs["ref_out"]),
               psnr_vs_gt=psnr(ours, arrs["gt"]), ref_psnr_vs_gt=meta["ref_psnr_vs_gt"],
               wrap_launches=la.attn_wrap.launches,
               flash_launches=fa.flash_self_attention.launches)
    emit(**row)
    check(row["psnr_vs_ref_out"] > 40.0, "fixture replay below 40 dB vs ref_out")
    check(row["wrap_launches"] > 0 and row["flash_launches"] > 0,
          "fixture replay did not launch both kernels")


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

    cfg = RestorerConfig()  # production: ViT-B-32, nf 64, (1,2,4,8), ctx 512, bf16, T=100
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
             max_memory_allocated=torch.cuda.max_memory_allocated())
        check([o.shape for o in outs] == shapes, f"{name} output shapes")
        check(finite, f"{name} output not finite")
        check(wrap_n == 6 * steps and flash_n == 3 * steps,
              f"{name}: {wrap_n} wrap / {flash_n} flash launches, expected "
              f"{6 * steps} / {3 * steps} for one {steps}-step sampler run")
    return restorer, totals


def run_profile(restorer, forwards=5):
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                step()
            torch.cuda.synchronize()
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            launches += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    kernel_ms = sum(by_name.values()) / forwards / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit(phase="profile", what="one ConditionalUNet forward, 256x256, B=1, bf16",
         wall_ms_per_forward=wall_ms,
         device_kernel_ms_per_forward=kernel_ms if launches else None,
         device_busy_share=kernel_ms / wall_ms if launches else None,
         kernels_per_forward=launches / forwards,
         top=[dict(name=k[:90], ms_per_forward=v / forwards / 1e3) for k, v in top])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import daclip_torch  # noqa: F401  fails outside a checkout of the repo
    from daclip_torch.ops import _build

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
    ptxas = [ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0, library=str(lib._name),
         ptxas=ptxas[:16])

    rows = run_kernels()
    run_fixture()
    restorer, totals = run_serve()
    run_profile(restorer)

    summary = []
    for key, name_, src, replaces in (
            ("wrap", "attn_wrap", "daclip_torch/csrc/linear_attention.cu",
             "daclip_tpu/ops/linear_attention.py:491"),
            ("flash", "flash_self_attention", "daclip_torch/csrc/flash_attention.cu",
             "daclip_tpu/ops/flash_attention.py:68")):
        r = rows[key][0] if key == "wrap" else rows[key][1]  # the largest 256² site
        err = max(x["max_abs_err"] for x in rows[key] if x["dtype"] == "bfloat16")
        summary.append(dict(name=name_, route="cuda", source=src, replaces=replaces,
                            launches=totals[key], shape=r["shape"],
                            max_abs_err=err, ms=r["kernel_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
