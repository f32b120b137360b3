"""Per-stage UNet wallclock breakdown (dev tool): times the production UNet's
stages in isolation — each level's ResBlock, its attention wrap and its
4×4 stride-2 downsample — to locate the sampler's bottleneck on the card.

Counterpart of `daclip_tpu/utils/stage_profile.py`, with its rows, their
order and names, through the port's `models/unet.py` modules: at `--size`
256 the four levels are 256² c64, 128² c128, 64² c256 and 32² c512; the
wrap is a LinearAttention (the `attn_wrap` kernel on the card) at levels
0-2 and a SpatialTransformer with context_dim 512 (its self-attention the
`flash_self_attention` kernel) at level 3. Weights and inputs are drawn
from a `torch.Generator` seeded with 0; activations run in `--dtype`
(channels_last on the card), under no_grad, as the sampler calls them. Each
row is the mean of 30 calls after one warm-up, timed on the host with the
device synchronised before and after the loop. `--device` defaults to cuda
(it never falls back).

  python -m daclip_torch.utils.stage_profile [--batch 4] [--size 256] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import torch


def timeit(fn, *args, iters=30):
    """Mean ms of fn(*args) over `iters` calls after one warm-up call."""
    def sync():
        if args[0].is_cuda:
            torch.cuda.synchronize(args[0].device)

    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / iters * 1000


@torch.no_grad()
def seed_module_(module: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    """Fill every parameter from `gen` (on the module's device): fan-in
    scaled weights, norm gains near 1, small biases."""
    for name, p in module.named_parameters():
        r = torch.randn(p.shape, generator=gen, device=p.device)
        if name.endswith(".g") or (name.endswith("weight") and p.ndim == 1):
            p.copy_(1 + 0.1 * r)
        elif p.ndim >= 2:
            p.copy_(r * p[0].numel() ** -0.5)
        else:
            p.copy_(0.02 * r)
    return module


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    B, S = args.batch, args.size
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    from daclip_torch.models.unet import AttnWrap, Downsample, ResBlock
    from daclip_torch.pipeline import resolve_device

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format

    def build(module):
        return seed_module_(module.to(dev).eval(), gen)

    results = {}
    t_emb = torch.randn(B, 256, generator=gen, device=dev).to(dtype)
    with torch.no_grad():
        for level, (res, ch) in enumerate([(S, 64), (S // 2, 128), (S // 4, 256),
                                           (S // 8, 512)]):
            x = torch.randn(B, ch, res, res, generator=gen, device=dev).to(
                dtype).contiguous(memory_format=fmt)
            rb = build(ResBlock(ch, ch, 256))
            results[f"L{level} resblock {res}px c{ch}"] = timeit(
                lambda xx: rb(xx, t_emb), x)

            spatial = level == 3
            aw = build(AttnWrap(ch, spatial, ch // 32, 512))
            ctx = (torch.randn(B, 1, 512, generator=gen, device=dev).to(dtype)
                   if spatial else None)
            results[f"L{level} {'spatial' if spatial else 'linattn'} {res}px c{ch}"] = \
                timeit(lambda xx: aw(xx, context=ctx), x)

            if level < 3:
                dn = build(Downsample(ch, ch * 2))
                results[f"L{level} down4x4 {res}px c{ch}->{ch*2}"] = timeit(dn, x)

    for k, v in results.items():
        print(f"{k:42s} {v:8.3f} ms")
    total_est = (2 * (results.get(f"L0 resblock {S}px c64", 0)) * 2
                 + 2 * results.get(f"L0 linattn {S}px c64", 0))
    print(f"(level-0 pair estimate: {total_est:.2f} ms of the forward)")
    return results


if __name__ == "__main__":
    main()
