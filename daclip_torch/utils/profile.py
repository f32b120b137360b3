"""Model profiling — training/profile.py:18-133 equivalent: parameter counts
per tower, FLOPs of the forward passes, and a wallclock timer.

Counterpart of `daclip_tpu/utils/profile.py`, where XLA's cost analysis
counts the FLOPs of the compiled function. Here `torch.utils.flop_counter.
FlopCounterMode` counts them, which sees only matmuls and convolutions
(XLA counts elementwise operations too, so the two packages' `gflops` are
not the same number), and gives no bytes (`gbytes` is NaN).

The FLOPs are a property of the function, not of the device: `cost_analysis`
counts a module built inside `plain_path()`, on fake CPU tensors
(FakeTensorMode), so nothing is allocated or computed and every hand
kernel's wrapper takes its plain PyTorch version, which the counter can see
(a kernel is a ctypes call inside an autograd.Function, invisible to it).
The count is therefore the same whichever device the model runs on.
`count_params` counts a module's `parameters()`, each tensor once (the
DaCLIP state dict holds the image tower twice, as `clip.visual.*` and
`visual.*`).

CLI: python -m daclip_torch.utils.profile --model daclip_ViT-B-32 [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict

import torch


def count_params(params) -> int:
    """Elements of a module's `parameters()`, or of an iterable of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return int(sum(p.numel() for p in params))


@contextlib.contextmanager
def plain_path():
    """Tensors made inside are fake CPU tensors: shapes without storage, on
    which the kernel wrappers take their plain versions."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        yield


def cost_analysis(fn, *args) -> Dict[str, float]:
    """{"gflops": the FLOPs of fn(*args) / 1e9, "gbytes": NaN}, by
    FlopCounterMode, forward only. Build `fn`'s module and `args` inside
    `plain_path()`."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"gflops": counter.get_total_flops() / 1e9, "gbytes": float("nan")}


def wallclock_ms(fn, *args, iters: int = 10) -> float:
    """Mean host ms of fn(*args) after one warm-up call, the device
    synchronised before and after the loop."""
    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / iters * 1000


def clip_param_rows(model) -> Dict[str, int]:
    """The rows of daclip_tpu's profile: `clip.visual`, `clip.text` (the
    inlined text tower: token and positional embeddings, transformer,
    ln_final, text_projection), `visual_control` and `total`."""
    clip = model.clip
    text = [clip.token_embedding.weight, clip.positional_embedding,
            *clip.transformer.parameters(), *clip.ln_final.parameters(),
            clip.text_projection]
    return {"clip.visual": count_params(clip.visual), "clip.text": count_params(text),
            "visual_control": count_params(model.visual_control),
            "total": count_params(model)}


def profile_clip(model_name: str = "daclip_ViT-B-32", batch: int = 1, device=None):
    """Parameter counts (millions) of a DaCLIP built on `device` (default
    cuda) and the GFLOPs of `encode_image(control=True)` and `encode_text`
    at `batch`."""
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.pipeline import resolve_device

    cfg = CLIPCfg.from_dict(get_model_config(model_name))
    with torch.device(resolve_device(device)):
        rows = clip_param_rows(DaCLIP(cfg))
    with plain_path():
        model = DaCLIP(cfg)
        res = cfg.vision.image_size
        img = torch.zeros(batch, 3, res, res)
        txt = torch.zeros(batch, cfg.text.context_length, dtype=torch.long)
        return {
            "params": {k: v / 1e6 for k, v in rows.items()},
            "encode_image_control": cost_analysis(
                lambda x: model.encode_image(x, control=True), img),
            "encode_text": cost_analysis(model.encode_text, txt),
        }


def profile_unet(nf: int = 64, ch_mult=(1, 2, 4, 8), context_dim: int = 512,
                 size: int = 256, batch: int = 1, device=None):
    """Parameter count (millions) of a ConditionalUNet with both contexts
    built on `device` (default cuda) and the GFLOPs of its forward at
    size²."""
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.pipeline import resolve_device

    def build():
        return ConditionalUNet(nf=nf, ch_mult=tuple(ch_mult), context_dim=context_dim,
                               use_degra_context=True, use_image_context=True)

    with torch.device(resolve_device(device)):
        n = count_params(build())
    with plain_path():
        net = build()
        x = torch.zeros(batch, 3, size, size)
        ctx = torch.zeros(batch, context_dim)
        return {"params_M": n / 1e6,
                "forward": cost_analysis(lambda xt: net(xt, x, torch.ones(batch), ctx, ctx),
                                         x)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="daclip_ViT-B-32")
    p.add_argument("--unet-size", type=int, default=256)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    args = p.parse_args(argv)
    import json
    out = {"clip": profile_clip(args.model, args.batch, args.device),
           "unet": profile_unet(size=args.unet_size, batch=args.batch, device=args.device)}
    print(json.dumps(out, indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
