"""Universal-restoration training CLI on the port (reference
config/daclip-sde/train.py:46-352).

Counterpart of `daclip_tpu/cli/train_restoration.py`: the options file's
datasets, UNet, IR-SDE and `train:` keys; the frozen DA-CLIP's contexts of
each batch under `no_grad` (or cached once per sample with
`cache_clip_contexts`); the step of `train/restoration.py` (bf16 UNet,
remat at patch ≥ 256, AdamW/Lion, EMA); `<step>.pt` checkpoints, each with
daclip_tpu's orbax step dir `<step>/` beside it (the whole TrainState, which
daclip_tpu's CLI resumes; written in the background inside the loop, as
daclip_tpu's is; the last five of each kept), with resume from the newest
of either; validation every `val_freq` steps,
the EMA UNet sampling up to 8 images, with the best PSNR tracked.

Usage:
  python -m daclip_torch.cli.train_restoration -opt configs/daclip-sde/train.yml

Several cards: one run over torchrun's processes, the options'
`batch_size` the global batch (each of the W processes takes batch_size / W
rows, as the reference's loader does), DDP by default, FSDP2 (HSDP) with
`--mesh data,fsdp` (daclip_tpu/cli/train_restoration.py:117-121, 221-238):
  torchrun --nproc_per_node 4 -m daclip_torch.cli.train_restoration \\
      -opt configs/daclip-sde/train.yml --mesh 2,2
Each rank draws its own t and noise (seeded by (seed, rank)); rank 0 alone
validates from the whole EMA parameters and writes the checkpoints (the
single-card files), the other ranks waiting. A `--mesh` whose product is
not the world size, or whose data-parallel ranks do not divide the batch,
exits before any work; the `model` axis is refused (the UNet has no
tensor-parallel layout in either package).

`--device` defaults to cuda and raises without a GPU unless given `cpu`.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from daclip_torch.data.loader import to_device
from daclip_torch.train.restoration import make_train_step

BATCH_KEYS = ("LQ", "GT", "LQ_clip", "image_context", "text_context")


def _precompute_contexts(ds, context_fn, log, chunk: int = 32):
    """One pass of the frozen DA-CLIP over the dataset's full-image CLIP
    views (`LQGTDataset.clip_view`): a context cache for every sample."""
    from daclip_torch.data.datasets import CachedContextDataset

    img_out, txt_out = [], []
    t0 = time.time()
    for s0 in range(0, len(ds), chunk):
        views = np.stack([ds.clip_view(i) for i in range(s0, min(s0 + chunk, len(ds)))])
        ic, tc = context_fn(views)
        img_out.append(ic.cpu().numpy())
        txt_out.append(tc.cpu().numpy())
    log.info("cached frozen DA-CLIP contexts for %d samples in %.1fs",
             len(ds), time.time() - t0)
    return CachedContextDataset(ds, np.concatenate(img_out), np.concatenate(txt_out))


def build_dataloaders(opt, num_hosts=1, host_id=0, context_fn=None, log=None):
    """(train loader, val dataset) from the options' `datasets:`."""
    from daclip_torch.data import DataLoader, IterSampler, create_dataset

    train_loader = val_ds = None
    for phase, dataset_opt in (opt["datasets"] or {}).items():
        phase = phase.split("_")[0]
        if phase == "train":
            ds = create_dataset(dataset_opt)
            if (dataset_opt.get("cache_clip_contexts") and context_fn is not None
                    and hasattr(ds, "clip_view")):
                ds = _precompute_contexts(ds, context_fn, log)
            elif dataset_opt.get("cache_clip_contexts"):
                (log or logging).warning(
                    "cache_clip_contexts ignored: %s",
                    "no frozen DA-CLIP tower" if context_fn is None else
                    f"{type(ds).__name__} has no deterministic clip_view "
                    "(MD/MDGT synthesize LQ per epoch)")
            ratio = dataset_opt.get("dataset_enlarge_ratio", 200)
            sampler = IterSampler(len(ds), host_id=host_id, num_hosts=num_hosts, ratio=ratio)
            train_loader = DataLoader(
                ds, batch_size=dataset_opt.get("batch_size", 16) // num_hosts,
                sampler=sampler, num_workers=min(dataset_opt.get("n_workers", 4), 8))
        elif phase == "val":
            val_ds = create_dataset(dataset_opt)
    return train_loader, val_ds


def train_config(train_opt, niter: int):
    """`RestorationTrainConfig` from the options' `train:` keys."""
    from daclip_torch.train.restoration import RestorationTrainConfig

    return RestorationTrainConfig(
        optimizer=train_opt.get("optimizer", "AdamW"),
        lr_G=float(train_opt.get("lr_G", 2e-4)),
        lr_scheme=train_opt.get("lr_scheme", "TrueCosineAnnealingLR"),
        beta1=float(train_opt.get("beta1", 0.9)),
        beta2=float(train_opt.get("beta2", 0.99)),
        niter=niter,
        warmup_iter=int(train_opt.get("warmup_iter", -1) or -1),
        lr_steps=tuple(train_opt.get("lr_steps") or ()),
        lr_gamma=float(train_opt.get("lr_gamma", 0.5)),
        eta_min=float(train_opt.get("eta_min", 1e-6)),
        weight_decay_G=float(train_opt.get("weight_decay_G") or 0.0),
        loss_type=train_opt.get("loss_type", "l1"),
        weight=float(train_opt.get("weight", 1.0)),
        restarts=tuple(train_opt.get("restarts") or ()),
        restart_weights=tuple(train_opt.get("restart_weights") or ()),
        is_weighted=bool(train_opt.get("is_weighted", False)),
        grad_clip=(float(train_opt["gradient_clipping"])
                   if train_opt.get("gradient_clipping") else None),
        # the reference's EMA(model, beta=0.995, update_every=10)
        # (denoising_model.py:118), overridable for short runs
        ema_beta=float(train_opt.get("ema_beta", 0.995)),
        ema_update_every=int(train_opt.get("ema_update_every", 10)),
    )


def make_sde(sde_opt, sample_T: int = -1):
    from daclip_torch.sde import IRSDE

    return IRSDE(max_sigma=sde_opt.get("max_sigma", 50), T=sde_opt.get("T", 100),
                 sample_T=sample_T, schedule=sde_opt.get("schedule", "cosine"),
                 eps=sde_opt.get("eps", 0.005))


def unet_kwargs(opt) -> dict:
    """ConditionalUNet arguments from `network_G.setting` (remat on for
    patches of 256 and more, as the JAX CLI sets it for the v5e's memory)."""
    net_opt = (opt["network_G"] or {}).get("setting", {}) or {}
    patch = opt["datasets"]["train"].get("patch_size", 256)
    return dict(in_nc=net_opt.get("in_nc", 3), out_nc=net_opt.get("out_nc", 3),
                nf=net_opt.get("nf", 64), ch_mult=tuple(net_opt.get("ch_mult", (1, 2, 4, 8))),
                context_dim=net_opt.get("context_dim", 512),
                use_degra_context=bool(net_opt.get("use_degra_context", True)),
                use_image_context=bool(net_opt.get("use_image_context", True)),
                scale=float(net_opt.get("scale", 1.0) or 1.0),
                remat=bool(net_opt.get("remat", patch >= 256)))


def load_daclip(opt, device):
    """The context function of the frozen bf16 DaCLIP of `path.daclip`
    (ViT-L-14 when the UNet's context is 768-d, else ViT-B-32, unless
    `path.daclip_model` names one): views → (image, degradation) float32
    features; None when the file is absent."""
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.utils.native_checkpoint import load_daclip_any

    path = (opt["path"] or {}).get("daclip")
    if not path or not os.path.exists(str(path)):
        return None
    net_opt = (opt["network_G"] or {}).get("setting", {}) or {}
    name = ((opt["path"] or {}).get("daclip_model")
            or ("daclip_ViT-L-14" if (net_opt.get("context_dim") or 512) == 768
                else "daclip_ViT-B-32"))
    clip_cfg = CLIPCfg.from_dict(get_model_config(name))
    sd = load_daclip_any(str(path), clip_cfg.vision.image_size, clip_cfg.vision.patch_size)
    daclip = DaCLIP(clip_cfg, dtype=torch.bfloat16)
    daclip.load_state_dict({k: v for k, v in sd.items() if not k.startswith("predictor.")},
                           strict=True)
    daclip.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def context_fn(views):
        """(N, 224, 224, 3) numpy views or NCHW device tensor → contexts."""
        if isinstance(views, np.ndarray):
            views = to_device({"v": views}, device)["v"]
        img_f, degra_f = daclip.encode_image(views, control=True, normalize=True)
        return img_f.float(), degra_f.float()

    return context_fn


def make_step(unet, sde, cfg, device, context_fn):
    """step(state, numpy batch, generator): the batch to the device, the
    frozen DA-CLIP's contexts from 'LQ_clip' (unless the batch carries
    cached ones), then the train step."""
    train_step = make_train_step(unet, sde, cfg, device=device)
    keys = BATCH_KEYS if context_fn is not None else tuple(k for k in BATCH_KEYS
                                                           if k != "LQ_clip")

    def step(state, batch, generator):
        dev = to_device(batch, device, keys)
        if "LQ_clip" in dev:
            dev["image_context"], dev["text_context"] = context_fn(dev.pop("LQ_clip"))
        return train_step(state, dev, generator)

    return step


def _generator(device, *seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(hash(seed) & (2 ** 63 - 1))


def _rank_generator(device, rank: int, *seed: int) -> torch.Generator:
    """Rank 0 draws as one process does; rank r > 0 from (seed…, r)."""
    return _generator(device, *seed) if rank == 0 else _generator(device, *seed, rank)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-opt", required=True)
    p.add_argument("--max-steps", type=int, default=None, help="override niter (smoke runs)")
    p.add_argument("--val-sample-T", type=int, default=-1,
                   help="shorter sampler for validation")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly (the reference's detect_anomaly)")
    p.add_argument("--mesh", default=None,
                   help="'data[,fsdp]' over the world size (default: all on data, DDP)")
    p.add_argument("--dist-url", default="env://",
                   help="process group rendezvous: env:// (torchrun), tcp:// or file://")
    p.add_argument("--dist-backend", default=None,
                   help="nccl on cuda (default), gloo on the cpu or when asked")
    p.add_argument("--no-set-device-rank", action="store_true",
                   help="do not pin cuda:LOCAL_RANK")
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    args = p.parse_args(argv)

    from daclip_torch import config as cfg_mod
    from daclip_torch import parallel
    from daclip_torch.data import native_io
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.train.restoration import init_state, make_sampler
    from daclip_torch.utils import metrics
    from daclip_torch.utils.checkpoint import (checkpoint_path, restore_checkpoint, resume_point,
                                               save_checkpoint, start_writer)

    rank, world, _, device = parallel.initialize_distributed(
        args.dist_url, args.dist_backend, args.device, not args.no_set_device_rank)
    opt = cfg_mod.parse(args.opt, is_train=True)
    native_io.load()  # the image decoder is built at start-up, not in the first step
    try:
        if parallel.parse_mesh(args.mesh, world)[2] > 1:
            raise ValueError(f"--mesh {args.mesh}: the model axis is not carried by the "
                             "restoration trainer (the UNet has no tensor-parallel layout)")
        mesh = parallel.mesh_from_spec(args.mesh, world, device.type,
                                       batch_size=opt["datasets"]["train"].get("batch_size", 16))
    except ValueError as e:
        raise SystemExit(str(e)) from None
    host0 = rank == 0
    logging.basicConfig(level=logging.INFO if host0 else logging.WARNING,
                        format="%(asctime)s %(message)s")
    log = logging.getLogger("train")
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    train_opt = opt["train"] or {}
    niter = args.max_steps or int(train_opt.get("niter", 700000))
    cfg = train_config(train_opt, niter)
    sde_opt = opt["sde"] or {}
    sde = make_sde(sde_opt)
    kw = unet_kwargs(opt)
    B = opt["datasets"]["train"].get("batch_size", 16)

    context_fn = None
    if kw["use_degra_context"] or kw["use_image_context"]:
        context_fn = load_daclip(opt, device)
        if context_fn is None:
            log.warning("no daclip checkpoint at %s — training without contexts",
                        (opt["path"] or {}).get("daclip"))

    # init from manual_seed, then resume from the newest checkpoint: the
    # port's <step>.pt or daclip_tpu's orbax step dir <step>/ (its whole
    # TrainState: parameters, optimizer moments, EMA, step), the .pt on a tie
    torch.manual_seed(train_opt.get("manual_seed", 0) or 0)
    unet = ConditionalUNet(dtype=torch.bfloat16, **kw)
    wrapped = parallel.parallelize(unet.to(device), mesh, device, static_graph=True)
    state = init_state(unet, cfg, device=device)
    ckpt_dir = opt["path"]["training_state"]
    start_step = 0
    found = resume_point(ckpt_dir) if ckpt_dir else None
    if found is not None:
        kind, n = found
        restore_checkpoint(ckpt_dir, wrapped, state, step=n, cfg=cfg)
        start_step = state.step
        log.info("resumed from step %d", start_step)
        where = (f"daclip_tpu's orbax step dir {os.path.join(ckpt_dir, str(n))}"
                 if kind == "orbax" else f"the port's {os.path.join(ckpt_dir, f'{n}.pt')}")
        log.info("resumed from %s", where)
    step_fn = make_step(wrapped, sde, cfg, device, context_fn)
    log.info("rank %d of %d, mesh %s", rank, world, None if mesh is None else mesh.shape)

    train_loader, val_ds = build_dataloaders(opt, num_hosts=world, host_id=rank,
                                             context_fn=context_fn, log=log)
    val_freq = int(train_opt.get("val_freq", 1e4))
    save_freq = int((opt["logger"] or {}).get("save_checkpoint_freq", 1e4))
    print_freq = int((opt["logger"] or {}).get("print_freq", 200))

    # validation samples with the EMA parameters, on a copy of the UNet
    val_unet = ConditionalUNet(dtype=torch.bfloat16, **dict(kw, remat=False)).eval()
    val_sampler = make_sampler(val_unet, make_sde(sde_opt, args.val_sample_T), device=device)
    best_psnr, best_step = -1.0, -1

    def run_val(step):
        """Rank 0 samples with the whole EMA parameters; the others wait."""
        nonlocal best_psnr, best_step
        if val_ds is None:
            return
        ema = parallel.full_tensors(state.ema.params)
        if not host0:
            parallel.barrier()
            return
        val_unet.load_state_dict(ema, strict=True)
        psnrs = []
        for i in range(min(len(val_ds), 8)):
            s = val_ds[i]
            hh, ww = (s["LQ"].shape[0] // 16) * 16, (s["LQ"].shape[1] // 16) * 16
            lq, gt = s["LQ"][:hh, :ww], s["GT"][:hh, :ww]
            tctx = ictx = None
            if context_fn is not None:
                ictx, tctx = context_fn(s["LQ_clip"][None])
            out = val_sampler(to_device({"x": lq[None]}, device)["x"], _generator(device, i),
                              tctx if kw["use_degra_context"] else None,
                              ictx if kw["use_image_context"] else None)
            out = out[0].permute(1, 2, 0).float().cpu().numpy()
            psnrs.append(metrics.calculate_psnr(metrics.array2img(out),
                                                metrics.array2img(gt)))
        psnr = float(np.mean(psnrs))
        if psnr > best_psnr:
            best_psnr, best_step = psnr, step
        log.info("# val step %d: psnr %.4f (best %.4f @ %d)", step, psnr, best_psnr, best_step)
        parallel.barrier()

    if host0 and ckpt_dir and save_freq and start_step < niter:
        # the in-loop saves' step dirs are written by the writer process
        start_writer(("daclip_torch.utils.native_checkpoint",))
    log.info("training from step %d to %d", start_step, niter)
    step = start_step
    t0 = time.time()
    epoch = 0
    while step < niter:
        train_loader.set_epoch(epoch)
        for batch in train_loader:
            state, m = step_fn(state, batch, _rank_generator(device, rank, 1234, step))
            step += 1
            if step % print_freq == 0:
                ips = print_freq * B / (time.time() - t0)  # B: the global batch
                t0 = time.time()
                log.info("step %d loss %.5f lr %.2e %.1f samples/s",
                         step, float(m["loss"]), float(m["lr"]), ips)
            if val_freq and step % val_freq == 0:
                run_val(step)
            if ckpt_dir and save_freq and step % save_freq == 0:
                # <step>.pt, and daclip_tpu's <step>/ written in the background
                save_checkpoint(ckpt_dir, wrapped, state, max_to_keep=5, cfg=cfg, wait=False)
                log.info("saving checkpoint @ %d (async): %s and %s", step,
                         checkpoint_path(ckpt_dir, step), os.path.join(ckpt_dir, str(step)))
            if step >= niter:
                break
        epoch += 1
    if ckpt_dir:
        save_checkpoint(ckpt_dir, wrapped, state, max_to_keep=5, cfg=cfg)
        log.info("saved checkpoint @ %d: %s and %s", step, checkpoint_path(ckpt_dir, step),
                 os.path.join(ckpt_dir, str(step)))
    run_val(step)
    log.info("done: best psnr %.4f @ step %d", best_psnr, best_step)
    return {"best_psnr": best_psnr, "best_step": best_step, "final_step": step}


if __name__ == "__main__":
    main()
