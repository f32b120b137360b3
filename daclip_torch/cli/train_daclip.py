"""CLIP / DA-CLIP training CLI on one card — the `python -m training.main`
equivalent (reference da-clip/src/training/main.py:71-498).

Counterpart of `daclip_tpu/cli/train_daclip.py:70-478`: the reference's flag
surface (`cli/params.py`), the run's name and log dir, the CSV or synthetic
dataset with the level banks, the factory's model, LiT locking, the
distillation teacher, the trainer of `train/clip_train.py` (the two-pass
accumulation at `--accum-freq` > 1), `--resume latest` (weights, AdamW
moments, step and epoch), `results.jsonl`, validation through
`eval.retrieval.evaluate` every `--val-frequency` epochs, and the
`epoch_<n>.pt` checkpoints every `--save-frequency` epochs (the last three
kept, one with `--delete-previous-checkpoint`), in `latest/` between them
with `--save-most-recent`, and the best epoch by mean train loss in `best/`
(main.py:426-459). The log line and the jsonl keys are the JAX CLI's.

Usage (da-clip/src/single_train.sh):
  python -m daclip_torch.cli.train_daclip --train-data data/train.csv --da \\
      --model daclip_ViT-B-32 --pretrained pretrained/ViT-B-32.pt \\
      --batch-size 128 --epochs 50 --lr 2e-5 --device cuda

`--device` defaults to cuda and raises without a GPU unless given `cpu`.
Flags this CLI does not carry yet exit before any work, naming the ROADMAP
item that holds them: `--mesh` past one device, webdataset data,
`--remote-sync`, ImageNet zero-shot, `--force-patch-dropout`,
`--report-to wandb`. `--fast-clip-view` trains on cv2's decode and resize
(`transforms.image_transform(backend="cv2")`), as daclip_tpu's does: the
same crop draws, not PIL's bytes.
"""
from __future__ import annotations

import logging
import os
import random
import shutil
import sys
import time
from functools import partial

import numpy as np
import torch

from daclip_torch.cli.params import parse_args

_ITEM = {"4": "ROADMAP queue 1 item 4, waiting", "6": "ROADMAP queue 1 item 6"}


def _given(argv, flag: str) -> bool:
    return any(a == flag or a.startswith(flag + "=") for a in argv)


def refuse_unported(args, argv) -> None:
    """Exit, naming its ROADMAP item, on a flag this CLI does not carry."""
    refused = []
    if args.mesh not in (None, "1", "none"):
        refused.append(("--mesh", "multi-card training (fsdp/TP mesh, DDP global negatives)",
                        "6"))
    if args.dataset_type == "webdataset" or (
            args.dataset_type == "auto" and args.train_data
            and ("::" in args.train_data or args.train_data.endswith(".tar")
                 or "{" in args.train_data)):
        refused.append(("--dataset-type webdataset", "data/webdataset.py", "4"))
    if args.remote_sync:
        refused.append(("--remote-sync", "remote sync of the log dir", "4"))
    if args.imagenet_val or args.imagenet_v2 or (
            _given(argv, "--zeroshot-frequency") and args.zeroshot_frequency):
        refused.append(("--imagenet-val/--zeroshot-frequency",
                        "ImageNet zero-shot during training", "4"))
    if args.force_patch_dropout is not None:
        refused.append(("--force-patch-dropout", "patch dropout", "4"))
    if "wandb" in args.report_to.split(","):
        refused.append(("--report-to wandb", "wandb reporting", "4"))
    if refused:
        flag, what, item = refused[0]
        raise SystemExit(f"{flag}: {what} is not ported to daclip_torch yet ({_ITEM[item]})")


def _setup_logging(log_base: str, debug: bool):
    """Console + <log_base>/out.log (reference setup_logging, logger.py:5-28),
    replacing this CLI's handlers of an earlier call in the process."""
    root = logging.getLogger()
    root.setLevel(logging.DEBUG if debug else logging.INFO)
    for h in [h for h in root.handlers if getattr(h, "_daclip", False)]:
        root.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
    os.makedirs(log_base, exist_ok=True)
    for h in (logging.StreamHandler(), logging.FileHandler(os.path.join(log_base, "out.log"))):
        h.setFormatter(fmt)
        h._daclip = True
        root.addHandler(h)
    return logging.getLogger("daclip")


def build_data(args, pp_train, pp_val, tokenizer, image_size: int = 224):
    """(train loader, banks or None, val dataset or None), as the JAX CLI
    builds them (training/data.py:640-660 dispatch). With
    `--fast-clip-view` the CSV train set decodes with cv2 and takes the cv2
    train view at `image_size` (daclip_tpu/cli/train_daclip.py:158-179)."""
    from daclip_torch.data.csv_dataset import CsvDataset, SyntheticDataset
    from daclip_torch.data.loader import DataLoader

    if args.dataset_type == "synthetic" or (args.dataset_type == "auto"
                                            and not args.train_data):
        ds = SyntheticDataset(pp_train, dataset_size=args.train_num_samples or 512,
                              tokenizer=tokenizer, da=args.da)
    else:
        if args.fast_clip_view:
            from daclip_torch.transforms import image_transform

            pp_train = image_transform(image_size, is_train=True, mean=args.image_mean,
                                       std=args.image_std, rng=random.Random(args.seed),
                                       backend="cv2")
        ds = CsvDataset(args.train_data, pp_train, args.csv_img_key, args.csv_caption_key,
                        args.csv_separator, tokenizer=tokenizer, da=args.da, crop=args.crop,
                        seed=args.seed, decode="cv2" if args.fast_clip_view else "pil")
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True,
                        num_workers=args.workers, seed=args.seed)
    val_ds = None
    if args.val_data:
        val_ds = CsvDataset(args.val_data, pp_val, args.csv_img_key, args.csv_caption_key,
                            args.csv_separator, tokenizer=tokenizer, da=args.da)
    return loader, ds.banks(), val_ds


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    refuse_unported(args, argv)

    from daclip_torch.data.loader import to_device
    from daclip_torch.eval.retrieval import evaluate as eval_retrieval
    from daclip_torch.factory import create_model, create_model_and_transforms
    from daclip_torch.pipeline import resolve_device
    from daclip_torch.tokenizer import tokenize
    from daclip_torch.train.clip_train import (ClipTrainConfig, init_state,
                                               make_accum_train_step, make_train_step,
                                               partition_daclip_params)
    from daclip_torch.train.locking import build_update_mask
    from daclip_torch.utils.checkpoint import (EPOCH, latest_step, restore_clip_checkpoint,
                                               save_clip_checkpoint)
    from daclip_torch.utils.logging import MetricWriter

    device = resolve_device(args.device)
    if args.name is None:  # run identity (main.py:90-104)
        args.name = "-".join([time.strftime("%Y_%m_%d-%H_%M_%S"),
                              f"model_{args.model.replace('/', '-')}",
                              f"lr_{args.lr}", f"b_{args.batch_size}", f"p_{args.precision}"])
    log_base = os.path.join(args.logs, args.name)
    ckpt_dir = os.path.join(log_base, "checkpoints")
    log = _setup_logging(log_base, args.debug)
    os.makedirs(ckpt_dir, exist_ok=True)
    if args.copy_codebase:  # main.py:478-498
        dst = os.path.join(log_base, "code", "daclip_torch")
        if not os.path.exists(dst):
            shutil.copytree(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), dst,
                            ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "build"))
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    log.info("device: %s", device)

    # DA mode is implied by a daclip_* model (single_train.sh passes both)
    args.da = args.da or "daclip" in args.model
    model, pp_train, pp_val = create_model_and_transforms(
        args.model, pretrained=args.pretrained or None, precision=args.precision,
        use_predictor=args.da and not args.uir_variant, image_mean=args.image_mean,
        image_std=args.image_std, seed=args.seed, force_quick_gelu=args.force_quick_gelu,
        force_image_size=args.force_image_size[0] if args.force_image_size else None,
        remat=args.grad_checkpointing, rng=random.Random(args.seed))
    if args.pretrained:
        log.info("loaded pretrained weights: %s", args.pretrained)
    tokenizer = partial(tokenize, context_length=model.cfg.text.context_length)
    loader, banks, val_ds = build_data(args, pp_train, pp_val, tokenizer,
                                       model.cfg.vision.image_size)

    trainable, _ = partition_daclip_params(model)
    update_mask = build_update_mask(
        [n for n, _ in trainable], lock_image=args.lock_image,
        lock_image_unlocked_groups=args.lock_image_unlocked_groups, lock_text=args.lock_text,
        lock_text_unlocked_layers=args.lock_text_unlocked_layers,
        lock_text_freeze_layer_norm=args.lock_text_freeze_layer_norm)
    if update_mask is not None:
        log.info("LiT locking active (image=%s text=%s)", args.lock_image, args.lock_text)

    teacher = None
    if args.distill_model:  # main.py:219-243
        teacher = create_model(args.distill_model, pretrained=args.distill_pretrained,
                               precision=args.precision, seed=args.seed).eval()
        log.info("distilling from %s (%s)", args.distill_model, args.distill_pretrained)

    steps_per_epoch = max(len(loader), 1)
    opt_steps_per_epoch = max(steps_per_epoch // args.accum_freq, 1)
    variant = ("fork" if args.da and not args.uir_variant else "uir" if args.da else "clip")
    use_accum = args.accum_freq > 1
    if use_accum and teacher is not None:
        raise SystemExit("--accum-freq > 1 with --distill-model is unsupported (the "
                         "reference only distills at accum_freq 1, training/train.py:109-121)")
    cfg = ClipTrainConfig(
        lr=args.lr, beta1=args.beta1, beta2=args.beta2, eps=args.eps, wd=args.wd,
        warmup=args.warmup, total_steps=args.epochs * opt_steps_per_epoch,
        lr_scheduler=args.lr_scheduler, lr_cooldown_end=args.lr_cooldown_end,
        lr_cooldown_power=args.lr_cooldown_power,
        cooldown_steps=(opt_steps_per_epoch * args.epochs_cooldown
                        if args.epochs_cooldown else None),
        skip_scheduler=args.skip_scheduler, grad_clip_norm=args.grad_clip_norm,
        accum_freq=args.accum_freq, variant=variant, distill=teacher is not None)
    state = init_state(model, cfg, update_mask, device=device)
    if use_accum:
        step_fn = make_accum_train_step(model, cfg, banks, device=device)
    else:
        step_fn = make_train_step(model, cfg, banks, distill_model=teacher, device=device)

    start_epoch = 0
    if args.resume:  # main.py:131-163
        rdir = ckpt_dir if args.resume == "latest" else args.resume
        if os.path.isfile(rdir) or latest_step(rdir, EPOCH) is not None:
            start_epoch = restore_clip_checkpoint(rdir, model, state)
            log.info("resumed from %s epoch %d", rdir, start_epoch)
        elif args.resume != "latest":
            raise FileNotFoundError(args.resume)

    report_to = [r for r in args.report_to.split(",") if r]
    writer = MetricWriter(log_base, use_tensorboard="tensorboard" in report_to)

    def run_val():
        metrics = eval_retrieval(model, val_ds, batch_size=args.batch_size, banks=banks,
                                 variant=cfg.variant, device=device)
        log.info("val: %s", {k: round(v, 4) for k, v in metrics.items()})
        return metrics

    max_to_keep = 1 if args.delete_previous_checkpoint else 3
    best_loss = float("inf")
    global_step = start_epoch * steps_per_epoch
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        losses, micro = [], []
        for i, batch in enumerate(loader):
            dev = to_device(batch, device)
            if use_accum:  # train.py:125-145
                micro.append(dev)
                if len(micro) < args.accum_freq:
                    continue
                state, m = step_fn(state, micro)
                micro = []
            else:
                state, m = step_fn(state, dev)
            losses.append(float(m["total_loss"]))
            global_step += 1
            if (i + 1) % args.log_every_n_steps == 0 or i + 1 == steps_per_epoch:
                sps = (i + 1) * args.batch_size / (time.time() - t0)
                log.info("epoch %d step %d loss %.4f (%.1f samples/s)",
                         epoch, i + 1, losses[-1], sps)
                writer.write(global_step, {"loss": losses[-1],
                                           "grad_norm": float(m["grad_norm"]),
                                           "logit_scale": float(m["logit_scale"]),
                                           "samples_per_s": sps}, prefix="train/")
        epoch_loss = float(np.mean(losses)) if losses else float("nan")
        log.info("epoch %d done: mean loss %.4f", epoch, epoch_loss)

        if val_ds is not None and (epoch + 1) % args.val_frequency == 0:
            writer.write(global_step, run_val(), prefix="val/")
        save = partial(save_clip_checkpoint, model=model, state=state, epoch=epoch + 1,
                       name=args.name)
        if (epoch + 1) % args.save_frequency == 0:
            save(ckpt_dir, max_to_keep=max_to_keep)
        elif args.save_most_recent:  # epoch_latest (main.py:448-457)
            save(os.path.join(ckpt_dir, "latest"), max_to_keep=1)
        if epoch_loss < best_loss:  # best-by-train-loss (main.py:443-448)
            best_loss = epoch_loss
            save(os.path.join(ckpt_dir, "best"), max_to_keep=1)
    log.info("training complete; best epoch loss %.4f", best_loss)
    writer.close()
    return {"best_loss": best_loss}


if __name__ == "__main__":
    main()
