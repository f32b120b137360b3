"""CLIP / DA-CLIP training CLI, on one card or over torchrun's processes —
the `python -m training.main` equivalent (reference da-clip/src/training/
main.py:71-498).

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

Several cards (da-clip/src/multi_train.sh): one run over torchrun's
processes, one card each, `--batch-size` per process (so 4 × 512 is the
reference's global batch of 2048), the loss over the global batch:
  torchrun --nproc_per_node 4 -m daclip_torch.cli.train_daclip \\
      --train-data data/train.csv --da --model daclip_ViT-B-32 \\
      --pretrained pretrained/ViT-B-32.pt --batch-size 512 --epochs 200 --lr 3e-5
`--mesh data[,fsdp[,model]]` (default: all processes on `data`, DDP) must
span the world size: fsdp > 1 shards the parameters (FSDP2, HSDP over
(data, fsdp)), model > 1 splits the towers' attention heads and MLPs
(tensor parallel). The CSV loader stripes one seeded order by rank; each
rank draws its own crops; rank 0 alone writes logs, TensorBoard,
checkpoints and the remote sync and runs the evaluations, the other ranks
waiting. `--dist-url` (env://, tcp://, file://), `--dist-backend` and
`--no-set-device-rank` are the reference's (`daclip_torch.parallel`).

Also webdataset shards (`--dataset-type webdataset` or a `::`, `.tar` or
`{` pattern; `--train-data-upsampling-factors`, `--dataset-resampled`;
`--train-num-samples` required), patch dropout (`--force-patch-dropout`),
ImageNet zero-shot every `--zeroshot-frequency` epochs and at the last
(`--imagenet-val`, a tree of class dirs), `--remote-sync` of the log dir
(s3, gs or fsspec; `--resume latest` fetches the remote checkpoints when
there are none here), and registry tags as `--pretrained`.

`--device` defaults to cuda and raises without a GPU unless given `cpu`.
Flags this CLI does not carry exit before any work: `--report-to wandb`,
and `--imagenet-v2`, which daclip_tpu parses and evaluates nowhere either;
so does a `--mesh` whose product is not the world size. `--fast-clip-view`
trains on cv2's decode and resize (`transforms.image_transform(
backend="cv2")`), as daclip_tpu's does: the same crop draws, not PIL's
bytes.
"""
from __future__ import annotations

import copy
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

def refuse_unported(args) -> None:
    """Exit before any work on a flag this CLI does not carry."""
    if "wandb" in args.report_to.split(","):
        raise SystemExit("--report-to wandb: wandb is not a dependency of daclip_torch "
                         "and is not installed with it, so daclip_torch does not report "
                         "to it (not queued); use --report-to tensorboard")
    if args.imagenet_v2:
        raise SystemExit("--imagenet-v2: daclip_tpu parses it and no module of it evaluates "
                         "ImageNet-V2 either, so daclip_torch does not (not queued)")


def dataset_type(args) -> str:
    """--dataset-type, with `auto` resolved as get_dataset_fn does
    (training/data.py:640-660): no data → synthetic; a `::`, `.tar` or `{`
    pattern → webdataset; else csv."""
    if args.dataset_type != "auto":
        return args.dataset_type
    if not args.train_data:
        return "synthetic"
    if "::" in args.train_data or args.train_data.endswith(".tar") or "{" in args.train_data:
        return "webdataset"
    return "csv"


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


def build_data(args, pp_train, pp_val, tokenizer, image_size: int = 224, host_id: int = 0,
               num_hosts: int = 1):
    """(train loader, banks or None, val dataset or None), as the JAX CLI
    builds them (daclip_tpu/cli/train_daclip.py:147-197). With
    `--fast-clip-view` the CSV train set decodes with cv2 and takes the cv2
    train view at `image_size`, normalised by --image-mean/--image-std, else
    by the `--pretrained` tag's, as the factory's transforms are. Over
    `num_hosts` data-parallel ranks, the loaders stripe their order by
    `host_id` (daclip_tpu's CSV loader does not: its GSPMD batch is split
    over the devices) and each rank's crops draw from its own seed."""
    from daclip_torch.parallel import rank_seed

    data_seed = rank_seed(args.seed, host_id)
    from daclip_torch.data.csv_dataset import CsvDataset, SyntheticDataset
    from daclip_torch.data.loader import DataLoader

    kind = dataset_type(args)
    if kind == "webdataset":
        from daclip_torch.data.webdataset import ClipWebLoader, WebDataset

        if args.da:
            raise SystemExit("--da needs the csv pipeline (degradation captions; "
                             "training/data.py:29-156) — webdataset sources carry no "
                             "degradation metadata")
        weights = None
        if args.train_data_upsampling_factors:
            weights = [float(w) for w in args.train_data_upsampling_factors.split("::")]
        wds = WebDataset(args.train_data, shuffle_buffer=5000, seed=args.seed,
                         host_id=host_id, num_hosts=num_hosts,
                         resampled=args.dataset_resampled, weights=weights)
        loader = ClipWebLoader(wds, pp_train, tokenizer, args.batch_size,
                               num_samples=(args.train_num_samples or 0) // num_hosts)
        ds = None
    elif kind == "synthetic":
        ds = SyntheticDataset(pp_train, dataset_size=args.train_num_samples or 512,
                              tokenizer=tokenizer, da=args.da)
    else:
        if args.fast_clip_view:
            from daclip_torch.factory import tag_cfg
            from daclip_torch.transforms import image_transform

            tag = tag_cfg(args.model, args.pretrained)
            pp_train = image_transform(image_size, is_train=True,
                                       mean=args.image_mean or tag.get("mean"),
                                       std=args.image_std or tag.get("std"),
                                       rng=random.Random(data_seed), backend="cv2")
        ds = CsvDataset(args.train_data, pp_train, args.csv_img_key, args.csv_caption_key,
                        args.csv_separator, tokenizer=tokenizer, da=args.da, crop=args.crop,
                        seed=data_seed, decode="cv2" if args.fast_clip_view else "pil")
    if ds is not None:
        loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True,
                            num_workers=args.workers, seed=args.seed, num_hosts=num_hosts,
                            host_id=host_id)
    val_ds = None
    if args.val_data:
        val_ds = CsvDataset(args.val_data, pp_val, args.csv_img_key, args.csv_caption_key,
                            args.csv_separator, tokenizer=tokenizer, da=args.da)
    return loader, ds.banks() if ds is not None else None, val_ds


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    refuse_unported(args)

    from daclip_torch import parallel
    from daclip_torch.data import native_io
    from daclip_torch.data.loader import to_device
    from daclip_torch.eval.retrieval import evaluate as eval_retrieval
    from daclip_torch.factory import create_model, create_model_and_transforms
    from daclip_torch.tokenizer import tokenize
    from daclip_torch.train.clip_train import (ClipTrainConfig, init_state,
                                               make_accum_train_step, make_train_step,
                                               partition_daclip_params)
    from daclip_torch.train.locking import build_update_mask
    from daclip_torch.utils.checkpoint import (EPOCH, latest_step, pick_checkpoint,
                                               restore_clip_checkpoint, save_clip_checkpoint)
    from daclip_torch.utils import file_utils
    from daclip_torch.utils.logging import MetricWriter

    rank, world, _, device = parallel.initialize_distributed(
        args.dist_url, args.dist_backend, args.device, not args.no_set_device_rank)
    native_io.load()  # the image decoder is built at start-up, not in the first step
    try:
        mesh = parallel.mesh_from_spec(args.mesh, world, device.type)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    host0 = rank == 0
    dp_rank, dp_size = (0, 1) if mesh is None else (mesh.dp_rank, mesh.dp_size)
    if args.name is None:  # run identity (main.py:90-104)
        args.name = "-".join([time.strftime("%Y_%m_%d-%H_%M_%S"),
                              f"model_{args.model.replace('/', '-')}",
                              f"lr_{args.lr}", f"b_{args.batch_size}", f"p_{args.precision}"])
        if world > 1:  # one name for the run: rank 0's clock
            names = [args.name]
            torch.distributed.broadcast_object_list(names, src=0)
            args.name = names[0]
    log_base = os.path.join(args.logs, args.name)
    ckpt_dir = os.path.join(log_base, "checkpoints")
    if host0:
        log = _setup_logging(log_base, args.debug)
        os.makedirs(ckpt_dir, exist_ok=True)
        if args.copy_codebase:  # main.py:478-498
            dst = os.path.join(log_base, "code", "daclip_torch")
            if not os.path.exists(dst):
                shutil.copytree(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                dst, ignore=shutil.ignore_patterns("__pycache__", "*.pyc",
                                                                   "build"))
    else:  # the other ranks log warnings only, to the console
        log = logging.getLogger("daclip")
        log.setLevel(logging.WARNING)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    log.info("device: %s, rank %d of %d, mesh %s", device, rank, world,
             None if mesh is None else mesh.shape)

    # DA mode is implied by a daclip_* model (single_train.sh passes both)
    args.da = args.da or "daclip" in args.model
    model, pp_train, pp_val = create_model_and_transforms(
        args.model, pretrained=args.pretrained or None, precision=args.precision,
        use_predictor=args.da and not args.uir_variant, image_mean=args.image_mean,
        image_std=args.image_std, seed=args.seed, force_quick_gelu=args.force_quick_gelu,
        force_custom_text=args.force_custom_text, force_patch_dropout=args.force_patch_dropout,
        force_image_size=args.force_image_size[0] if args.force_image_size else None,
        remat=args.grad_checkpointing, rng=random.Random(parallel.rank_seed(args.seed, dp_rank)))
    if args.pretrained:
        log.info("loaded pretrained weights: %s", args.pretrained)
    tokenizer = partial(tokenize, context_length=model.cfg.text.context_length)
    loader, banks, val_ds = build_data(args, pp_train, pp_val, tokenizer,
                                       model.cfg.vision.image_size, dp_rank, dp_size)

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
        accum_freq=args.accum_freq, variant=variant, distill=teacher is not None,
        patch_dropout=bool(args.force_patch_dropout))
    # a whole copy to evaluate on rank 0 when the mesh shards the model
    sharded = mesh is not None and (mesh.shape[1] > 1 or mesh.shape[2] > 1)
    template = copy.deepcopy(model) if sharded and host0 else None
    wrapped = parallel.parallelize(model.to(device), mesh, device,
                                  static_graph=args.ddp_static_graph)
    model = parallel.unwrap(wrapped)
    state = init_state(model, cfg, update_mask, device=device)
    if use_accum:
        step_fn = make_accum_train_step(wrapped, cfg, banks, device=device)
    else:
        step_fn = make_train_step(wrapped, cfg, banks, distill_model=teacher, device=device)

    start_epoch = 0
    if args.resume:  # main.py:131-163
        rdir = ckpt_dir if args.resume == "latest" else args.resume
        if (args.resume == "latest" and args.remote_sync and host0
                and latest_step(rdir, EPOCH) is None):
            # no checkpoint here: mirror the synced checkpoint dir down first
            remote_ckpts = os.path.join(args.remote_sync, args.name, "checkpoints")
            if file_utils.list_remote_dir(remote_ckpts):
                file_utils.download_remote_dir(remote_ckpts, rdir)
                log.info("downloaded remote checkpoints from %s", remote_ckpts)
        parallel.barrier()
        # the newest of the port's epoch_<n>.pt and daclip_tpu's orbax step
        # dirs <n>/ (beside its latest/ and best/), or one file or step dir
        try:
            kind, n = pick_checkpoint(rdir, None, EPOCH)
        except FileNotFoundError:
            if args.resume != "latest":
                raise FileNotFoundError(args.resume) from None
            kind = None
        if kind is not None:
            start_epoch = restore_clip_checkpoint(rdir, wrapped, state, n, cfg=cfg, log=log)
            log.info("resumed from %s epoch %d (%s)", rdir, start_epoch,
                     "daclip_tpu's orbax step dir" if kind == "orbax" else "the port's .pt")

    report_to = [r for r in args.report_to.split(",") if r]
    writer = MetricWriter(log_base, use_tensorboard="tensorboard" in report_to) if host0 else None
    sync_thread = None
    if args.remote_sync and host0:  # main.py:121-129
        remote_base = os.path.join(args.remote_sync, args.name)
        if not file_utils.remote_sync(log_base, remote_base, args.remote_sync_protocol):
            raise SystemExit("initial remote sync failed (main.py:121-129)")
        sync_thread = file_utils.start_sync_process(
            args.remote_sync_frequency, log_base, remote_base, args.remote_sync_protocol)
        sync_thread.start()

    def eval_model():
        """The model whole, on rank 0 (None on the others): under FSDP or
        tensor parallelism every rank gathers its state into rank 0's copy,
        which is on the card only while it evaluates."""
        if not sharded:
            return model if host0 else None
        sd = parallel.model_state(model)
        if not host0:
            return None
        template.load_state_dict(sd, strict=True)
        return template.to(device)

    def run_val(m):
        metrics = eval_retrieval(m, val_ds, batch_size=args.batch_size, banks=banks,
                                 variant=cfg.variant, device=device)
        log.info("val: %s", {k: round(v, 4) for k, v in metrics.items()})
        return metrics

    def run_zero_shot(m):
        """In-training ImageNet zero-shot (train.py:380 → zero_shot.py)."""
        from daclip_torch.eval.imagenet_zero_shot import evaluate_with_encoders

        @torch.no_grad()
        def encode_views(views):
            x = torch.from_numpy(np.ascontiguousarray(views, dtype=np.float32))
            return m.encode_image(x.permute(0, 3, 1, 2).to(device), normalize=True)

        metrics = evaluate_with_encoders(
            encode_views, lambda toks: m.encode_text(toks, normalize=True),
            args.imagenet_val, m.cfg.vision.image_size, batch_size=args.batch_size,
            device=device)
        log.info("zero-shot: %s", {k: round(v, 4) for k, v in metrics.items()})
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
            if host0 and ((i + 1) % args.log_every_n_steps == 0 or i + 1 == steps_per_epoch):
                sps = (i + 1) * args.batch_size * dp_size / (time.time() - t0)
                log.info("epoch %d step %d loss %.4f (%.1f samples/s)",
                         epoch, i + 1, losses[-1], sps)
                writer.write(global_step, {"loss": losses[-1],
                                           "grad_norm": float(m["grad_norm"]),
                                           "logit_scale": float(m["logit_scale"]),
                                           "samples_per_s": sps}, prefix="train/")
        epoch_loss = float(np.mean(losses)) if losses else float("nan")
        log.info("epoch %d done: mean loss %.4f", epoch, epoch_loss)

        evals = {}
        do_val = val_ds is not None and (epoch + 1) % args.val_frequency == 0
        do_zs = bool(args.imagenet_val and args.zeroshot_frequency and (
            (epoch + 1) % args.zeroshot_frequency == 0 or epoch + 1 == args.epochs))
        if do_val or do_zs:  # rank 0 evaluates; the others wait
            m = eval_model()
            if host0:
                if do_val:
                    evals.update(run_val(m))
                if do_zs:
                    evals.update(run_zero_shot(m))
                if sharded:
                    template.cpu()
            parallel.barrier()
        if evals:
            writer.write(global_step, evals, prefix="val/")
        save = partial(save_clip_checkpoint, model=wrapped, state=state, epoch=epoch + 1,
                       name=args.name)
        if (epoch + 1) % args.save_frequency == 0:
            save(ckpt_dir, max_to_keep=max_to_keep)
        elif args.save_most_recent:  # epoch_latest (main.py:448-457)
            save(os.path.join(ckpt_dir, "latest"), max_to_keep=1)
        if epoch_loss < best_loss:  # best-by-train-loss (main.py:443-448)
            best_loss = epoch_loss
            save(os.path.join(ckpt_dir, "best"), max_to_keep=1)
    log.info("training complete; best epoch loss %.4f", best_loss)
    if writer is not None:
        writer.close()
    if sync_thread is not None:
        sync_thread.stop(final_sync=True)
    return {"best_loss": best_loss}


if __name__ == "__main__":
    main()
