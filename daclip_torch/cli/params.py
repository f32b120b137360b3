"""The DA-CLIP / CLIP training CLI's arguments: the reference's flag
surface (da-clip/src/training/params.py:26-459), flag for flag.

Counterpart of `daclip_tpu/cli/params.py`: `parse_args` gives the same
namespace for the same argv, `get_default_params` filling `--lr`, `--beta*`
and `--eps` per model (params.py:5-11, 452-457), plus one flag of the
port's, `--device`. `--dist-url`, `--dist-backend`, `--no-set-device-rank`
and `--mesh` form the process group and mesh (`daclip_torch.parallel`);
flags whose mechanism the port does not need (horovod, torchscript, the
gather knobs, whose loss is global either way) are accepted and do
nothing; the ones `cli/train_daclip.py` does not carry exit there, before
any work, saying why.
"""
from __future__ import annotations

import argparse
import ast


def get_default_params(model_name: str):
    """Paper defaults (params.py:5-11): ViT models use the CLIP-paper AdamW
    hyperparameters, ResNet models the larger-eps variant."""
    model_name = model_name.lower()
    if "vit" in model_name:
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


class ParseKwargs(argparse.Action):
    """--aug-cfg key=value parser (params.py:14-23)."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, value = value.split("=")
            try:
                kw[key] = ast.literal_eval(value)
            except ValueError:
                kw[key] = str(value)
        setattr(namespace, self.dest, kw)


def parse_args(args=None):
    parser = argparse.ArgumentParser()
    # ---- data -------------------------------------------------------------
    parser.add_argument("--train-data", type=str, default=None,
                        help="training data: csv path, or webdataset shard "
                             "pattern(s) joined with '::'")
    parser.add_argument("--train-data-upsampling-factors", type=str, default=None,
                        help="per-source upsampling weights, '::'-separated")
    parser.add_argument("--val-data", type=str, default=None)
    parser.add_argument("--train-num-samples", type=int, default=None)
    parser.add_argument("--val-num-samples", type=int, default=None)
    parser.add_argument("--dataset-type", default="auto",
                        choices=["webdataset", "csv", "synthetic", "auto"])
    parser.add_argument("--dataset-resampled", default=False,
                        action="store_true",
                        help="sample webdataset shards with replacement")
    parser.add_argument("--csv-separator", type=str, default="\t")
    parser.add_argument("--csv-img-key", type=str, default="filepath")
    parser.add_argument("--csv-caption-key", type=str, default="title")
    parser.add_argument("--imagenet-val", type=str, default=None,
                        help="ImageNet val folder for zero-shot eval")
    parser.add_argument("--imagenet-v2", type=str, default=None)
    # ---- logging / run identity -------------------------------------------
    parser.add_argument("--logs", type=str, default="./logs/")
    parser.add_argument("--log-local", action="store_true", default=False,
                        help="log from every host, not just host 0")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--workers", type=int, default=1)
    # ---- optimization ------------------------------------------------------
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=32)
    parser.add_argument("--epochs-cooldown", type=int, default=None,
                        help="cooldown starts this many epochs before the end")
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--beta1", type=float, default=None)
    parser.add_argument("--beta2", type=float, default=None)
    parser.add_argument("--eps", type=float, default=None)
    parser.add_argument("--wd", type=float, default=0.2)
    parser.add_argument("--warmup", type=int, default=10000)
    parser.add_argument("--use-bn-sync", default=False, action="store_true",
                        help="no-op: the ViT towers have no batchnorm")
    parser.add_argument("--skip-scheduler", action="store_true", default=False)
    parser.add_argument("--lr-scheduler", type=str, default="cosine",
                        help="cosine | const | const-cooldown")
    parser.add_argument("--lr-cooldown-end", type=float, default=0.0)
    parser.add_argument("--lr-cooldown-power", type=float, default=1.0)
    # ---- checkpointing ------------------------------------------------------
    parser.add_argument("--save-frequency", type=int, default=1)
    parser.add_argument("--save-most-recent", action="store_true", default=False,
                        help="also keep logs/<name>/checkpoints/epoch_latest")
    parser.add_argument("--zeroshot-frequency", type=int, default=2)
    parser.add_argument("--val-frequency", type=int, default=1)
    parser.add_argument("--resume", default=None, type=str,
                        help="checkpoint dir, or 'latest'")
    parser.add_argument("--delete-previous-checkpoint", default=False,
                        action="store_true")
    # ---- model -------------------------------------------------------------
    parser.add_argument("--precision",
                        choices=["amp", "amp_bf16", "amp_bfloat16", "bf16",
                                 "fp16", "pure_bf16", "pure_fp16", "fp32"],
                        default="amp",
                        help="every half flavour runs in bfloat16")
    parser.add_argument("--model", type=str, default="RN50")
    parser.add_argument("--pretrained", default="", type=str)
    parser.add_argument("--pretrained-image", default=False, action="store_true",
                        help="timm-only in the reference; no effect here")
    parser.add_argument("--lock-image", default=False, action="store_true",
                        help="LiT: lock full image tower")
    parser.add_argument("--lock-image-unlocked-groups", type=int, default=0)
    parser.add_argument("--lock-image-freeze-bn-stats", default=False,
                        action="store_true",
                        help="no-op for ViT towers (no batchnorm)")
    parser.add_argument("--image-mean", type=float, nargs="+", default=None)
    parser.add_argument("--image-std", type=float, nargs="+", default=None)
    parser.add_argument("--aug-cfg", nargs="*", default={}, action=ParseKwargs)
    parser.add_argument("--grad-checkpointing", default=False,
                        action="store_true",
                        help="recompute the transformer blocks in the backward "
                             "(torch.utils.checkpoint)")
    parser.add_argument("--local-loss", default=False, action="store_true",
                        help="accepted for script compat: over several ranks the "
                             "loss is the global batch's whatever this says")
    parser.add_argument("--gather-with-grad", default=False, action="store_true",
                        help="accepted for script compat: the features are always "
                             "gathered with their gradient (the exact global loss)")
    parser.add_argument("--force-image-size", type=int, nargs="+", default=None)
    parser.add_argument("--force-quick-gelu", default=False, action="store_true")
    parser.add_argument("--force-patch-dropout", default=None, type=float)
    parser.add_argument("--force-custom-text", default=False, action="store_true",
                        help="accepted for script compat: no effect without an HF "
                             "text tower")
    parser.add_argument("--torchscript", default=False, action="store_true",
                        help="accepted for script compat; no effect")
    parser.add_argument("--torchcompile", default=False, action="store_true",
                        help="accepted for script compat; no effect")
    parser.add_argument("--trace", default=False, action="store_true",
                        help="accepted for script compat; no effect")
    parser.add_argument("--accum-freq", type=int, default=1)
    # ---- distributed ---------------------------------------------------------
    parser.add_argument("--dist-url", default="env://", type=str,
                        help="process group rendezvous under torchrun/SLURM: env://, "
                             "tcp:// or file://")
    parser.add_argument("--dist-backend", default="nccl", type=str,
                        help="nccl on cuda; gloo on the cpu or when asked")
    parser.add_argument("--horovod", default=False, action="store_true",
                        help="accepted for script compat; no effect")
    parser.add_argument("--ddp-static-graph", default=False, action="store_true",
                        help="DDP's static graph (the --mesh data axis alone)")
    parser.add_argument("--no-set-device-rank", default=False, action="store_true",
                        help="do not pin cuda:LOCAL_RANK (the reference's flag)")
    # ---- reporting -----------------------------------------------------------
    parser.add_argument("--report-to", default="", type=str,
                        help="comma-separated: wandb, tensorboard")
    parser.add_argument("--wandb-notes", default="", type=str)
    parser.add_argument("--wandb-project-name", type=str, default="open-clip")
    parser.add_argument("--debug", default=False, action="store_true")
    parser.add_argument("--copy-codebase", default=False, action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grad-clip-norm", type=float, default=None)
    parser.add_argument("--lock-text", default=False, action="store_true")
    parser.add_argument("--lock-text-unlocked-layers", type=int, default=0)
    parser.add_argument("--lock-text-freeze-layer-norm", default=False,
                        action="store_true")
    parser.add_argument("--log-every-n-steps", type=int, default=100)
    parser.add_argument("--coca-caption-loss-weight", type=float, default=2.0)
    parser.add_argument("--coca-contrastive-loss-weight", type=float, default=1.0)
    # ---- remote sync ----------------------------------------------------------
    parser.add_argument("--remote-sync", type=str, default=None,
                        help="s3://…, gs://…, or any fsspec url")
    parser.add_argument("--remote-sync-frequency", type=int, default=300)
    parser.add_argument("--remote-sync-protocol",
                        choices=["s3", "gs", "fsspec"], default="s3")
    parser.add_argument("--distill-model", default=None,
                        help="teacher model config name")
    parser.add_argument("--distill-pretrained", default=None,
                        help="teacher weights (path or tag)")
    parser.add_argument("--use-bnb-linear", default=None,
                        help="bitsandbytes linear layers: refused")
    # ---- DA-CLIP fork flags ----------------------------------------------------
    parser.add_argument("--da", default=False, action="store_true",
                        help="degradation-aware training (caption‖degradation "
                             "texts + predictor head + FCRC loss)")
    parser.add_argument("--crop", default=False, action="store_true")
    # ---- the JAX package's extensions ---------------------------------------------
    parser.add_argument("--mesh", type=str, default=None,
                        help="'data[,fsdp[,model]]' over the world size (default: all "
                             "processes on data, DDP); fsdp shards the parameters, "
                             "model splits the towers (tensor parallel)")
    parser.add_argument("--debug-nans", action="store_true", default=False,
                        help="torch.autograd.set_detect_anomaly")
    parser.add_argument("--uir-variant", action="store_true", default=False,
                        help="original DA-CLIP loss instead of the fork's")
    parser.add_argument("--fast-clip-view", action="store_true", default=False,
                        help="the cv2 train transform: the CSV train set decoded by "
                             "cv2 and cropped and resized by cv2/numpy (same geometry "
                             "as the PIL path, another resample kernel: not for parity "
                             "runs)")
    # ---- the port's ------------------------------------------------------------------
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; without a GPU pass cpu)")

    args = parser.parse_args(args)

    # paper defaults when unset (params.py:452-457)
    default_params = get_default_params(args.model)
    for name, val in default_params.items():
        if getattr(args, name) is None:
            setattr(args, name, val)

    if args.use_bnb_linear is not None:
        raise SystemExit("--use-bnb-linear (bitsandbytes linear layers) is not "
                         "supported: the towers run torch Linear layers")
    return args
