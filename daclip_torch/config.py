"""YAML options of the restoration CLIs (reference config/*/options.py:18-143).

Counterpart of `daclip_tpu/config.py`: the keys of options/{train,test}.yml;
`parse` adds the phase and distortion to each dataset and derives the
experiments/results directory tree; `dict_to_nonedict` gives missing keys
the value None (NoneDict, options.py:105-120). It sets no
CUDA_VISIBLE_DEVICES (options.py:21-23): the CLIs take `--device`.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Optional

import yaml


class NoneDict(dict):
    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(x) for x in opt]
    return opt


def parse(opt_path: str, is_train: bool = True) -> NoneDict:
    with open(opt_path) as f:
        opt = yaml.safe_load(f)

    opt["is_train"] = is_train
    if "sde" in opt and opt["sde"] is not None:
        opt["sde"].setdefault("T", 100)
        opt["sde"].setdefault("schedule", "cosine")

    # datasets: phase and distortion (options.py:34-60)
    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        dataset.setdefault("data_type", "img")
        if "distortion" in opt:
            dataset["distortion"] = opt["distortion"]
        if dataset.get("dataroot") is not None:
            dataset["dataroot"] = osp.expanduser(dataset["dataroot"])
        for k in ("dataroot_GT", "dataroot_LQ"):
            if dataset.get(k) is not None:
                dataset[k] = osp.expanduser(dataset[k])

    # the path tree (options.py:69-88)
    opt.setdefault("path", {})
    opt["path"]["root"] = opt["path"].get("root") or os.getcwd()
    if is_train:
        experiments_root = osp.join(opt["path"]["root"], "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"].setdefault("models", osp.join(experiments_root, "models"))
        opt["path"].setdefault("training_state", osp.join(experiments_root, "training_state"))
        opt["path"].setdefault("log", experiments_root)
        opt["path"].setdefault("val_images", osp.join(experiments_root, "val_images"))
        if "debug" in opt["name"]:
            opt["train"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 2
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(opt["path"]["root"], "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root

    return dict_to_nonedict(opt)


def check_resume(opt: Dict, resume_iter: Optional[int] = None):
    """Points `pretrain_model_G` at the resumed step's weights (options.py:123-143)."""
    if opt["path"].get("resume_state"):
        state_path = opt["path"]["resume_state"]
        if resume_iter is None:
            base = osp.basename(str(state_path))
            resume_iter = int(base.split(".")[0]) if base.split(".")[0].isdigit() else None
        if resume_iter is not None:
            opt["path"]["pretrain_model_G"] = osp.join(opt["path"]["models"],
                                                       f"{resume_iter}_G.pth")
    return opt
