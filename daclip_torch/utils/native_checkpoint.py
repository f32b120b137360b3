"""The JAX package's checkpoints (its orbax train dirs and flat `.npz`
params), read into reference-named state dicts.

Counterpart of `daclip_tpu/utils/native_checkpoint.py` (`checkpoint_kind`
:45, `is_native_checkpoint` :61, `load_train_tree` :72,
`load_restoration_params` :88, `load_daclip_train_params` :111,
`save_params_npz` :128, `load_params_npz` :144,
`infer_unet_arch_from_params` :161, `load_unet_any` :195, `load_daclip_any`
:213). An orbax train dir is read by `utils/orbax_reader.py`, with no JAX:
`cli/train_restoration`'s {params, opt_state, ema, step} (the EMA
parameters served by default, and only the branch served is decoded) and
`cli/train_daclip`'s {params: trainable, frozen: {clip}, opt_state, step,
epoch} (the model is trainable ∪ frozen). An `.npz` holds a flax params tree
flattened with '/'-joined keys. The trees are the JAX modules' own: the
UNet's as `unet_state_dict_from_jax` reads it, DaCLIP's with its transformer
blocks stacked (L, …) along the first axis as `daclip_state_dict_from_jax`
reads them. The port's own restoration train dir (the `<step>.pt` files of
`utils/checkpoint.py`) loads as a UNet, and its DA-CLIP train dir (the
`epoch_<n>.pt` files) as a DA-CLIP.

`load_restoration_train_state` and `load_daclip_train_state` read a train
dir's whole state to resume the run in the port: the parameters, the optax
optimizer's moments and count (found by the chain's structure), the EMA, the
step and the epoch, as the payload of a `.pt` file of `utils/checkpoint.py`
(which resumes from either kind). The moments go through the parameters' own
weight map, which must only move values (`_computed_leaves`); the
cross-attention parameters the port's UNet gives no gradient keep no state,
as the port's optimizer keeps none for them.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from daclip_torch.convert import (daclip_state_dict_from_jax, infer_unet_arch,
                                  load_torch_state_dict, resize_pos_embed,
                                  unet_state_dict_from_jax)
from daclip_torch.utils import checkpoint as train_checkpoint
from daclip_torch.utils import orbax_reader


def _has_orbax_step_dirs(path: str) -> bool:
    if not os.path.isdir(path):
        return False
    return any(e.isdigit() and os.path.isdir(os.path.join(path, e))
               for e in os.listdir(path))


def checkpoint_kind(path: str) -> str:
    """'orbax' (a train dir with numeric step subdirs), 'orbax_step' (one
    step dir), 'train_dir' (the port's `<step>.pt` files), 'clip_train_dir'
    (its `epoch_<n>.pt` files), 'npz', or 'torch'."""
    if _has_orbax_step_dirs(path):
        return "orbax"
    if os.path.isdir(path):
        if os.path.basename(os.path.normpath(path)).isdigit():
            return "orbax_step"
        if train_checkpoint.steps(path):
            return "train_dir"
        if train_checkpoint.steps(path, train_checkpoint.EPOCH):
            return "clip_train_dir"
        raise FileNotFoundError(
            f"{path!r} is a directory but contains no orbax step checkpoints")
    if str(path).endswith(".npz"):
        return "npz"
    return "torch"


def is_native_checkpoint(path: str) -> bool:
    """Whether `path` is one of the JAX package's own formats: an orbax
    train dir, one of its step dirs, or an `.npz`."""
    try:
        return checkpoint_kind(path) in ("orbax", "orbax_step", "npz")
    except FileNotFoundError:
        return False


# ---------------------------------------------------------------------------
# orbax train dirs


def _resolve(directory: str, step: Optional[int]) -> Tuple[str, int]:
    """(train dir, step): a step dir stands for its parent at its step; the
    latest step by default."""
    directory = os.path.abspath(directory)
    if checkpoint_kind(directory) == "orbax_step":
        step = int(os.path.basename(os.path.normpath(directory)))
        directory = os.path.dirname(os.path.normpath(directory))
    if step is None:
        step = orbax_reader.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return directory, int(step)


def load_train_tree(directory: str, step: Optional[int] = None,
                    prefix: str = "") -> Tuple[Dict, int]:
    """The checkpoint tree (nested dicts, lists for sequences, CPU tensors)
    and the step restored; only the leaves whose '.'-joined name starts
    with `prefix` when it is given."""
    directory, step = _resolve(directory, step)
    return orbax_reader.restore_checkpoint(directory, step, prefix=prefix), step


def _unwrap_flax(params: Dict) -> Dict:
    """Strip a solitary flax variables wrapper ({'params': tree} → tree)."""
    while isinstance(params, dict) and set(params) == {"params"}:
        params = params["params"]
    return params


def load_restoration_params(directory: str, step: Optional[int] = None,
                            use_ema: bool = True) -> Tuple[Dict, int]:
    """UNet params from a `cli/train_restoration` checkpoint dir: the EMA
    shadow (what the reference serves) unless `use_ema=False`. Only that
    branch is decoded."""
    directory, step = _resolve(directory, step)
    top = orbax_reader.top_level_keys(directory, step)
    if "ema" not in top or "params" not in top:
        raise ValueError(
            f"{directory!r} does not look like a restoration train dir "
            f"(keys: {sorted(top)}); expected {{params, opt_state, ema, step}}")
    branch = "ema.params." if use_ema else "params."
    tree = orbax_reader.restore_checkpoint(directory, step, prefix=branch)
    params = tree["ema"]["params"] if use_ema else tree["params"]
    return _unwrap_flax(params), step


def load_daclip_train_params(directory: str, step: Optional[int] = None
                             ) -> Tuple[Dict, int]:
    """Full DaCLIP params (trainable ∪ frozen clip) from a `cli/train_daclip`
    checkpoint dir; the optimizer state is not decoded."""
    directory, step = _resolve(directory, step)
    top = orbax_reader.top_level_keys(directory, step)
    if "params" not in top:
        raise ValueError(f"{directory!r} has no 'params' (keys: {sorted(top)})")
    params = dict(_unwrap_flax(
        orbax_reader.restore_checkpoint(directory, step, prefix="params.")["params"]))
    if "frozen" in top:
        frozen = orbax_reader.restore_checkpoint(directory, step, prefix="frozen.")
        params.update(_unwrap_flax(frozen.get("frozen") or {}))
    return params, step


# ---------------------------------------------------------------------------
# resuming a training run: the optimizer's state, the EMA, the step and epoch


def _optax_part(node: Any, path: str, where: str) -> str:
    """What one state of daclip_tpu's optax chains is, by its fields."""
    if node is None or node == {} or node == []:
        return "empty"  # clip_by_global_norm's, add_decayed_weights'
    if not isinstance(node, dict):
        raise ValueError(f"{where}: {path} is not an optax state")
    keys = set(node)
    if keys == {"inner_state"} and node["inner_state"] in (None, {}, []):
        return "empty"  # add_decayed_weights under optax.masked (the weight-decay mask)
    if {"mini_step", "gradient_step", "inner_opt_state"} <= keys:
        raise ValueError(
            f"{where}: {path} is optax.MultiSteps' state (gradient accumulation inside the "
            "optimizer), which daclip_tpu's train CLIs do not write and the port does not map")
    kinds = {frozenset({"count", "mu", "nu"}): "adam", frozenset({"count", "mu"}): "lion",
             frozenset({"count"}): "schedule"}
    if frozenset(keys) not in kinds:
        raise ValueError(f"{where}: {path} holds an optax state the port does not map "
                         f"(fields {sorted(keys)})")
    return kinds[frozenset(keys)]


def _optax_state(opt_state: Any, where: str) -> Dict:
    """daclip_tpu's optax state found by its structure, not its position
    (`daclip_tpu/train/restoration.py:71-93`, `train/clip_train.py:97-105`):
    the chain's states in order through nested chains — `clip_by_global_norm`'s
    empty state first when clipping, then scale_by_adam's (count, mu, nu) or
    scale_by_lion's (count, mu), add_decayed_weights' empty state (masked or
    not) where the optimizer decays, and the schedule's count. Returns
    {"kind": "adam" | "lion", "moments": that state, "clip", "decay",
    "schedule": the schedule's count}; anything else is refused by name."""
    parts = []

    def walk(node, path):
        if isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        else:
            parts.append((path, node, _optax_part(node, path, where)))

    walk(opt_state, "opt_state")
    kinds = [k for _, _, k in parts]
    moments = [i for i, k in enumerate(kinds) if k in ("adam", "lion")]
    layout = " → ".join(f"{path}: {k}" for path, _, k in parts)
    if (len(moments) != 1 or kinds[moments[0] + 1:] not in (["schedule"], ["empty", "schedule"])
            or kinds[:moments[0]] not in ([], ["empty"])):
        raise ValueError(f"{where}: an optax chain the port does not map ({layout}); it "
                         "maps [clip_by_global_norm] → adam | lion → [add_decayed_weights] → "
                         "schedule")
    i = moments[0]
    return {"kind": kinds[i], "moments": parts[i][1], "clip": i == 1,
            "decay": len(kinds) - i == 3, "schedule": int(parts[-1][1]["count"])}


def _check_counts(opt: Dict, step: int, where: str) -> None:
    count = int(opt["moments"]["count"])
    if not count == step == opt["schedule"]:
        raise ValueError(f"{where}: the optimizer's count {count}, the step {step} and the "
                         f"schedule's count {opt['schedule']} differ; daclip_tpu advances all "
                         "three together")


def _check_optimizer(opt: Dict, kind: str, decay: bool, clip: bool, named: str,
                     where: str) -> None:
    """Refuse, naming both, a dir whose optimizer is not the one the caller's
    options make."""
    def say(kd, dc, cl):
        return (("clip_by_global_norm → " if cl else "") + kd
                + (" with weight decay" if dc else " without weight decay"))

    if (opt["kind"], opt["decay"], opt["clip"]) != (kind, decay, clip):
        found = say(opt["kind"], opt["decay"], opt["clip"])
        raise ValueError(f"{where}: holds the state of {found}, but the options name {named}: "
                         f"{say(kind, decay, clip)}")


def _computed_leaves(tree: Dict, convert) -> set:
    """The keys of `convert(tree)` that are not made of the tree's leaves as
    they are. Each leaf is tagged with its number (from 1) and converted: a
    map that only moves values (transposes, reshapes, slices, a concatenation)
    gives every key tags alone, and every leaf's tags exactly its size in
    all; a key with anything else (a zero it fills, a sum) is computed. A map
    that moves a leaf twice or drops part of one raises."""
    sizes = []

    def tag(node):
        if isinstance(node, dict):
            return {k: tag(v) for k, v in node.items()}
        a = np.asarray(node)
        sizes.append(a.size)
        return np.broadcast_to(np.float32(len(sizes)), a.shape)

    tagged = tag(tree)
    counts = torch.zeros(len(sizes) + 1, dtype=torch.int64)
    computed = set()
    for key, t in convert(tagged).items():
        if not t.numel():
            continue
        lo, hi = map(float, torch.aminmax(t))
        if lo == hi and lo.is_integer() and 1 <= lo <= len(sizes):  # one leaf's values
            counts[int(lo)] += t.numel()
            continue
        v = t.reshape(-1).double()
        if lo < 1 or hi > len(sizes) or bool((v != v.round()).any()):
            computed.add(key)
            continue
        counts += torch.bincount(v.long(), minlength=len(sizes) + 1)
    if counts[1:].tolist() != sizes:
        raise ValueError("the weight map does not move each leaf once")
    return computed


def _unet_no_grad(computed: set, names, where: str) -> set:
    """The UNet parameters that never get a gradient in the port: the
    cross-attention of a one-token context (its softmax is 1, so the port
    computes to_out(v) alone: to_q, to_k and norm2 are unread). daclip_tpu
    creates no to_q there, which the weight map fills with zeros (the only
    key it computes); its to_k and norm2 get zero gradients. Any other
    computed key is refused by name."""
    tail = "attn2.to_q.weight"
    no_grad = set()
    for key in sorted(computed & set(names)):
        if not key.endswith(tail):
            raise ValueError(f"{where}: the weight map computes {key} instead of moving a "
                             "leaf, so its optimizer moments cannot be read")
        block = key[:-len(tail)]
        no_grad |= {key, f"{block}attn2.to_k.weight", f"{block}norm2.weight",
                    f"{block}norm2.bias"}
    return no_grad


def _moments_state(kind: str, count: int, mu: Dict, nu: Optional[Dict], index: Dict[str, int],
                   skip: set, where: str) -> Dict[int, Dict]:
    """torch's per-parameter state in `parallel.optimizer_state`'s form:
    AdamW's {step, exp_avg, exp_avg_sq}, the port's Lion's {exp_avg}, keyed
    by each parameter's index; none for the parameters in `skip`, whose
    moments must be zero."""
    missing = sorted(set(index) - set(mu))
    if missing:
        raise ValueError(f"{where}: the optimizer's moments hold no {missing[:4]} "
                         f"({len(missing)} parameters of the model): not the model's tree")
    state = {}
    for name, i in index.items():
        if name in skip:
            for m in (mu, nu) if nu is not None else (mu,):
                if torch.count_nonzero(m[name]):
                    raise ValueError(f"{where}: {name} has nonzero moments, but the port's "
                                     "model gives it no gradient")
            continue
        st = {"exp_avg": mu[name]}
        if kind == "adam":
            st = {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                  "exp_avg_sq": nu[name]}
        state[i] = st
    return dict(sorted(state.items()))


def _check_model(sd: Dict[str, torch.Tensor], model, where: str, partial: bool = False) -> None:
    """Refuse, by name, a state dict that is not `model`'s: keys the model
    lacks or (unless `partial`) keys it has that sd lacks, or other shapes."""
    from daclip_torch import parallel

    own = {k: tuple(v.shape) for k, v in parallel.unwrap(model).state_dict().items()}
    extra, missing = sorted(set(sd) - set(own)), sorted(set(own) - set(sd))
    wrong = sorted(k for k in set(sd) & set(own) if tuple(sd[k].shape) != own[k])
    if extra or wrong or (missing and not partial):
        raise ValueError(f"{where}: the params tree is not the model's: keys it lacks "
                         f"{extra[:4]}, keys it misses {missing[:4]}, shapes that differ "
                         f"{[(k, tuple(sd[k].shape), own[k]) for k in wrong[:4]]}")


def load_restoration_train_state(directory: str, step: Optional[int] = None, cfg=None,
                                 unet=None, optimizer=None) -> Dict:
    """daclip_tpu's `cli/train_restoration` state at `step` (default the
    latest) of its orbax train dir (or of one step dir) as the payload the
    port's `utils/checkpoint.save_checkpoint` writes: {params, opt_state,
    params_ema, ema_step, step}, what daclip_tpu's `restore_checkpoint(dir,
    target=state)` gives (`cli/train_restoration.py:216-220`) after the name
    map.

    params and the EMA shadow go through `unet_state_dict_from_jax`; the
    optimizer's moments through the same map (refused if the map would
    compute one that a parameter with a gradient needs) into torch's state:
    AdamW's {step, exp_avg, exp_avg_sq} or Lion's {exp_avg}, indexed as
    `parallel.optimizer_state` indexes them (`optimizer`'s layout, else that
    of `train.restoration.make_optimizer(cfg)` over the UNet the params make,
    built on the meta device), none for the parameters the port's UNet gives
    no gradient (daclip_tpu keeps zeros). The optimizer's count, the step
    and the schedule's count must agree, and with `cfg` the optax chain must
    be the one `cfg` makes; every mismatch, and a dir without `opt_state`
    (daclip_tpu's restoration CLI has no params-only resume), is refused by
    name."""
    from daclip_torch import parallel
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.train import restoration as trest

    directory, step = _resolve(directory, step)
    where = os.path.join(directory, str(step))
    top = orbax_reader.top_level_keys(directory, step)
    missing = {"params", "opt_state", "ema", "step"} - set(top)
    if missing:
        raise ValueError(f"{where} holds {sorted(top)}: daclip_tpu's restoration CLI resumes "
                         "its whole TrainState {params, opt_state, ema, step}, and "
                         f"{sorted(missing)} are missing")
    tree = orbax_reader.restore_checkpoint(directory, step)
    params = _numpy(_unwrap_flax(tree["params"]))
    arch = infer_unet_arch_from_params(params)
    convert = lambda t: unet_state_dict_from_jax(t, depth=len(arch["ch_mult"]))
    opt = _optax_state(tree["opt_state"], where)
    _check_counts(opt, int(tree["step"]), where)
    if cfg is not None:
        name = cfg.optimizer.lower()
        _check_optimizer(opt, "lion" if name == "lion" else "adam",
                         name in ("adamw", "lion") or bool(cfg.weight_decay_G),
                         bool(cfg.grad_clip), f"optimizer {cfg.optimizer!r}, weight_decay_G "
                         f"{cfg.weight_decay_G}, grad_clip {cfg.grad_clip}", where)
    sd = convert(params)
    if unet is None:
        with torch.device("meta"):
            unet = ConditionalUNet(**arch)
    _check_model(sd, unet, where)
    if optimizer is None:
        kind = "Lion" if opt["kind"] == "lion" else "AdamW" if opt["decay"] else "Adam"
        optimizer = trest.make_optimizer([p for _, p in trest.trainable(parallel.unwrap(unet))],
                                         cfg or trest.RestorationTrainConfig(optimizer=kind))
    index, groups = parallel.optimizer_layout(unet, optimizer)
    moments = opt["moments"]
    mu = convert(_numpy(_unwrap_flax(moments["mu"])))
    nu = convert(_numpy(_unwrap_flax(moments["nu"]))) if opt["kind"] == "adam" else None
    skip = _unet_no_grad(_computed_leaves(params, convert), index, where)
    state = _moments_state(opt["kind"], int(moments["count"]), mu, nu, index, skip, where)
    return {"params": sd, "opt_state": {"state": state, "param_groups": groups},
            "params_ema": convert(_numpy(_unwrap_flax(tree["ema"]["params"]))),
            "ema_step": int(tree["ema"]["step"]), "step": int(tree["step"])}


def load_daclip_train_state(directory: str, model, step: Optional[int] = None, cfg=None,
                            optimizer=None, log=None) -> Dict:
    """daclip_tpu's `cli/train_daclip` state at `step` (default the latest)
    of its checkpoints dir (or of one step dir) as the payload the port's
    `utils/checkpoint.save_clip_checkpoint` writes: {epoch, name, step,
    state_dict, optimizer}, what daclip_tpu's resume restores
    (`cli/train_daclip.py:300-343`) after the name map.

    `model` is a DaCLIP (daclip_tpu's plain CLIP runs are refused by name).
    The model is trainable ∪ frozen through `daclip_state_dict_from_jax` (a
    dir without the frozen CLIP gives the trainable part alone); the
    trainable parameters' moments through the same map (the stacked (L, …)
    blocks split per layer) into AdamW's state, keyed by the parameter
    `named_parameters()` gives (once each: the `visual.*` aliases hold no
    state), in `optimizer`'s layout (else that of
    `train.clip_train.make_optimizer` with `cfg`, no LiT mask). The
    layouts are those the CLI writes: adamw with its ndim ≥ 2 decay mask,
    `clip_by_global_norm` first with `grad_clip_norm`; MultiSteps (which its
    accumulation never writes) and other chains are refused by name, as are
    counts that disagree and a clip setting other than `cfg`'s. The epoch is
    the tree's, else the step's. A dir without `opt_state` restores the
    parameters alone, as daclip_tpu's CLI does, and says so on `log`;
    `optimizer` is then None."""
    from daclip_torch import parallel
    from daclip_torch.convert import daclip_trainable_state_dict_from_jax as convert
    from daclip_torch.models.clip import DaCLIP
    from daclip_torch.train import clip_train

    directory, step = _resolve(directory, step)
    where = os.path.join(directory, str(step))
    module = parallel.unwrap(model)
    if not isinstance(module, DaCLIP):
        raise ValueError(f"{where}: resuming daclip_tpu's plain CLIP runs is not mapped; the "
                         f"model is a {type(module).__name__}, not a DaCLIP")
    top = set(orbax_reader.top_level_keys(directory, step))
    if "params" not in top:
        raise ValueError(f"{where} holds {sorted(top)}, no 'params'")
    tree = orbax_reader.restore_checkpoint(directory, step)
    trainable = _numpy(_unwrap_flax(tree["params"]))
    frozen = _numpy(_unwrap_flax(tree.get("frozen") or {}))
    if "visual_control" not in trainable:
        raise ValueError(f"{where}: the params tree is not a DA-CLIP's (no visual_control)")
    sd = (daclip_state_dict_from_jax({**trainable, **frozen}) if "clip" in frozen
          else convert(trainable))
    _check_model(sd, module, where, partial="clip" not in frozen)
    epoch = int(tree["epoch"]) if "epoch" in tree else step
    payload = {"epoch": epoch, "name": None, "step": int(tree.get("step", 0)), "state_dict": sd,
               "optimizer": None}
    if "opt_state" not in top:
        if log is not None:
            log.info("%s holds no optimizer state: the parameters alone are restored, as "
                     "daclip_tpu's CLI restores them", where)
        return payload
    opt = _optax_state(tree["opt_state"], where)
    _check_counts(opt, int(tree["step"]), where)
    clip = bool(cfg.grad_clip_norm) if cfg is not None else opt["clip"]
    _check_optimizer(opt, "adam", True, clip, "AdamW with daclip_tpu's decay mask" + (
        f", grad_clip_norm {cfg.grad_clip_norm}" if cfg is not None else ""), where)
    if optimizer is None:
        named = [(n, p) for n, p in module.named_parameters() if not n.startswith("clip.")]
        optimizer = clip_train.make_optimizer(named, cfg or clip_train.ClipTrainConfig())
    index, groups = parallel.optimizer_layout(module, optimizer)
    moments = opt["moments"]
    mu, nu = (convert(_numpy(_unwrap_flax(moments[k]))) for k in ("mu", "nu"))
    skip = {k for k in _computed_leaves(trainable, convert) if k in index}
    if skip:
        raise ValueError(f"{where}: the weight map computes {sorted(skip)[:4]} instead of "
                         "moving a leaf, so their optimizer moments cannot be read")
    payload["optimizer"] = {"state": _moments_state("adam", int(moments["count"]), mu, nu,
                                                    index, set(), where),
                            "param_groups": groups}
    return payload


def _numpy(tree: Any) -> Any:
    """A restored tree's tensors as numpy arrays (bfloat16 as float32), as
    the converters take them."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    return tree


def load_jax_params(path: str, step: Optional[int] = None) -> Dict:
    """A CLIP or DaCLIP params tree of the JAX package's, as numpy arrays:
    from a flat .npz, or from a `cli/train_daclip` orbax dir (trainable ∪
    frozen; `step`, default the latest)."""
    if checkpoint_kind(path) == "npz":
        return load_params_npz(path)
    return _numpy(load_daclip_train_params(path, step)[0])


# ---------------------------------------------------------------------------
# flat npz


def save_params_npz(path: str, params: Any) -> str:
    """Flatten a params tree (nested dicts of arrays) to one .npz with
    '/'-joined keys."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    rec("", params)
    np.savez(path, **flat)
    return path


def load_params_npz(path: str) -> Dict:
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def infer_unet_arch_from_params(p: Dict) -> Dict:
    """ConditionalUNet constructor arguments read off its flax params tree."""
    ic = np.asarray(p["init_conv"]["kernel"])          # (7, 7, 2·in_nc, nf)
    nf, in_nc = int(ic.shape[-1]), int(ic.shape[2]) // 2
    depth = len([k for k in p if k.startswith("down") and k.endswith("_block1")])
    ch_mult = [int(np.asarray(p[f"down{i}_downsample"]["kernel"]).shape[-1]) // nf
               for i in range(depth)]
    use_degra = "prompt" in p
    context_dim = (int(np.asarray(p["text_mlp_1"]["kernel"]).shape[0])
                   if use_degra else None)
    spatial_levels = [i for i in range(depth) if "proj_in" in p[f"down{i}_attn"]["fn"]]
    use_image = bool(spatial_levels) or "proj_in" in p["mid_attn"]["fn"]
    if use_image and context_dim is None:
        src = p[f"down{spatial_levels[0]}_attn"] if spatial_levels else p["mid_attn"]
        context_dim = int(np.asarray(
            src["fn"]["block0"]["attn2"]["to_k"]["kernel"]).shape[0])
    return {
        "in_nc": in_nc,
        "out_nc": int(np.asarray(p["final_conv"]["kernel"]).shape[-1]),
        "nf": nf, "ch_mult": tuple(ch_mult), "context_dim": context_dim,
        "use_degra_context": use_degra, "use_image_context": use_image,
        "scale": 0.5 if "pre_down" in p else 1.0,
        "spatial_attn_min_level": spatial_levels[0] if spatial_levels else 3,
    }


def load_unet_any(path: str, step: Optional[int] = None,
                  use_ema: bool = True) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(reference-named UNet state dict, constructor arguments) from an
    orbax train dir of daclip_tpu's (or one of its step dirs), a torch
    .pth, a flat .npz, or the port's train dir (for a train dir `step`,
    default the latest, and the EMA parameters unless `use_ema=False`)."""
    kind = checkpoint_kind(path)
    if kind in ("orbax", "orbax_step", "npz"):
        params = (load_params_npz(path) if kind == "npz" else
                  _numpy(load_restoration_params(path, step, use_ema=use_ema)[0]))
        arch = infer_unet_arch_from_params(params)
        return unet_state_dict_from_jax(params, depth=len(arch["ch_mult"])), arch
    if kind == "train_dir":
        sd = train_checkpoint.load_params(path, step=step, use_ema=use_ema)
    else:
        sd = load_torch_state_dict(path)
    return sd, infer_unet_arch(sd)


def load_daclip_any(path: str, image_size: Optional[int] = None,
                    patch_size: Optional[int] = None,
                    step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Reference-named DaCLIP state dict from an orbax train dir of
    daclip_tpu's `cli/train_daclip` (or one of its step dirs; `step`, default
    the latest), a torch .pt, a flat .npz, or the port's DA-CLIP train dir
    (its latest epoch). A torch checkpoint's ViT position embeddings are
    resized to the (image_size // patch_size)² grid, as `convert_daclip`
    does; an orbax dir or an .npz is already in the JAX package's layout and
    is taken as it is."""
    kind = checkpoint_kind(path)
    if kind in ("orbax", "orbax_step", "npz"):
        return daclip_state_dict_from_jax(load_jax_params(path, step))
    if kind == "train_dir":
        raise NotImplementedError(f"{path!r} is a restoration train dir (UNet weights), "
                                  "not DA-CLIP weights")
    if kind == "clip_train_dir":
        sd = train_checkpoint.load_clip_state_dict(path)
    else:
        sd = load_torch_state_dict(path)
    if image_size is not None and patch_size is not None:
        for key in ("clip.visual.positional_embedding", "visual.positional_embedding",
                    "visual_control.positional_embedding"):
            if key in sd:
                sd[key] = resize_pos_embed(sd[key], image_size, patch_size)
    return sd
