"""Weights across the two packages, and the reference checkpoint loader.

`unet_state_dict_from_jax` and `daclip_state_dict_from_jax` are the exact
inverses of `daclip_tpu/utils/torch_convert.py`'s `convert_unet` (:745-788)
and `convert_daclip` (:590-610, with `convert_predictor` :579): they take the
JAX package's parameter trees as nested dicts of numpy arrays and give
reference-named torch state dicts that this package's modules load with
`strict=True`. `resize_pos_embed` is `torch_convert.resize_pos_embed` (:407)
without jax.

Layouts: flax Conv kernel HWIO ↔ torch OIHW; flax Dense kernel (in, out) ↔
torch Linear weight (out, in); ChannelLayerNorm g (C,) ↔ (1, C, 1, 1); the
scanned (L, …) transformer parameters ↔ per-block `resblocks.{i}`; the ViT
patch-embed matmul (p·p·3, width), rows ordered (kh, kw, c) ↔ conv (width, 3,
p, p).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from daclip_torch.transforms import _bicubic


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint as a flat dict of float32 CPU tensors: unwraps
    `state_dict` / `params_ema`, strips the DDP `module.` prefix
    (base_model.py:98-104), falls back to TorchScript archives."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except (RuntimeError, ValueError, EOFError):
        ckpt = torch.jit.load(path, map_location="cpu").state_dict()
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if isinstance(ckpt, dict) and "params_ema" in ckpt:
        ckpt = ckpt["params_ema"]
    out = {}
    for k, v in ckpt.items():
        if k.startswith("module."):
            k = k[7:]
        if torch.is_tensor(v):
            out[k] = v.detach().to(torch.float32)
    return out


def infer_unet_arch(sd: Mapping) -> Dict:
    """ConditionalUNet constructor arguments read off a reference state dict
    (daclip-sde, wild-ir or custom configs)."""
    nf = sd["init_conv.weight"].shape[0]
    in_nc = sd["init_conv.weight"].shape[1] // 2
    depth = len({int(k.split(".")[1]) for k in sd if k.startswith("downs.")})
    ch_mult = [sd[f"downs.{i}.3.weight"].shape[0] // nf for i in range(depth)]
    use_degra = "prompt" in sd
    context_dim = sd["text_mlp.0.weight"].shape[1] if use_degra else None
    spatial_keys = [k for k in sd if ".fn.fn.proj_in.weight" in k]
    use_image = bool(spatial_keys)
    if use_image and context_dim is None:
        k0 = spatial_keys[0].replace("proj_in.weight",
                                     "transformer_blocks.0.attn2.to_k.weight")
        context_dim = sd[k0].shape[1]
    min_level = depth
    for k in spatial_keys:
        if k.startswith("downs."):
            min_level = min(min_level, int(k.split(".")[1]))
    return {
        "in_nc": in_nc, "out_nc": sd["final_conv.weight"].shape[0], "nf": nf,
        "ch_mult": tuple(ch_mult), "context_dim": context_dim,
        "use_degra_context": use_degra, "use_image_context": use_image,
        "scale": 0.5 if "downsample.weight" in sd else 1.0,
        "spatial_attn_min_level": min_level if min_level < depth else 3,
    }


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _oihw(k):
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


class _Writer:
    """Collects reference-named entries as float32 torch tensors."""

    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key, value):
        self.sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def conv(self, key, p):
        self.put(f"{key}.weight", _oihw(p["kernel"]))
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def dense(self, key, p):
        self.put(f"{key}.weight", _t(p["kernel"]))
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def norm(self, key, p):
        self.put(f"{key}.weight", p["scale"])
        self.put(f"{key}.bias", p["bias"])


def _resblock(w: _Writer, key, p):
    w.dense(f"{key}.mlp.1", p["mlp"])
    w.conv(f"{key}.block1.proj", p["block1"]["proj"])
    w.conv(f"{key}.block2.proj", p["block2"]["proj"])
    if "res_conv" in p:
        w.conv(f"{key}.res_conv", p["res_conv"])


def _cross_attention(w: _Writer, key, p):
    for name in ("to_k", "to_v"):
        w.dense(f"{key}.{name}", p[name])
    if "to_q" in p:
        w.dense(f"{key}.to_q", p["to_q"])
    else:
        # the JAX module never creates to_q when its context is one token
        # (the softmax shortcut); the reference state dict has it, unused
        inner = np.asarray(p["to_k"]["kernel"]).shape[1]
        query_dim = np.asarray(p["to_out"]["kernel"]).shape[1]
        w.put(f"{key}.to_q.weight", np.zeros((inner, query_dim), np.float32))
    w.dense(f"{key}.to_out.0", p["to_out"])


def _attn_wrap(w: _Writer, key, p):
    g = np.asarray(p["norm"]["g"])
    w.put(f"{key}.fn.norm.g", g.reshape(1, -1, 1, 1))
    fn = p["fn"]
    base = f"{key}.fn.fn"
    if "to_qkv" in fn:
        w.conv(f"{base}.to_qkv", fn["to_qkv"])
        w.conv(f"{base}.to_out.0", fn["to_out"])
        w.put(f"{base}.to_out.1.g", np.asarray(fn["to_out_norm"]["g"]).reshape(1, -1, 1, 1))
        return
    w.norm(f"{base}.norm", fn["norm"])
    w.conv(f"{base}.proj_in", fn["proj_in"])
    w.conv(f"{base}.proj_out", fn["proj_out"])
    d = 0
    while f"block{d}" in fn:
        b, bk = fn[f"block{d}"], f"{base}.transformer_blocks.{d}"
        _cross_attention(w, f"{bk}.attn1", b["attn1"])
        _cross_attention(w, f"{bk}.attn2", b["attn2"])
        for i in (1, 2, 3):
            w.norm(f"{bk}.norm{i}", b[f"norm{i}"])
        w.dense(f"{bk}.ff.net.0.proj", b["ff_geglu"])
        w.dense(f"{bk}.ff.net.2", b["ff_out"])
        d += 1


def unet_state_dict_from_jax(params: Mapping, depth: int = 4) -> Dict[str, torch.Tensor]:
    """JAX ConditionalUNet params → reference ConditionalUNet state dict
    (inverse of `convert_unet`). The reference's `ups[j]` is level
    i = depth-1-j (DenoisingUNet_arch.py:92)."""
    w = _Writer()
    w.conv("init_conv", params["init_conv"])
    w.dense("time_mlp.1", params["time_mlp_1"])
    w.dense("time_mlp.3", params["time_mlp_2"])
    if "prompt" in params:
        w.put("prompt", params["prompt"])
        w.dense("text_mlp.0", params["text_mlp_1"])
        w.dense("text_mlp.2", params["text_mlp_2"])
        w.dense("prompt_mlp", params["prompt_mlp"])
    for i in range(depth):
        _resblock(w, f"downs.{i}.0", params[f"down{i}_block1"])
        _resblock(w, f"downs.{i}.1", params[f"down{i}_block2"])
        _attn_wrap(w, f"downs.{i}.2", params[f"down{i}_attn"])
        w.conv(f"downs.{i}.3", params[f"down{i}_downsample"])
        j = depth - 1 - i
        _resblock(w, f"ups.{j}.0", params[f"up{i}_block1"])
        _resblock(w, f"ups.{j}.1", params[f"up{i}_block2"])
        _attn_wrap(w, f"ups.{j}.2", params[f"up{i}_attn"])
        up = params[f"up{i}_upsample"]
        w.conv(f"ups.{j}.3.1" if i != 0 else f"ups.{j}.3", up["conv"] if i != 0 else up)
    _resblock(w, "mid_block1", params["mid_block1"])
    _attn_wrap(w, "mid_attn", params["mid_attn"])
    _resblock(w, "mid_block2", params["mid_block2"])
    _resblock(w, "final_res_block", params["final_res_block"])
    w.conv("final_conv", params["final_conv"])
    if "pre_down" in params:  # wild-ir scale=0.5
        w.conv("downsample", params["pre_down"]["conv"])
        w.conv("upsample.1", params["post_up"]["conv"])
    return w.sd


def _resblocks(w: _Writer, prefix, p, zero_prefix=None):
    """Unstack the scanned (L, …) block params into `{prefix}.{i}.*`."""
    L = np.asarray(p["ln_1"]["scale"]).shape[0]
    for i in range(L):
        k = f"{prefix}.{i}"
        w.put(f"{k}.ln_1.weight", p["ln_1"]["scale"][i])
        w.put(f"{k}.ln_1.bias", p["ln_1"]["bias"][i])
        w.put(f"{k}.ln_2.weight", p["ln_2"]["scale"][i])
        w.put(f"{k}.ln_2.bias", p["ln_2"]["bias"][i])
        a = p["attn"]
        w.put(f"{k}.attn.in_proj_weight", _t(a["in_proj"]["kernel"][i]))
        w.put(f"{k}.attn.in_proj_bias", a["in_proj"]["bias"][i])
        w.put(f"{k}.attn.out_proj.weight", _t(a["out_proj"]["kernel"][i]))
        w.put(f"{k}.attn.out_proj.bias", a["out_proj"]["bias"][i])
        for name in ("c_fc", "c_proj"):
            w.put(f"{k}.mlp.{name}.weight", _t(p["mlp"][name]["kernel"][i]))
            w.put(f"{k}.mlp.{name}.bias", p["mlp"][name]["bias"][i])
        if zero_prefix is not None:
            w.put(f"{zero_prefix}.{i}.weight", _t(p["zero_module"]["kernel"][i]))
            w.put(f"{zero_prefix}.{i}.bias", p["zero_module"]["bias"][i])


def _visual(w: _Writer, prefix, p, transformer_sub="transformer.resblocks",
            zero_prefix=None):
    kernel = np.asarray(p["conv1"])
    width = kernel.shape[1]
    patch = int(round((kernel.shape[0] // 3) ** 0.5))
    w.put(f"{prefix}.conv1.weight",
          np.transpose(kernel.reshape(patch, patch, 3, width), (3, 2, 0, 1)))
    w.put(f"{prefix}.class_embedding", p["class_embedding"])
    w.put(f"{prefix}.positional_embedding", p["positional_embedding"])
    w.norm(f"{prefix}.ln_pre", p["ln_pre"])
    w.norm(f"{prefix}.ln_post", p["ln_post"])
    w.put(f"{prefix}.proj", p["proj"])
    _resblocks(w, f"{prefix}.{transformer_sub}", p["transformer"]["resblocks"],
               zero_prefix)


def _clip(w: _Writer, prefix: str, clip: Mapping):
    _visual(w, f"{prefix}visual", clip["visual"])
    text = clip["text"]
    w.put(f"{prefix}token_embedding.weight", text["token_embedding"])
    w.put(f"{prefix}positional_embedding", text["positional_embedding"])
    w.norm(f"{prefix}ln_final", text["ln_final"])
    w.put(f"{prefix}text_projection", text["text_projection"])
    _resblocks(w, f"{prefix}transformer.resblocks", text["transformer"]["resblocks"])
    w.put(f"{prefix}logit_scale", clip["logit_scale"])


def clip_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX CLIP params (`visual`, `text`, `logit_scale`) → reference CLIP
    state dict (inverse of `convert_clip`), the text tower inlined."""
    w = _Writer()
    _clip(w, "", params)
    return w.sd


def daclip_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DaCLIP params → reference DaCLIP state dict (inverse of
    `convert_daclip`), with both the `clip.visual.*` and `visual.*` aliases."""
    w = _Writer()
    clip = params["clip"]
    _clip(w, "clip.", clip)
    _visual(w, "visual", clip["visual"])
    _visual(w, "visual_control", params["visual_control"],
            transformer_sub="transformer.transformer.resblocks",
            zero_prefix="visual_control.transformer.zero_modules")
    w.put("logit_scale", params["logit_scale"])
    if "predictor" in params:
        p = params["predictor"]
        for i in range(np.asarray(p["reg_w1"]).shape[0]):
            k = f"predictor.regressors.{i}"
            w.put(f"{k}.0.weight", _t(p["reg_w1"][i]))
            w.put(f"{k}.0.bias", p["reg_b1"][i])
            w.put(f"{k}.2.weight", _t(p["reg_w2"][i]))
            w.put(f"{k}.2.bias", p["reg_b2"][i])
    return w.sd


def _cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of `jax.image.resize(method="cubic",
    antialias=True)` along one axis: Keys' a = -0.5 kernel at half-pixel
    centres, widened by n_in / n_out when shrinking, each row normalised
    over the input's extent."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = _bicubic((sample[:, None] - np.arange(n_in)[None, :]) / kernel_scale)
    return w / w.sum(axis=1, keepdims=True)


def resize_pos_embed(pos_embed, image_size: int, patch_size: int) -> torch.Tensor:
    """A ViT's (1 + g·g, D) position embedding on an (image_size //
    patch_size)² grid (model.py:451-483): the class token is kept and the
    grid resized as `torch_convert.resize_pos_embed` does (bicubic with
    antialias); unchanged when the grid already fits."""
    pos = torch.as_tensor(pos_embed, dtype=torch.float32)
    g_new = image_size // patch_size
    if g_new * g_new + 1 == pos.shape[0]:
        return pos
    tok, grid = pos[:1], pos[1:].double().numpy()
    g_old = int(math.sqrt(grid.shape[0]))
    m = _cubic_resize_matrix(g_old, g_new)
    grid = np.einsum("ai,ijd,bj->abd", m, grid.reshape(g_old, g_old, -1), m)
    return torch.cat([tok, torch.from_numpy(grid.reshape(g_new * g_new, -1)).float()])
