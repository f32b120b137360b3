"""Weights across the two packages, and the reference checkpoint loader.

`unet_state_dict_from_jax` and `daclip_state_dict_from_jax` are the exact
inverses of `daclip_tpu/utils/torch_convert.py`'s `convert_unet` (:745-788)
and `convert_daclip` (:590-610, with `convert_predictor` :579): they take the
JAX package's parameter trees as nested dicts of numpy arrays and give
reference-named torch state dicts that this package's modules load with
`strict=True`. `clip_state_dict_from_jax` takes every image tower (the
inverse of `convert_resnet_visual` :124, `convert_convnext_visual` :157,
`convert_eva_visual` :217, `convert_timm_vit_visual` :291,
`convert_swin_visual` :346, `convert_clip`'s `text.` prefix :463-466) and
`coca_state_dict_from_jax` CoCa (`convert_coca` :509).
`resize_pos_embed` is `torch_convert.resize_pos_embed` (:407) without jax.

Each map is one walk (`_Map`) that runs in either direction:
`unet_state_dict_to_jax`, `clip_state_dict_to_jax`,
`daclip_state_dict_to_jax` and `daclip_trainable_state_dict_to_jax` walk
the same table backwards, from a state dict to daclip_tpu's tree, bit for
bit, dropping what the forward map computes instead of moving (the UNet's
one-token `to_q`, BatchNorm's `num_batches_tracked`) and refusing by name a
key that no walk reads.

Layouts: flax Conv kernel HWIO ↔ torch OIHW; flax Dense kernel (in, out) ↔
torch Linear weight (out, in); ChannelLayerNorm g (C,) ↔ (1, C, 1, 1); the
scanned (L, …) transformer parameters ↔ per-block `resblocks.{i}`; the ViT
patch-embed matmul (p·p·3, width), rows ordered (kh, kw, c) ↔ conv (width, 3,
p, p).
"""
from __future__ import annotations

import math
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from daclip_torch.transforms import _bicubic
from daclip_torch.utils import HOST_THREADS


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


def _patch_conv(kernel, channels: int = 3):
    """A pixel-major (p·p·C, D) patch matmul kernel → conv weight (D, C, p, p)."""
    kernel = np.asarray(kernel)
    patch = int(round((kernel.shape[0] // channels) ** 0.5))
    return np.transpose(kernel.reshape(patch, patch, channels, -1), (3, 2, 0, 1))


def _contig(f):
    return lambda a: np.ascontiguousarray(f(np.asarray(a)))


# the moves of the map, each (JAX leaf as a numpy array → the torch layout,
# the inverse on a torch tensor: torch's copies are the fast ones)
_ID = (lambda a: a, lambda t: t)
_T = (_t, lambda t: t.t().contiguous())
_OIHW = (_oihw, lambda t: t.permute(2, 3, 1, 0).contiguous())
_G4 = (_contig(lambda g: g.reshape(1, -1, 1, 1)), lambda t: t.reshape(-1))
_PATCH = (_contig(_patch_conv), lambda t: t.permute(2, 3, 1, 0).reshape(-1, t.shape[0]))
_ROW3 = (_contig(lambda a: a.reshape(1, 1, -1)), lambda t: t.reshape(-1))
_LEAD1 = (_contig(lambda a: a[None]), lambda t: t[0])


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(np.ascontiguousarray(a).view(np.int32),
                                                 np.ascontiguousarray(b).view(np.int32))


class _Node(dict):
    """A JAX tree being rebuilt by a reversed walk: a missing child is made
    on first use."""

    def __missing__(self, key):
        child = self[key] = _Node()
        return child


class _Stack(dict):
    """The layers of a stacked (L, …) leaf being rebuilt, by index."""


class _Map:
    """One walk of a weight map, in either direction, so that the two cannot
    drift: the walkers below are the one table of both.

    Forward (`sd` None): each primitive reads leaves of the JAX tree it is
    given (nested dicts of arrays) and puts reference-named float32 tensors
    into `self.sd`. Reversed (`sd` given): the same primitive reads `sd`'s
    tensors, undoes the move and puts the JAX leaves (float32 numpy arrays)
    into the `_Node` it is given; `used` gathers the keys read, `computed`
    those the forward map computes rather than moves (dropped on the way
    back), and a leaf put twice (an alias) must be the same bits."""

    def __init__(self, sd: Optional[Mapping] = None):
        self.reverse = sd is not None
        self.sd = {} if sd is None else sd
        self.used, self.computed = set(), set()
        # reversed: (the copies undoing a move, the leaves they fill), run by `_reverse`
        self.moves = []

    # -- structure
    def has(self, p, name: str, key: str) -> bool:
        """Whether the JAX node `p` has `name` (forward), or the state dict
        `key` (reversed): the key that the child's first leaf maps to."""
        return key in self.sd if self.reverse else name in p

    def layers(self, count, key: str) -> int:
        """A stacked leaf's L: `count()` forward; reversed, how many of
        `key.format(0)`, `key.format(1)`, … the state dict holds."""
        if not self.reverse:
            return int(count())
        n = 0
        while key.format(n) in self.sd:
            n += 1
        return n

    def names(self, p, select, pattern: str, make) -> list:
        """The children of `p` that `select(p)` lists (forward); reversed,
        `make(*groups)` of every state-dict key that matches `pattern`."""
        if not self.reverse:
            return select(p)
        rx = re.compile(pattern)
        return sorted({make(*m.groups()) for m in map(rx.fullmatch, self.sd) if m})

    # -- leaves
    def _take(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise KeyError(f"the state dict has no {key!r}, which the weight map reads")
        self.used.add(key)
        t = self.sd[key]
        return (t.detach().cpu().float() if torch.is_tensor(t)
                else torch.from_numpy(np.asarray(t, dtype=np.float32)))

    @staticmethod
    def _leaf(t: torch.Tensor) -> np.ndarray:
        return t.contiguous().numpy()

    @staticmethod
    def _get(p, name, i):
        v = np.asarray(p[name])
        return v if i is None else v[i]

    @staticmethod
    def _set(p, name, i, value, key):
        if i is None:
            old = dict.get(p, name)
            if isinstance(old, _Node) and not old:
                old = None
            if old is not None and not (isinstance(old, np.ndarray) and _same_bits(old, value)):
                raise ValueError(f"{key}: maps to a JAX leaf that another key put, with "
                                 "other values")
            p[name] = value
            return
        st = dict.get(p, name)
        if st is None or (isinstance(st, _Node) and not st):
            st = p[name] = _Stack()
        if i in st and not _same_bits(st[i], value):
            raise ValueError(f"{key}: layer {i} put twice, with other values")
        st[i] = value

    def put(self, key: str, p, name: str, op=_ID, i: Optional[int] = None):
        """`key` ↔ leaf `name` of `p` (layer `i` of it when stacked), moved by
        `op`."""
        if self.reverse:
            t = self._take(key)
            self.moves.append((lambda: [self._leaf(op[1](t))], [(p, name, i, key)]))
        else:
            self.sd[key] = torch.from_numpy(np.array(op[0](self._get(p, name, i)),
                                                     dtype=np.float32))

    def put_array(self, key: str, value):
        """A forward-only entry (a map with no reversed walk)."""
        if self.reverse:
            raise NotImplementedError(f"{key}: this map has no reversed walk")
        self.sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def concat(self, key: str, refs, op=_ID, i: Optional[int] = None):
        """`key` ↔ the leaves (p, name) of `refs`, each moved by `op`,
        concatenated along the first axis in equal parts."""
        if self.reverse:
            t = self._take(key)
            self.moves.append((lambda: [self._leaf(op[1](part)) for part in t.chunk(len(refs))],
                               [(p, name, i, key) for p, name in refs]))
        else:
            self.sd[key] = torch.from_numpy(np.array(np.concatenate(
                [op[0](self._get(p, name, i)) for p, name in refs]), dtype=np.float32))

    def fill(self, key: str, make):
        """A key the forward map computes (`make()`), moving no leaf: dropped
        on the way back."""
        if self.reverse:
            if key not in self.sd:
                raise KeyError(f"the state dict has no {key!r}")
            self.used.add(key)
            self.computed.add(key)
        else:
            self.sd[key] = make()

    # -- layers
    def conv(self, key, p):
        self.put(f"{key}.weight", p, "kernel", _OIHW)
        if self.has(p, "bias", f"{key}.bias"):
            self.put(f"{key}.bias", p, "bias")

    def dense(self, key, p, i: Optional[int] = None):
        self.put(f"{key}.weight", p, "kernel", _T, i)
        if self.has(p, "bias", f"{key}.bias"):
            self.put(f"{key}.bias", p, "bias", i=i)

    def norm(self, key, p, i: Optional[int] = None):
        self.put(f"{key}.weight", p, "scale", i=i)
        self.put(f"{key}.bias", p, "bias", i=i)


def _finish(node):
    """A rebuilt tree as plain dicts, stacked leaves stacked (every layer
    from 0 present), nodes left empty dropped."""
    if isinstance(node, _Stack):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"a stacked leaf misses layers: has {sorted(node)}")
        return torch.stack([torch.from_numpy(node[i]) for i in range(len(node))]).numpy()
    if isinstance(node, dict):
        out = {k: _finish(v) for k, v in node.items()}
        return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
    return node


def _reverse(sd: Mapping, walk, dropped: Optional[set] = None) -> Dict:
    """The JAX tree `walk(map, tree)` rebuilds from `sd` (the keys dropped as
    computed added to `dropped`); a key of `sd` the walk does not read is
    refused by name."""
    w = _Map(sd)
    tree = _Node()
    walk(w, tree)
    # the copies on several threads (torch's strided copies are single-threaded
    # and release the GIL), the leaves then set in the walk's order
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        done = list(pool.map(lambda move: move[0](), w.moves))
    for (_, where), leaves in zip(w.moves, done):
        for (p, name, i, key), leaf in zip(where, leaves):
            w._set(p, name, i, leaf, key)
    unused = sorted(set(sd) - w.used)
    if unused:
        raise ValueError(f"the weight map moves no JAX leaf to {unused[:6]} ({len(unused)} keys "
                         "of the state dict): not this model's layout")
    if dropped is not None:
        dropped |= w.computed
    return _finish(tree)


def _resblock(w: _Map, key, p):
    w.dense(f"{key}.mlp.1", p["mlp"])
    w.conv(f"{key}.block1.proj", p["block1"]["proj"])
    w.conv(f"{key}.block2.proj", p["block2"]["proj"])
    if w.has(p, "res_conv", f"{key}.res_conv.weight"):
        w.conv(f"{key}.res_conv", p["res_conv"])


def _cross_attention(w: _Map, key, p, one_token: bool):
    """The JAX module never creates to_q when its context is one token (the
    softmax shortcut: attn2, whose context is the image embedding); the
    reference state dict has it, unused: zeros forward, dropped back."""
    for name in ("to_k", "to_v"):
        w.dense(f"{key}.{name}", p[name])
    if (not one_token) if w.reverse else "to_q" in p:
        w.dense(f"{key}.to_q", p["to_q"])
    else:
        w.fill(f"{key}.to_q.weight", lambda: torch.zeros(
            np.asarray(p["to_k"]["kernel"]).shape[1], np.asarray(p["to_out"]["kernel"]).shape[1]))
    w.dense(f"{key}.to_out.0", p["to_out"])


def _attn_wrap(w: _Map, key, p):
    w.put(f"{key}.fn.norm.g", p["norm"], "g", _G4)
    fn = p["fn"]
    base = f"{key}.fn.fn"
    if w.has(fn, "to_qkv", f"{base}.to_qkv.weight"):
        w.conv(f"{base}.to_qkv", fn["to_qkv"])
        w.conv(f"{base}.to_out.0", fn["to_out"])
        w.put(f"{base}.to_out.1.g", fn["to_out_norm"], "g", _G4)
        return
    w.norm(f"{base}.norm", fn["norm"])
    w.conv(f"{base}.proj_in", fn["proj_in"])
    w.conv(f"{base}.proj_out", fn["proj_out"])
    d = 0
    while w.has(fn, f"block{d}", f"{base}.transformer_blocks.{d}.norm1.weight"):
        b, bk = fn[f"block{d}"], f"{base}.transformer_blocks.{d}"
        _cross_attention(w, f"{bk}.attn1", b["attn1"], one_token=False)
        _cross_attention(w, f"{bk}.attn2", b["attn2"], one_token=True)
        for i in (1, 2, 3):
            w.norm(f"{bk}.norm{i}", b[f"norm{i}"])
        w.dense(f"{bk}.ff.net.0.proj", b["ff_geglu"])
        w.dense(f"{bk}.ff.net.2", b["ff_out"])
        d += 1


def _unet(w: _Map, params, depth: int):
    """The reference's `ups[j]` is level i = depth-1-j (DenoisingUNet_arch.py:92)."""
    w.conv("init_conv", params["init_conv"])
    w.dense("time_mlp.1", params["time_mlp_1"])
    w.dense("time_mlp.3", params["time_mlp_2"])
    if w.has(params, "prompt", "prompt"):
        w.put("prompt", params, "prompt")
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
    if w.has(params, "pre_down", "downsample.weight"):  # wild-ir scale=0.5
        w.conv("downsample", params["pre_down"]["conv"])
        w.conv("upsample.1", params["post_up"]["conv"])


def unet_state_dict_from_jax(params: Mapping, depth: int = 4) -> Dict[str, torch.Tensor]:
    """JAX ConditionalUNet params → reference ConditionalUNet state dict
    (inverse of `convert_unet`)."""
    w = _Map()
    _unet(w, params, depth)
    return w.sd


def unet_state_dict_to_jax(sd: Mapping, depth: Optional[int] = None,
                           dropped: Optional[set] = None) -> Dict:
    """The inverse of `unet_state_dict_from_jax`: daclip_tpu's params tree
    (float32 numpy arrays) of a reference-named UNet state dict, its depth
    read off the keys by default. The one-token cross-attentions' `to_q`,
    which daclip_tpu never creates, is dropped (its keys added to
    `dropped` when given)."""
    if depth is None:
        depth = len({k.split(".")[1] for k in sd if k.startswith("downs.")})
    return _reverse(sd, lambda w, t: _unet(w, t, depth), dropped)


def _resblocks(w: _Map, prefix, p, zero_prefix=None):
    """The scanned (L, …) block params ↔ `{prefix}.{i}.*`."""
    L = w.layers(lambda: np.asarray(p["ln_1"]["scale"]).shape[0], f"{prefix}.{{}}.ln_1.weight")
    for i in range(L):
        k = f"{prefix}.{i}"
        if w.has(p, "ls_1", f"{prefix}.0.ls_1.gamma"):  # LayerScale (ViT-M-16-alt)
            w.put(f"{k}.ls_1.gamma", p, "ls_1", i=i)
            w.put(f"{k}.ls_2.gamma", p, "ls_2", i=i)
        w.norm(f"{k}.ln_1", p["ln_1"], i)
        w.norm(f"{k}.ln_2", p["ln_2"], i)
        a = p["attn"]
        w.put(f"{k}.attn.in_proj_weight", a["in_proj"], "kernel", _T, i)
        w.put(f"{k}.attn.in_proj_bias", a["in_proj"], "bias", i=i)
        w.dense(f"{k}.attn.out_proj", a["out_proj"], i)
        for name in ("c_fc", "c_proj"):
            w.dense(f"{k}.mlp.{name}", p["mlp"][name], i)
        if zero_prefix is not None:
            w.dense(f"{zero_prefix}.{i}", p["zero_module"], i)


def _visual(w: _Map, prefix, p, transformer_sub="transformer.resblocks",
            zero_prefix=None):
    w.put(f"{prefix}.conv1.weight", p, "conv1", _PATCH)
    w.put(f"{prefix}.class_embedding", p, "class_embedding")
    w.put(f"{prefix}.positional_embedding", p, "positional_embedding")
    w.norm(f"{prefix}.ln_pre", p["ln_pre"])
    w.norm(f"{prefix}.ln_post", p["ln_post"])
    w.put(f"{prefix}.proj", p, "proj")
    _resblocks(w, f"{prefix}.{transformer_sub}", p["transformer"]["resblocks"],
               zero_prefix)


def _text(w: _Map, prefix: str, text: Mapping):
    w.put(f"{prefix}token_embedding.weight", text, "token_embedding")
    w.put(f"{prefix}positional_embedding", text, "positional_embedding")
    w.norm(f"{prefix}ln_final", text["ln_final"])
    w.put(f"{prefix}text_projection", text, "text_projection")
    if w.has(text, "cls_emb", f"{prefix}cls_emb"):
        w.put(f"{prefix}cls_emb", text, "cls_emb")
    _resblocks(w, f"{prefix}transformer.resblocks", text["transformer"]["resblocks"])


def _clip(w: _Map, prefix: str, clip: Mapping, custom_text: bool = False):
    _any_visual(w, f"{prefix}visual", clip["visual"])
    _text(w, f"{prefix}text." if custom_text else prefix, clip["text"])
    w.put(f"{prefix}logit_scale", clip, "logit_scale")


def clip_state_dict_from_jax(params: Mapping,
                             custom_text: bool = False) -> Dict[str, torch.Tensor]:
    """JAX CLIP params (`visual`, `text`, `logit_scale`) → reference CLIP
    state dict (inverse of `convert_clip`), for every image tower; the text
    tower inlined, or under CustomTextCLIP's `text.` with `custom_text`
    (`convert_clip` :463-466 reads either)."""
    w = _Map()
    _clip(w, "", params, custom_text)
    return w.sd


def clip_state_dict_to_jax(sd: Mapping, custom_text: Optional[bool] = None,
                           dropped: Optional[set] = None) -> Dict:
    """The inverse of `clip_state_dict_from_jax`: daclip_tpu's CLIP params
    tree of a reference-named CLIP state dict (the text tower under `text.`
    when the keys say so, or with `custom_text`); BatchNorm's
    `num_batches_tracked`, which daclip_tpu does not keep, is dropped (into
    `dropped` when given)."""
    if custom_text is None:
        custom_text = "text.token_embedding.weight" in sd
    return _reverse(sd, lambda w, t: _clip(w, "", t, custom_text), dropped)


def _daclip(w: _Map, params):
    clip = params["clip"]
    _clip(w, "clip.", clip)
    _visual(w, "visual", clip["visual"])
    _daclip_trainable(w, params)


def daclip_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DaCLIP params → reference DaCLIP state dict (inverse of
    `convert_daclip`), with both the `clip.visual.*` and `visual.*` aliases."""
    w = _Map()
    _daclip(w, params)
    return w.sd


def daclip_state_dict_to_jax(sd: Mapping) -> Dict:
    """The inverse of `daclip_state_dict_from_jax` (the `visual.*` aliases
    must equal `clip.visual.*` bit for bit)."""
    return _reverse(sd, _daclip)


def daclip_trainable_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The part of `daclip_state_dict_from_jax` that DA-CLIP trains (its
    controller, `logit_scale`, the predictor), from a tree that holds those
    alone: daclip_tpu's trainable parameters, or an optimizer's moments of
    them."""
    w = _Map()
    _daclip_trainable(w, params)
    return w.sd


def daclip_trainable_state_dict_to_jax(sd: Mapping) -> Dict:
    """The inverse of `daclip_trainable_state_dict_from_jax`."""
    return _reverse(sd, _daclip_trainable)


def _daclip_trainable(w: _Map, params: Mapping):
    _visual(w, "visual_control", params["visual_control"],
            transformer_sub="transformer.transformer.resblocks",
            zero_prefix="visual_control.transformer.zero_modules")
    w.put("logit_scale", params, "logit_scale")
    if w.has(params, "predictor", "predictor.regressors.0.0.weight"):
        p = params["predictor"]
        for i in range(w.layers(lambda: np.asarray(p["reg_w1"]).shape[0],
                                "predictor.regressors.{}.0.weight")):
            k = f"predictor.regressors.{i}"
            w.put(f"{k}.0.weight", p, "reg_w1", _T, i)
            w.put(f"{k}.0.bias", p, "reg_b1", i=i)
            w.put(f"{k}.2.weight", p, "reg_w2", _T, i)
            w.put(f"{k}.2.bias", p, "reg_b2", i=i)


# -- the other image towers (inverses of torch_convert's convert_*_visual) ----
def _stacked(w: _Map, key: str, parent: Mapping, name: str, i: int):
    """Layer i of a stacked dense / norm / raw leaf (forward told apart by
    the JAX node, reversed by the state dict's keys)."""
    if w.reverse:
        kind = ("raw" if key in w.sd else
                "dense" if w.sd[f"{key}.weight"].dim() == 2 else "norm")
    else:
        q = parent[name]
        kind = ("dense" if isinstance(q, Mapping) and "kernel" in q else
                "norm" if isinstance(q, Mapping) else "raw")
    if kind == "dense":
        w.dense(key, parent[name], i)
    elif kind == "norm":
        w.norm(key, parent[name], i)
    else:
        w.put(key, parent, name, i=i)


def _bn(w: _Map, key: str, p: Mapping):
    w.norm(key, p)
    w.put(f"{key}.running_mean", p, "mean")
    w.put(f"{key}.running_var", p, "var")
    w.fill(f"{key}.num_batches_tracked", lambda: torch.tensor(0))


def _resnet(w: _Map, prefix: str, p: Mapping):
    """Inverse of `convert_resnet_visual` (:124)."""
    for i in (1, 2, 3):
        w.conv(f"{prefix}.conv{i}", p[f"stem_conv{i}"])
        _bn(w, f"{prefix}.bn{i}", p[f"stem_bn{i}"])
    layers = w.names(p, lambda q: sorted(k for k in q if k.startswith("layer")),
                     rf"{re.escape(prefix)}\.layer(\d+)\.(\d+)\.conv1\.weight",
                     lambda li, bi: f"layer{li}_{bi}")
    for name in layers:
        li, bi = name[len("layer"):].split("_")
        b, key = p[name], f"{prefix}.layer{li}.{bi}"
        for c in (1, 2, 3):
            w.conv(f"{key}.conv{c}", b[f"conv{c}"])
            _bn(w, f"{key}.bn{c}", b[f"bn{c}"])
        if w.has(b, "down_conv", f"{key}.downsample.0.weight"):
            w.conv(f"{key}.downsample.0", b["down_conv"])
            _bn(w, f"{key}.downsample.1", b["down_bn"])
    ap = p["attnpool"]
    w.put(f"{prefix}.attnpool.positional_embedding", ap, "positional_embedding")
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        w.dense(f"{prefix}.attnpool.{name}", ap[name])


def _adapter_head(w: _Map, prefix: str, p: Mapping):
    """open_clip TimmModel's head: `head.proj` or `head.mlp.fc{1,2}`."""
    if w.has(p, "proj", f"{prefix}.head.proj.weight"):
        w.dense(f"{prefix}.head.proj", p["proj"])
    elif w.has(p, "mlp_fc1", f"{prefix}.head.mlp.fc1.weight"):
        w.dense(f"{prefix}.head.mlp.fc1", p["mlp_fc1"])
        w.dense(f"{prefix}.head.mlp.fc2", p["mlp_fc2"])


def _convnext(w: _Map, prefix: str, p: Mapping):
    """Inverse of `convert_convnext_visual` (:157), timm's new names."""
    tr, t = p["trunk"], f"{prefix}.trunk"
    w.conv(f"{t}.stem.0", tr["stem_conv"])
    w.norm(f"{t}.stem.1", tr["stem_norm"])
    w.norm(f"{t}.head.norm", tr["head_norm"])
    si = 0
    while w.has(tr, f"stage{si}_block0", f"{t}.stages.{si}.blocks.0.conv_dw.weight"):
        if si > 0:
            w.norm(f"{t}.stages.{si}.downsample.0", tr[f"downsample_norm{si}"])
            w.conv(f"{t}.stages.{si}.downsample.1", tr[f"downsample_conv{si}"])
        bj = 0
        while w.has(tr, f"stage{si}_block{bj}", f"{t}.stages.{si}.blocks.{bj}.conv_dw.weight"):
            b, key = tr[f"stage{si}_block{bj}"], f"{t}.stages.{si}.blocks.{bj}"
            w.conv(f"{key}.conv_dw", b["dwconv"])
            w.norm(f"{key}.norm", b["norm"])
            w.dense(f"{key}.mlp.fc1", b["pwconv1"])
            w.dense(f"{key}.mlp.fc2", b["pwconv2"])
            w.put(f"{key}.gamma", b, "gamma")
            bj += 1
        si += 1
    _adapter_head(w, prefix, p)


def _patch_embed(w: _Map, t: str, p: Mapping):
    w.put(f"{t}.patch_embed.proj.weight", p, "patch_embed", _PATCH)
    w.put(f"{t}.patch_embed.proj.bias", p, "patch_bias")
    if w.has(p, "cls_token", f"{t}.cls_token"):
        w.put(f"{t}.cls_token", p, "cls_token", _ROW3)
    if w.has(p, "pos_embed", f"{t}.pos_embed"):
        w.put(f"{t}.pos_embed", p, "pos_embed", _LEAD1)


def _eva(w: _Map, prefix: str, p: Mapping):
    """Inverse of `convert_eva_visual` (:217)."""
    t = f"{prefix}.trunk"
    _patch_embed(w, t, p)
    blocks = p["blocks"]
    attn_names = w.names(blocks["attn"], list,
                         rf"{re.escape(t)}\.blocks\.0\.attn\.([^.]+)(?:\.weight|\.bias)?",
                         lambda n: n)
    for i in range(w.layers(lambda: np.asarray(blocks["norm1"]["scale"]).shape[0],
                            f"{t}.blocks.{{}}.norm1.weight")):
        key = f"{t}.blocks.{i}"
        for name in ("norm1", "norm2", "mlp_fc1", "mlp_fc1_g", "mlp_fc1_x", "mlp_fc2",
                     "mlp_norm"):
            sub = f"{key}.{name.replace('mlp_', 'mlp.')}"
            if w.has(blocks, name, f"{sub}.weight"):
                _stacked(w, sub, blocks, name, i)
        for name in attn_names:
            _stacked(w, f"{key}.attn.{name}", blocks["attn"], name, i)
    w.norm(f"{t}.norm", p["norm"])
    w.dense(f"{t}.head", p["head"])


_TIMM_VIT_NAMES = {"norm1": "norm1", "norm2": "norm2", "qkv": "attn.qkv", "proj": "attn.proj",
                   "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2", "ls_1": "ls1.gamma",
                   "ls_2": "ls2.gamma", "relpos_fc1": "attn.rel_pos.mlp.fc1",
                   "relpos_fc2": "attn.rel_pos.mlp.fc2"}


def _timm_vit(w: _Map, prefix: str, p: Mapping):
    """Inverse of `convert_timm_vit_visual` (:291)."""
    t = f"{prefix}.trunk"
    _patch_embed(w, t, p)
    blocks = p["blocks"]
    first = f"{t}.blocks.0"
    present = list(blocks) if not w.reverse else [
        n for n, s in _TIMM_VIT_NAMES.items()
        if f"{first}.{s}" in w.sd or f"{first}.{s}.weight" in w.sd]
    for i in range(w.layers(lambda: np.asarray(blocks["norm1"]["scale"]).shape[0],
                            f"{t}.blocks.{{}}.norm1.weight")):
        for name in present:
            _stacked(w, f"{t}.blocks.{i}.{_TIMM_VIT_NAMES[name]}", blocks, name, i)
    w.norm(f"{t}.norm", p["norm"])
    w.dense(f"{prefix}.head.proj", p["proj"])


def _swin(w: _Map, prefix: str, p: Mapping):
    """Inverse of `convert_swin_visual` (:346), timm ≥ 0.9's layout."""
    t = f"{prefix}.trunk"
    w.conv(f"{t}.patch_embed.proj", p["patch_embed"])
    w.norm(f"{t}.patch_embed.norm", p["patch_norm"])
    w.norm(f"{t}.norm", p["norm"])
    si = 0
    while w.has(p, f"stage{si}_block0", f"{t}.layers.{si}.blocks.0.norm1.weight"):
        if si > 0:
            w.norm(f"{t}.layers.{si}.downsample.norm", p[f"merge_norm{si}"])
            w.dense(f"{t}.layers.{si}.downsample.reduction", p[f"merge_proj{si}"])
        bj = 0
        while w.has(p, f"stage{si}_block{bj}", f"{t}.layers.{si}.blocks.{bj}.norm1.weight"):
            b, key = p[f"stage{si}_block{bj}"], f"{t}.layers.{si}.blocks.{bj}"
            w.norm(f"{key}.norm1", b["norm1"])
            w.norm(f"{key}.norm2", b["norm2"])
            w.dense(f"{key}.attn.qkv", b["attn"]["qkv"])
            w.dense(f"{key}.attn.proj", b["attn"]["proj"])
            w.put(f"{key}.attn.relative_position_bias_table", b["attn"], "rel_pos_table")
            w.dense(f"{key}.mlp.fc1", b["mlp_fc1"])
            w.dense(f"{key}.mlp.fc2", b["mlp_fc2"])
            bj += 1
        si += 1
    _adapter_head(w, prefix, p)


def _attn_pool(w: _Map, key: str, p: Mapping):
    """CoCa's AttentionalPooler: its query, norms and attention (q/k/v
    apart when the tokens are wider than the queries, torch's layout)."""
    w.put(f"{key}.query", p, "query")
    w.norm(f"{key}.ln_q", p["ln_q"])
    w.norm(f"{key}.ln_k", p["ln_k"])
    _cross_mha(w, f"{key}.attn", p["attn"])


def _cross_mha(w: _Map, key: str, a: Mapping, i=None):
    """A CrossMultiheadAttention tree (layer i of a stacked one) ↔ torch
    nn.MultiheadAttention's names (inverse of `torch_convert._mha_qkv`)."""
    names = ("q_proj", "k_proj", "v_proj")
    if w.reverse:
        packed = f"{key}.in_proj_weight" in w.sd
    else:
        packed = len({w._get(a[n], "kernel", i).shape for n in names}) == 1
    if packed:
        w.concat(f"{key}.in_proj_weight", [(a[n], "kernel") for n in names], _T, i)
    else:
        for n in names:
            w.put(f"{key}.{n}_weight", a[n], "kernel", _T, i)
    w.concat(f"{key}.in_proj_bias", [(a[n], "bias") for n in names], i=i)
    w.dense(f"{key}.out_proj", a["out_proj"], i)


def _any_visual(w: _Map, prefix: str, p: Mapping):
    """Any image tower's JAX tree, told apart by its keys as `convert_clip`
    tells the state dicts apart (reversed, by a key only that tower's state
    dict has)."""
    if w.has(p, "conv1", f"{prefix}.class_embedding"):
        _visual(w, prefix, p)
        if w.has(p, "attn_pool", f"{prefix}.attn_pool.query"):
            _attn_pool(w, f"{prefix}.attn_pool", p["attn_pool"])
    elif w.has(p, "attnpool", f"{prefix}.attnpool.positional_embedding"):
        _resnet(w, prefix, p)
    elif w.has(p, "trunk", f"{prefix}.trunk.stem.0.weight"):
        _convnext(w, prefix, p)
    elif w.has(p, "stage0_block0", f"{prefix}.trunk.layers.0.blocks.0.norm1.weight"):
        _swin(w, prefix, p)
    elif w.has(p, "head", f"{prefix}.trunk.head.weight"):
        _eva(w, prefix, p)
    else:
        _timm_vit(w, prefix, p)


def coca_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX CoCa params → reference CoCa state dict (inverse of
    `convert_coca` :509)."""
    w = _Map()
    _any_visual(w, "visual", params["visual"])
    _text(w, "text.", params["text"])
    dec = params["text_decoder"]
    layers = dec["layers"]
    _resblocks(w, "text_decoder.resblocks", layers)
    for i in range(np.asarray(layers["ln_1"]["scale"]).shape[0]):
        key = f"text_decoder.cross_attn.{i}"
        w.norm(f"{key}.ln_1", layers["cross_ln_1"], i)
        w.norm(f"{key}.ln_1_kv", layers["cross_ln_1_kv"], i)
        w.norm(f"{key}.ln_2", layers["cross_ln_2"], i)
        w.dense(f"{key}.mlp.c_fc", layers["cross_mlp"]["c_fc"], i)
        w.dense(f"{key}.mlp.c_proj", layers["cross_mlp"]["c_proj"], i)
        _cross_mha(w, f"{key}.attn", layers["cross_attn"], i)
    w.norm("text_decoder.ln_final", dec["ln_final"])
    w.put("text_decoder.text_projection", dec, "text_projection")
    w.put("logit_scale", params, "logit_scale")
    return w.sd


def hf_text_state_dict_from_flax(hf_params: Mapping, proj_params: Mapping = None,
                                 encoder_only: bool = False) -> Dict[str, torch.Tensor]:
    """daclip_tpu's HFTextTower parameters (transformers' Flax tree under
    `hf`, the projection's under `proj`) → the port's HFTextTower state
    dict: transformers' own Flax ↔ PyTorch names (`kernel` → `weight`
    transposed, `embedding` / `scale` → `weight`) under `transformer.`, and
    `proj` / `proj.0` / `proj.2`. With `encoder_only` (an encoder-decoder
    model) only the encoder is kept, its token embedding the shared one."""
    w = _Map()

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + [str(k)])
                continue
            if encoder_only:
                if path[0] == "decoder":
                    continue
                if path[0] == "shared":
                    path = ["embed_tokens"]
                elif path[0] == "encoder":
                    path = path[1:]
            a = np.asarray(v)
            leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(k, k)
            w.put_array(".".join(["transformer"] + path + [leaf]), a.T if k == "kernel" else a)

    walk(hf_params, [])
    proj = (proj_params or {}).get("params", {})
    if "proj" in proj:
        w.dense("proj", proj["proj"])
    elif "fc1" in proj:
        w.dense("proj.0", proj["fc1"])
        w.dense("proj.2", proj["fc2"])
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
