"""End-to-end DA-CLIP universal image restoration, in PyTorch — the
`predict.py` API (reference predict.py:33-91).

Counterpart of `daclip_tpu/pipeline.py`. Per image:
  1. host: [0,1] float RGB → CLIP view (`transforms.clip_transform`),
  2. device: DaCLIP `encode_image(control=True, normalize=True)` →
     (image_context, degra_context),
  3. device: x_T = LQ + σ_max·ε, then the IR-SDE sampler (100 posterior
     steps by default), one ConditionalUNet forward per step,
  4. host: tensor2img rounding (`utils.metrics.array2img`).
`classify_degradation` is DA-CLIP's zero-shot degradation classification:
the degradation feature against the text features of the class names.

Images are reflect-padded up to a 64-multiple bucket and cropped back; inputs
larger than `tile_size` are restored in overlapping tiles with a feathered
blend. `shard_tiles(devices)` splits each tile batch's UNet calls over
several devices (one card may be listed more than once), the counterpart of
daclip_tpu's `shard_tiles(mesh)`. The device defaults to CUDA and never falls
back to the CPU silently: pass `device="cpu"` to run there.

Noise comes from `torch.Generator`s seeded from `seed`, so a restore differs
from the JAX package's `restore(seed)` by design; parity is checked through
explicit noise banks (`IRSDE.reverse_posterior(noises=...)`).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from daclip_torch import flags
from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
from daclip_torch.models.unet import ConditionalUNet
from daclip_torch.sde.irsde import IRSDE
from daclip_torch.tokenizer import tokenize
from daclip_torch.transforms import clip_transform
from daclip_torch.utils.metrics import array2img
from daclip_torch.utils.native_checkpoint import load_daclip_any, load_unet_any

# 10 distortion types of the universal-ir model (options/train.yml:5)
DEGRADATION_CLASSES = ["motion-blurry", "hazy", "jpeg-compressed", "low-light",
                       "noisy", "raindrop", "rainy", "shadowed", "snowy",
                       "uncompleted"]


def default_buckets(max_size: int = 1024, step: int = 64):
    return [step * i for i in range(1, max_size // step + 1)]


def _bucketize(x: int, buckets) -> int:
    for b in buckets:
        if b >= x:
            return b
    return int(math.ceil(x / buckets[0]) * buckets[0])


def _adaptive_tile_axis(D: int, ts_max: int, ov: int, step: int, sizes=None):
    """Minimum-count, then minimum-size, tile grid covering one axis: evenly
    spaced positions and one tile size t ≤ ts_max (a multiple of `step`) with
    ≥ ov overlap. `sizes`: optional ascending tile-size set t snaps up to."""
    if ts_max >= step:
        ts_max -= ts_max % step

    def snap(t):
        if sizes:
            for s in sorted(sizes):
                if t <= s <= ts_max:
                    return int(s)
        return t

    if D <= ts_max:
        return [0], snap(int(math.ceil(D / step) * step))
    n = int(math.ceil((D - ov) / (ts_max - ov)))
    t = int(math.ceil(max((D + (n - 1) * ov) / n, 2 * ov) / step) * step)
    t = snap(min(t, ts_max))
    return [int(round(i * (D - t) / (n - 1))) for i in range(n)], t


@dataclasses.dataclass
class RestorerConfig:
    model_name: str = "daclip_ViT-B-32"
    # UNet (options/test.yml network_G.setting)
    nf: int = 64
    ch_mult: Tuple[int, ...] = (1, 2, 4, 8)
    context_dim: int = 512
    use_degra_context: bool = True
    use_image_context: bool = True
    scale: float = 1.0                    # wild-ir: 0.5
    spatial_attn_min_level: int = 3
    # the UNet's kernel wiring, defaults from the DACLIP_TPU_* variables
    # (daclip_torch/flags.py): v5 | v4 | v3, and the dual 1×1 res_conv kernel
    linear_attention: str = flags.LINEAR_ATTENTION
    pointwise: bool = flags.POINTWISE
    pointwise_max_out: Optional[int] = flags.POINTWISE_MAXO
    # SDE (options/test.yml sde)
    max_sigma: float = 50
    T: int = 100
    sample_T: int = -1
    schedule: str = "cosine"
    eps: float = 0.005
    sampling_mode: str = "posterior"      # posterior | sde | ode
    # runtime
    dtype: str = "bfloat16"
    buckets_step: int = 64
    tile_size: int = 512                  # tiled sampling threshold/size
    tile_overlap: int = 64
    tile_batch: int = 8                   # tiles sampled per sampler run
    # adaptive tile sizes snap up to this set; None → step-floored
    # {tile_size/2, 3·tile_size/4, tile_size}
    tile_size_buckets: Optional[Tuple[int, ...]] = None


def _pinned(device: torch.device) -> torch.device:
    """`device` with the current card's index where a CUDA device has none."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; without a GPU that raises instead of falling back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("daclip_torch runs on a CUDA device by default and "
                               "none is available; pass device='cpu' to run on "
                               "the CPU")
        return torch.device("cuda")
    return torch.device(device)


_NO_DACLIP = ("this restorer was loaded without a DA-CLIP checkpoint; classification "
              "needs one")
_NO_IMAGE_CONTEXT = ("the UNet has image-context modules (SpatialTransformers that attend "
                     "to DA-CLIP's image features), and no DA-CLIP weights were given: pass "
                     "the DA-CLIP checkpoint, or a UNet without image context")


class DACLIPRestorer:
    """UNet + DaCLIP + IR-SDE on one device; `restore()` is the predict()
    entry point. `unet_sd`/`daclip_sd` are reference-named state dicts
    (`daclip_sd=None` serves a UNet without image context; one with image
    context is refused, as its SpatialTransformers need DA-CLIP's image
    features)."""

    def __init__(self, cfg: RestorerConfig, unet_sd: Dict[str, torch.Tensor],
                 daclip_sd: Optional[Dict[str, torch.Tensor]] = None, device=None):
        if daclip_sd is None and cfg.use_image_context and (cfg.context_dim or 0) > 0:
            raise ValueError(_NO_IMAGE_CONTEXT)
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.unet = ConditionalUNet(
            nf=cfg.nf, ch_mult=tuple(cfg.ch_mult), context_dim=cfg.context_dim,
            use_degra_context=cfg.use_degra_context,
            use_image_context=cfg.use_image_context, scale=cfg.scale,
            spatial_attn_min_level=cfg.spatial_attn_min_level, dtype=dtype,
            linear_attention=cfg.linear_attention, pointwise=cfg.pointwise,
            pointwise_max_out=cfg.pointwise_max_out)
        self.unet.load_state_dict(unet_sd, strict=True)
        self.unet.to(self.device).eval()
        self.daclip = None
        if daclip_sd is not None:
            clip_cfg = CLIPCfg.from_dict(get_model_config(cfg.model_name))
            self.daclip = DaCLIP(clip_cfg, dtype=dtype)
            self.daclip.load_state_dict(daclip_sd, strict=True)
            self.daclip.to(self.device).eval()
        self.sde = IRSDE(max_sigma=cfg.max_sigma, T=cfg.T, sample_T=cfg.sample_T,
                         schedule=cfg.schedule, eps=cfg.eps)
        self.buckets = default_buckets(step=cfg.buckets_step)
        self._text_feature_cache: Dict[tuple, np.ndarray] = {}
        self._tile_devices: Optional[List[torch.device]] = None
        self._tile_unets: Dict[torch.device, ConditionalUNet] = {}

    @classmethod
    def from_torch(cls, unet_path: str, daclip_path: str,
                   cfg: Optional[RestorerConfig] = None, device=None) -> "DACLIPRestorer":
        """The reference checkpoints (universal-ir.pth + daclip_ViT-B-32.pt),
        loaded as predict.py:34-56 does; the UNet architecture is read off
        its checkpoint and overrides `cfg`."""
        return cls.load(unet_path, daclip_path, cfg, device=device)

    @classmethod
    def from_train_dir(cls, train_dir: str, daclip: Optional[str] = None,
                       cfg: Optional[RestorerConfig] = None, use_ema: bool = True,
                       step: Optional[int] = None, device=None) -> "DACLIPRestorer":
        """Serve a trained UNet: `train_dir` is daclip_tpu's orbax dir of
        `cli/train_restoration` or the port's own train dir (the EMA
        parameters unless `use_ema=False`, at `step`, default the latest);
        `daclip` any DA-CLIP checkpoint `load` takes, or None."""
        return cls.load(train_dir, daclip, cfg, use_ema=use_ema, step=step, device=device)

    @classmethod
    def load(cls, unet: str, daclip: Optional[str] = None,
             cfg: Optional[RestorerConfig] = None, use_ema: bool = True,
             step: Optional[int] = None, device=None) -> "DACLIPRestorer":
        """Build from reference torch checkpoints (universal-ir.pth +
        daclip_ViT-B-32.pt), as predict.py:34-56 does, from the JAX
        package's orbax train dirs (`unet` one of `cli/train_restoration`,
        `daclip` one of `cli/train_daclip`, or one of their step dirs) or flat
        .npz params (`utils/native_checkpoint.py`), each either, or with
        `unet` the port's train dir (its `<step>.pt` files). For a UNet train
        dir, `step` (default the latest) and the EMA parameters unless
        `use_ema=False`; a DA-CLIP train dir gives its latest save, as
        daclip_tpu's `load`; `daclip` may also be an `epoch_<n>.pt` of the
        port's DA-CLIP trainer or its train dir (the latest epoch). The UNet
        architecture is inferred from its checkpoint and overrides `cfg`; a
        torch DA-CLIP's position embeddings are resized to the config's
        grid. The fork's `predictor.*` is dropped. Without `daclip` both
        contexts are off (as daclip_tpu's `load`), and a UNet with image
        context is refused with a ValueError."""
        cfg = cfg or RestorerConfig()
        unet_sd, arch = load_unet_any(unet, step=step, use_ema=use_ema)
        cfg = dataclasses.replace(
            cfg, nf=arch["nf"], ch_mult=arch["ch_mult"],
            context_dim=arch["context_dim"],
            use_degra_context=arch["use_degra_context"],
            use_image_context=arch["use_image_context"], scale=arch["scale"],
            spatial_attn_min_level=arch["spatial_attn_min_level"])
        daclip_sd = None
        if daclip is not None:
            vision = CLIPCfg.from_dict(get_model_config(cfg.model_name)).vision
            # the fork's regression head is not used in restoration
            daclip_sd = {k: v for k, v in load_daclip_any(daclip, vision.image_size,
                                                          vision.patch_size).items()
                         if not k.startswith("predictor.")}
        elif arch["use_image_context"]:
            raise ValueError(f"{unet!r}: {_NO_IMAGE_CONTEXT}")
        else:
            # as daclip_tpu's load: without DA-CLIP both contexts are off, and
            # the degradation-context weights (which flax ignores) are dropped
            cfg = dataclasses.replace(cfg, use_degra_context=False, use_image_context=False)
            unet_sd = {k: v for k, v in unet_sd.items()
                       if k != "prompt" and not k.startswith(("text_mlp.", "prompt_mlp."))}
        return cls(cfg, unet_sd, daclip_sd, device=device)

    # -- device helpers ----------------------------------------------------------
    def _generator(self, *seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(hash(tuple(int(s) for s in seed)) & (2 ** 63 - 1))
        return g

    def _to_device(self, nhwc: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(nhwc, dtype=np.float32))
        return t.permute(0, 3, 1, 2).contiguous().to(self.device)

    @torch.no_grad()
    def _encode(self, views: np.ndarray):
        img_f, degra_f = self.daclip.encode_image(self._to_device(views), control=True,
                                                  normalize=True)
        return img_f.float(), degra_f.float()

    @torch.no_grad()
    def _sample(self, lq_nhwc: np.ndarray, generator: torch.Generator, tctx, ictx,
                noise_fn=None):
        """One sampler run over a batch of same-size images (NHWC in and out);
        `noise_fn` (default the UNet) predicts the noise at each step."""
        noise_fn = self.unet if noise_fn is None else noise_fn
        lq = self._to_device(lq_nhwc)
        x_T = self.sde.noise_state(lq, generator)
        mode = self.cfg.sampling_mode
        ctx = dict(text_context=tctx, image_context=ictx)
        if mode == "sde":
            out = self.sde.reverse_sde(noise_fn, x_T, lq, generator, **ctx)
        elif mode == "ode":
            out = self.sde.reverse_ode(noise_fn, x_T, lq, **ctx)
        else:
            out = self.sde.reverse_posterior(noise_fn, x_T, lq, generator, **ctx)
        return out.permute(0, 2, 3, 1).float().cpu().numpy()

    # -- tile batches over several devices -----------------------------------------
    def shard_tiles(self, devices) -> "DACLIPRestorer":
        """Split every tiled restore's tile batches over `devices` (torch
        devices, or names; one device may be listed more than once): each
        UNet call's batch is cut into `len(devices)` equal chunks, each run on
        its device's copy of the UNet, the outputs gathered in order on the
        restorer's device, where the sampler loop and its noise stay. Every
        tile batch then has the full `tile_batch`, the remainder padded with
        copies of the last tile, as daclip_tpu's `shard_tiles(mesh)` lays
        them out; so `tile_batch` must be a multiple of `len(devices)`, and
        every device of the restorer's type (CUDA or CPU). Returns self."""
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("shard_tiles needs at least one device")
        if max(1, self.cfg.tile_batch) % len(devices):
            raise ValueError(f"tile_batch {self.cfg.tile_batch} is not a multiple of the "
                             f"{len(devices)} devices it is split over")
        for d in devices:
            if d.type != self.device.type:
                raise ValueError(f"device {d} is not a {self.device.type} device, as the "
                                 f"restorer's {self.device} is: shard_tiles moves nothing "
                                 f"across device types")
        devices = [_pinned(d) for d in devices]
        home = _pinned(self.device)
        self._tile_unets = {d: self.unet if d == home else copy.deepcopy(self.unet).to(d)
                            for d in dict.fromkeys(devices)}
        self._tile_devices = devices
        return self

    def _sharded_unet(self, x, mu, t, text_context=None, image_context=None):
        """The UNet call of a sharded tile batch: `x`, `mu`, `t` and any
        context with their batch axis split into one chunk a device, each run
        on its device's copy (launches on different cards overlap), the
        outputs concatenated in order on the restorer's device. A (1, D)
        context goes whole to every chunk, as it broadcasts."""
        k = len(self._tile_devices)

        def chunks(a):
            if a is None or (a.shape[0] == 1 and x.shape[0] > 1):
                return [a] * k
            return a.chunk(k)

        outs = []
        for d, *parts in zip(self._tile_devices, x.chunk(k), mu.chunk(k), t.chunk(k),
                             chunks(text_context), chunks(image_context)):
            xi, mi, ti, tc, ic = (None if a is None else a.to(d, non_blocking=True)
                                  for a in parts)
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                outs.append(self._tile_unets[d](xi, mi, ti, text_context=tc,
                                                image_context=ic))
        return torch.cat([o.to(self.device) for o in outs])

    # -- public API --------------------------------------------------------------
    def contexts(self, image_rgb: np.ndarray):
        """CLIP contexts of one LQ image ([0,1] float RGB HWC): (img_ctx,
        degra_ctx), each (1, D) float32 or None where its context is off, as
        daclip_tpu's `contexts`."""
        degra_ctx, img_ctx = self._contexts_batch([image_rgb])
        return img_ctx, degra_ctx

    def _contexts_batch(self, images_rgb):
        """(degra_ctx, img_ctx) of a list of LQ images, in one batched encode:
        the (text_context, image_context) the UNet takes."""
        if self.daclip is None:
            return None, None
        res = self.daclip.cfg.vision.image_size
        img_ctx, degra_ctx = self._encode(np.stack([clip_transform(im, res)
                                                    for im in images_rgb]))
        return (degra_ctx if self.cfg.use_degra_context else None,
                img_ctx if self.cfg.use_image_context else None)

    @torch.no_grad()
    def text_features(self, class_names) -> np.ndarray:
        """Normalised float32 text features of `class_names`, encoded once
        per restorer and tuple of names."""
        if self.daclip is None:
            raise ValueError(_NO_DACLIP)
        key = tuple(class_names)
        if key not in self._text_feature_cache:
            toks = tokenize(list(class_names),
                            context_length=self.daclip.cfg.text.context_length)
            feats = self.daclip.encode_text(torch.from_numpy(toks).to(self.device),
                                            normalize=True)
            self._text_feature_cache[key] = feats.float().cpu().numpy()
        return self._text_feature_cache[key]

    @torch.no_grad()
    def classify_degradation(self, image_rgb: np.ndarray, class_names=None):
        """Zero-shot degradation classification of one [0,1] float RGB HWC
        image (evaluate_daclip.py:63-104): softmax(100 · cos) of its
        degradation feature against the class names' text features, in
        float32. Returns (best name, {name: probability} in descending
        order)."""
        if self.daclip is None:
            raise ValueError(_NO_DACLIP)
        class_names = class_names or DEGRADATION_CLASSES
        res = self.daclip.cfg.vision.image_size
        _, degra = self._encode(clip_transform(image_rgb, res)[None])
        text_f = torch.from_numpy(self.text_features(class_names)).to(self.device)
        d = degra[0]
        probs = torch.softmax(100.0 * (text_f @ (d / torch.linalg.vector_norm(d))), dim=0)
        probs = probs.cpu().numpy()
        order = np.argsort(-probs)
        return class_names[int(order[0])], {class_names[i]: float(probs[i]) for i in order}

    def restore(self, image_rgb: np.ndarray, seed: int = 0, return_uint8: bool = True):
        """Restore one [0,1] float RGB HWC image of any size."""
        H, W = image_rgb.shape[:2]
        tctx, ictx = self._contexts_batch([image_rgb])
        if max(H, W) > self.cfg.tile_size:
            out = self._restore_tiled(image_rgb, seed, tctx, ictx)
        else:
            bh, bw = _bucketize(H, self.buckets), _bucketize(W, self.buckets)
            lq = (np.pad(image_rgb, ((0, bh - H), (0, bw - W), (0, 0)), mode="reflect")
                  if (bh != H or bw != W) else image_rgb)
            out = self._sample(lq[None], self._generator(seed), tctx, ictx)[0, :H, :W]
        if return_uint8:
            return array2img(out)  # [0,255] uint8 BGR like the reference
        return np.clip(out, 0, 1)

    def restore_batch(self, images_rgb, seed: int = 0, return_uint8: bool = True):
        """Restore a list of images, one sampler run per bucket of same-size
        images (one batched CLIP encode each). Returns a list in input order."""
        groups = defaultdict(list)
        for idx, img in enumerate(images_rgb):
            H, W = img.shape[:2]
            if max(H, W) > self.cfg.tile_size:
                groups[("tiled", idx)].append(idx)
            else:
                groups[(_bucketize(H, self.buckets), _bucketize(W, self.buckets))].append(idx)
        outs: Dict[int, np.ndarray] = {}
        for gi, (bucket, idxs) in enumerate(groups.items()):
            if bucket[0] == "tiled":
                outs[idxs[0]] = self.restore(images_rgb[idxs[0]], seed=seed,
                                             return_uint8=False)
                continue
            bh, bw = bucket
            batch = []
            for i in idxs:
                img = images_rgb[i]
                H, W = img.shape[:2]
                batch.append(np.pad(img, ((0, bh - H), (0, bw - W), (0, 0)), mode="reflect")
                             if (bh != H or bw != W) else img)
            tctx, ictx = self._contexts_batch([images_rgb[i] for i in idxs])
            # seed with the group ordinal: bucket dims can collide (64·128, 128·64)
            out = self._sample(np.stack(batch), self._generator(seed, gi), tctx, ictx)
            for j, i in enumerate(idxs):
                H, W = images_rgb[i].shape[:2]
                outs[i] = out[j, :H, :W]
        if return_uint8:
            return [array2img(outs[i]) for i in range(len(images_rgb))]
        return [np.clip(outs[i], 0, 1) for i in range(len(images_rgb))]

    def _restore_tiled(self, image_rgb, seed: int, tctx, ictx):
        """Overlap-tiled sampling with a feathered blend for inputs larger than
        `tile_size`; tiles run in batches of up to `tile_batch`, the last batch
        in the largest power-of-two size that fits, or, after `shard_tiles`,
        every batch at the full `tile_batch` with the remainder padded by
        copies of the last tile (their outputs discarded). Each tile takes
        the whole image's contexts."""
        H, W = image_rgb.shape[:2]
        ts, ov = self.cfg.tile_size, self.cfg.tile_overlap
        acc = np.zeros((H, W, 3), np.float64)
        wacc = np.zeros((H, W, 1), np.float64)
        step = self.cfg.buckets_step
        sizes = self.cfg.tile_size_buckets
        if sizes is None:
            sizes = sorted({max(s - s % step, step) for s in (ts // 2, 3 * ts // 4, ts)})
        ys, tsh = _adaptive_tile_axis(H, ts, ov, step, sizes)
        xs, tsw = _adaptive_tile_axis(W, ts, ov, step, sizes)
        if ov > 0:
            rh = np.minimum(np.arange(1, tsh + 1), ov) / ov
            rw = np.minimum(np.arange(1, tsw + 1), ov) / ov
            win2d = np.minimum.outer(np.minimum(rh, rh[::-1]),
                                     np.minimum(rw, rw[::-1]))[..., None]
        else:  # hard tile edges, uniform weights
            win2d = np.ones((tsh, tsw, 1))
        coords, tiles = [], []
        for yi in ys:
            for xi in xs:
                tile = image_rgb[yi: yi + tsh, xi: xi + tsw]
                th, tw = tile.shape[:2]
                tiles.append(np.pad(tile, ((0, tsh - th), (0, tsw - tw), (0, 0)),
                                    mode="reflect") if (th < tsh or tw < tsw) else tile)
                coords.append((yi, xi, th, tw))
        sharded = {} if self._tile_devices is None else {"noise_fn": self._sharded_unet}
        s = 0
        while s < len(tiles):
            n_left = len(tiles) - s
            n = max(1, self.cfg.tile_batch)
            while not sharded and n > n_left:
                n //= 2
            batch = tiles[s: s + n]
            batch += [batch[-1]] * (n - len(batch))   # a sharded remainder's padding
            # the (1, D) contexts broadcast over the tile batch
            out = self._sample(np.stack(batch), self._generator(seed, 1, s), tctx, ictx,
                               **sharded)
            for j in range(min(n, n_left)):
                yi, xi, th, tw = coords[s + j]
                w = win2d[:th, :tw]
                acc[yi: yi + th, xi: xi + tw] += out[j, :th, :tw] * w
                wacc[yi: yi + th, xi: xi + tw] += w
            s += n
        return acc / np.maximum(wacc, 1e-8)
