"""CoCa, the contrastive captioner, with its caption decoders.

Counterpart of `daclip_tpu/models/coca.py:43-397` and the multimodal
decoder of `daclip_tpu/models/transformer.py:147-216` (reference open_clip/
coca_model.py:82-458, transformer.py:686-778). Parameter names are
open_clip's: `visual.*` (the ViT with its `attn_pool`), `text.*` (the
text tower with `cls_emb`), `text_decoder.resblocks.{i}` and
`text_decoder.cross_attn.{i}` (`ln_1_kv`), `text_decoder.ln_final`,
`text_decoder.text_projection`, `logit_scale`.

`generate` samples (top-k, top-p or greedy) and `generate_beam` runs group
beam search, both at a fixed length as daclip_tpu's do: each step reruns the
causal stacks on the tokens so far (daclip_tpu's on the whole fixed-width
buffer, whose trailing pads the causal mask hides), the image tokens' keys
and values projected once, and the output is (B, seq_len): SOT, the
tokens, EOS, then PAD. The beam search
keeps the quirks of the transformers 4.26-4.30 scorer the reference reads
(one hypothesis pool of num_beams per batch element shared by the groups,
beam scores summing raw logits, a finished hypothesis scored by its prefix
length, pads appended to a finished batch element), as daclip_tpu's does.
Every random draw of `generate` is `CoCa.sampling_noise`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from daclip_torch.models.clip import CLIPCfg, TextCfg, VisionCfg, _normalize
from daclip_torch.models.layers import LayerNorm, run_block
from daclip_torch.models.transformer import (ResidualAttentionBlock, TextTransformer,
                                             VisionTransformer, causal_mask)


@dataclasses.dataclass(frozen=True)
class MultimodalCfg:
    """coca_model.py:44-50 (MultimodalCfg extends CLIPTextCfg)."""
    context_length: int = 76
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    dim_head: int = 64
    n_queries: int = 256
    attn_pooler_heads: int = 8


@dataclasses.dataclass(frozen=True)
class CoCaCfg:
    embed_dim: int = 512
    vision: VisionCfg = dataclasses.field(default_factory=VisionCfg)
    text: TextCfg = dataclasses.field(default_factory=TextCfg)
    multimodal: MultimodalCfg = dataclasses.field(default_factory=MultimodalCfg)
    quick_gelu: bool = False
    pad_id: int = 0

    @staticmethod
    def from_dict(d) -> "CoCaCfg":
        base = CLIPCfg.from_dict(d)
        m = {k: v for k, v in d.get("multimodal_cfg", {}).items()
             if k in {f.name for f in dataclasses.fields(MultimodalCfg)}}
        return CoCaCfg(embed_dim=base.embed_dim, vision=base.vision, text=base.text,
                       multimodal=MultimodalCfg(**m), quick_gelu=base.quick_gelu,
                       pad_id=base.text.pad_id)


class MultimodalTransformer(nn.Module):
    """The CoCa text decoder (open_clip/transformer.py:686-778): per layer a
    causal self-attention block over the caption tokens, then a
    cross-attention block over the image tokens; ln_final, then the
    projection to `output_dim` (the vocabulary for CoCa)."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float = 4.0,
                 output_dim: int = 512, quick_gelu: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, mlp_ratio, quick_gelu) for _ in range(layers)])
        self.cross_attn = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, mlp_ratio, quick_gelu, cross=True)
             for _ in range(layers)])
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(width ** -0.5 * torch.randn(width, output_dim))

    def image_kv(self, image_embs):
        """Each cross-attention block's keys and values of the image tokens,
        which `hidden` takes in place of the tokens."""
        return [cross.attn.project_kv(cross.ln_1_kv(image_embs)) for cross in self.cross_attn]

    def hidden(self, image_embs, text_embs):
        """The layers' output, before ln_final and the projection;
        `image_embs` the image tokens or their `image_kv`."""
        x = text_embs
        mask = causal_mask(x.shape[1], x.device)
        if torch.is_tensor(image_embs):
            image_embs = [image_embs.to(x.dtype)] * len(self.cross_attn)
        for block, cross, kv in zip(self.resblocks, self.cross_attn, image_embs):
            x = run_block(block, self.remat, x, mask)
            x = run_block(cross, self.remat, x, None, kv)
        return x

    def head(self, x):
        """ln_final and the projection, token by token."""
        return self.ln_final(x) @ self.text_projection.to(x.dtype)

    def forward(self, image_embs, text_embs):
        return self.head(self.hidden(image_embs, text_embs))


class CoCa(nn.Module):
    """coca_model.py:82-177: the contrastive towers and the caption decoder;
    activations in `dtype`, parameters in float32."""

    def __init__(self, cfg: CoCaCfg, dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        v, t, m = cfg.vision, cfg.text, cfg.multimodal
        self.visual = VisionTransformer(
            image_size=v.image_size, patch_size=v.patch_size, width=v.width,
            layers=v.layers, heads=v.heads, mlp_ratio=v.mlp_ratio,
            output_dim=cfg.embed_dim, quick_gelu=cfg.quick_gelu,
            global_average_pool=v.global_average_pool, remat=remat,
            attentional_pool=v.attentional_pool, n_queries=v.n_queries,
            attn_pooler_heads=v.attn_pooler_heads, output_tokens=True)
        self.text = TextTransformer(
            t.context_length, t.vocab_size, t.width, t.heads, t.layers, t.mlp_ratio,
            cfg.embed_dim, cfg.quick_gelu, embed_cls=True, pad_id=cfg.pad_id,
            output_tokens=True, remat=remat)
        # the decoder projects to the vocabulary (coca_model.py:115-120)
        self.text_decoder = MultimodalTransformer(
            m.width, m.layers, m.heads, m.mlp_ratio, t.vocab_size, cfg.quick_gelu, remat)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def _encode_image(self, images, normalize: bool = True):
        latent, tokens = self.visual(images, dtype=self.dtype)
        return _normalize(latent, normalize), tokens

    def _encode_text(self, text, normalize: bool = True, embed_cls: bool = True):
        text = text[:, :-1] if embed_cls else text  # room for the CLS
        latent, token_emb = self.text(text, embed_cls=embed_cls, dtype=self.dtype)
        return _normalize(latent, normalize), token_emb

    def encode_image(self, images, normalize: bool = True):
        return self._encode_image(images, normalize)[0]

    def encode_text(self, text, normalize: bool = True, embed_cls: bool = True):
        return self._encode_text(text, normalize, embed_cls)[0]

    def forward(self, image=None, text=None, embed_cls: bool = True, image_latent=None,
                image_embs=None, train: bool = False, generator=None):
        """The training outputs: the normalised latents, the caption logits
        and their labels (the text tokens the decoder predicts). CoCa has no
        patch dropout, and a `train` forward is refused as daclip_tpu's
        module refuses the argument."""
        if train:
            raise TypeError("CoCa takes no train-time forward (no patch dropout)")
        text_latent, token_embs = self._encode_text(text, embed_cls=embed_cls)
        if image_latent is None or image_embs is None:
            image_latent, image_embs = self._encode_image(image)
        labels = text[:, -token_embs.shape[1]:]
        return {"image_features": image_latent, "text_features": text_latent,
                "logits": self.text_decoder(image_embs, token_embs), "labels": labels,
                "logit_scale": self.logit_scale.exp()}

    def sampling_noise(self, shape, step: int, generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
        """Standard Gumbel noise of `shape` for step `step` of `generate`:
        the token drawn is argmax(logits / temperature + noise), a draw from
        softmax(logits / temperature) (jax.random.categorical's form)."""
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _decoder_logits(model: CoCa, image_kv, tokens, pos: int):
    """The decoder's f32 logits at position `pos` of an (R, L) token buffer.
    The causal stacks run on its first pos + 1 tokens, which are all that
    position sees (daclip_tpu's step runs them on the whole buffer, the
    same numbers up to rounding), and only that position is projected to
    the vocabulary."""
    _, token_embs = model._encode_text(tokens[:, :pos + 1], embed_cls=False)
    x = model.text_decoder.hidden(image_kv, token_embs)
    return model.text_decoder.head(x[:, pos]).float()


@torch.no_grad()
def generate(model: CoCa, image, generator: Optional[torch.Generator] = None,
             seq_len: int = 30, temperature: float = 1.0, generation_type: str = "top_k",
             top_p: float = 0.1, top_k: int = 1, min_seq_len: int = 5,
             repetition_penalty: float = 1.0, sot_token_id: int = 49406,
             eos_token_id: int = 49407, pad_token_id: Optional[int] = None):
    """Fixed-length caption sampling (coca_model.py:179-296; JAX
    `coca.py:149-240`): (B, seq_len) int64 tokens."""
    if generation_type not in ("top_k", "top_p", "greedy"):
        raise ValueError(f"generation_type {generation_type!r} not in "
                         "{'top_k', 'top_p', 'greedy'}")
    assert seq_len > min_seq_len, "seq_len must be larger than min_seq_len"
    pad_id = model.cfg.pad_id if pad_token_id is None else pad_token_id
    vocab = model.cfg.text.vocab_size
    B, dev = image.shape[0], image.device
    image_kv = model.text_decoder.image_kv(model._encode_image(image)[1])
    tokens = torch.full((B, seq_len), pad_id, dtype=torch.long, device=dev)
    tokens[:, 0] = sot_token_id
    seen = torch.zeros(B, vocab, dtype=torch.bool, device=dev)
    seen[:, sot_token_id] = True
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    for i in range(1, seq_len):
        logits = _decoder_logits(model, image_kv, tokens, i - 1)
        if i < min_seq_len:  # MinLengthLogitsProcessor
            logits[:, eos_token_id] = float("-inf")
        if repetition_penalty != 1.0:  # RepetitionPenaltyLogitsProcessor
            pen = torch.where(logits > 0, logits / repetition_penalty,
                              logits * repetition_penalty)
            logits = torch.where(seen, pen, logits)
        if generation_type == "greedy":
            sample = logits.argmax(dim=-1)
        else:
            if generation_type == "top_k":
                kth = logits.sort(dim=-1).values[:, -top_k][:, None]
            else:  # nucleus: the smallest top set whose probability reaches top_p
                srt = logits.sort(dim=-1, descending=True).values
                probs = torch.softmax(srt, dim=-1)
                keep = (probs.cumsum(dim=-1) - probs) < top_p
                kth = srt.gather(1, (keep.sum(dim=-1) - 1)[:, None])
            logits = torch.where(logits < kth, float("-inf"), logits)
            noise = model.sampling_noise((B, vocab), i, generator, dev)
            sample = (logits / temperature + noise).argmax(dim=-1)
        if i == seq_len - 1:
            sample = torch.full_like(sample, eos_token_id)
        prev = tokens[:, i - 1]
        done = done | (prev == eos_token_id) | ((prev == pad_id) & (i > 1))
        sample = torch.where(done, torch.full_like(sample, pad_id), sample)
        tokens[:, i] = sample
        seen[rows, sample] = True
    return tokens


def _pool_add(ps, pt, pl, score, hyp, length: int, take: bool):
    """BeamHypotheses.add on one batch element's pool: replace the worst
    slot when `score` beats it (empty slots are -inf, so it fills first)."""
    worst = int(ps.argmin())
    if take and bool(score > ps[worst]):
        ps[worst], pt[worst], pl[worst] = score, hyp, length


@torch.no_grad()
def generate_beam(model: CoCa, image, seq_len: int = 30, num_beams: int = 6,
                  num_beam_groups: int = 3, min_seq_len: int = 5, sot_token_id: int = 49406,
                  eos_token_id: int = 49407, pad_token_id: Optional[int] = None,
                  logits_fn: Optional[Callable] = None):
    """Group beam search at a fixed length (coca_model.py:296-458; JAX
    `coca.py:241-397`), deterministic: (B, seq_len) int64, the best
    hypothesis, its EOS (when it finished or fits), then PAD. `logits_fn`
    ((B, num_beams, L) tokens → (B, num_beams, L, V) f32) replaces the
    decoder, so tests can drive this and daclip_tpu's with one table."""
    if num_beams % num_beam_groups:
        raise ValueError("num_beams must be divisible by num_beam_groups")
    assert seq_len > min_seq_len, "seq_len must be larger than min_seq_len"
    pad_id = model.cfg.pad_id if pad_token_id is None else pad_token_id
    B, N, G, L = image.shape[0], num_beams, num_beam_groups, seq_len
    gs = N // G
    dev = image.device
    if logits_fn is None:
        image_kv = model.text_decoder.image_kv(model._encode_image(image)[1].repeat_interleave(
            N, 0))

        def step_logits(tokens, i):
            return _decoder_logits(model, image_kv, tokens.reshape(B * N, L), i - 1).reshape(
                B, N, -1)
    else:
        def step_logits(tokens, i):
            return logits_fn(tokens)[:, :, i - 1].float()

    tokens = torch.full((B, N, L), pad_id, dtype=torch.long, device=dev)
    tokens[:, :, 0] = sot_token_id
    beam_scores = torch.where(torch.arange(N, device=dev) % gs == 0, 0.0, -1e9)
    beam_scores = beam_scores[None].repeat(B, 1).float()
    ps = torch.full((B, N), float("-inf"), device=dev)
    pt = torch.zeros((B, N, L), dtype=torch.long, device=dev)
    pl = torch.zeros((B, N), dtype=torch.long, device=dev)
    done = [False] * B
    for i in range(1, L):
        logits_i = step_logits(tokens, i)
        V = logits_i.shape[-1]
        if i < min_seq_len:
            logits_i[..., eos_token_id] = float("-inf")
        for g in range(G):  # the groups run in turn: they share the pool and `done`
            lo = g * gs
            for b in range(B):
                sc = logits_i[b, lo:lo + gs] + beam_scores[b, lo:lo + gs, None]
                top_sc, top_ix = sc.reshape(-1).sort(descending=True, stable=True)
                top_sc, top_ix = top_sc[:2 * gs], top_ix[:2 * gs]
                top_tok, top_src = top_ix % V, top_ix // V
                new_sc = torch.zeros(gs, device=dev)
                new_tok = torch.full((gs,), pad_id, dtype=torch.long, device=dev)
                new_src = torch.zeros(gs, dtype=torch.long, device=dev)
                count = 0
                for r in range(2 * gs):
                    is_eos = int(top_tok[r]) == eos_token_id
                    # an EOS among the first gs ends a hypothesis: the prefix
                    # without it, scored by the prefix length
                    _pool_add(ps[b], pt[b], pl[b], top_sc[r] / i, tokens[b, lo + top_src[r]],
                              i, not done[b] and is_eos and r < gs)
                    if not done[b] and not is_eos and count < gs:
                        new_sc[count], new_tok[count], new_src[count] = (
                            top_sc[r], top_tok[r], top_src[r])
                        count += 1
                full = bool((ps[b] > float("-inf")).all())
                done[b] = done[b] or (full and bool(ps[b].min() >= top_sc[0] / (i + 1)))
                rows = tokens[b, lo + new_src].clone()
                rows[:, i] = new_tok
                beam_scores[b, lo:lo + gs] = new_sc
                tokens[b, lo:lo + gs] = rows
    out = torch.full((B, L), pad_id, dtype=torch.long, device=dev)
    pos = torch.arange(L, device=dev)
    for b in range(B):  # open beams of an unfinished element join the pool, scored / L
        for k in range(N):
            _pool_add(ps[b], pt[b], pl[b], beam_scores[b, k] / L, tokens[b, k], L, not done[b])
        best = int(ps[b].argmax())
        hyp, ln = pt[b, best], int(pl[b, best])
        row = torch.where(pos < ln, hyp, torch.full_like(hyp, pad_id))
        if ln < L:
            row[ln] = eos_token_id
        out[b] = row
    return out
