"""Contrastive losses of CLIP / DA-CLIP training, in PyTorch.

Counterpart of `daclip_tpu/losses/clip_loss.py:22-182` (reference open_clip/
loss.py:66-132 ClipLoss, universal-image-restoration/open_clip/loss.py:
179-196 DaClipLoss, the fork's da-clip/src/open_clip/loss.py:180-433 with
FCRC and DistillClipLoss). Logits are float32: features of any dtype are
cast up before the product (bf16 products are exact in f32), as the JAX
package's `preferred_element_type=f32`.

Over several ranks the losses are global, as daclip_tpu's are under GSPMD
(the reference's gather_features, open_clip/loss.py:19-63):
`gather_features` all-gathers a forward's per-sample outputs with a
gradient (`torch.distributed.nn.all_gather`'s semantics, whose gloo
backward cannot take a subgroup), and every rank computes the whole-batch
loss on them. The gather's backward sums each rank's gradient of its rows
over the ranks (a reduce-scatter), and DDP averages, so the averaged
gradient is the global loss's exactly; FCRC's cross-sample λ, the masked means'
denominators and the distillation term see the global batch. The
reference's `--local-loss` and `--gather-with-grad` choose other forms of
the same loss (without the gradient, its features get 1/W of theirs); here
both give these numbers.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

TYPE_RANGES = ((0.5, 4.0), (5.0, 40.0), (0.5, 4.0), (10.0, 80.0))  # loss.py:209-214
NUM_TYPES, NUM_BINS = 4, 7
# the per-sample outputs of a forward that the losses read
PER_SAMPLE_KEYS = ("image_features", "text_features", "image_degra_features",
                   "text_degra_features", "gt_image_features", "pred", "deg_type", "gt_val")


class _AllGather(torch.autograd.Function):
    """Rows of every rank, in rank order; the backward sums each rank's
    gradient of this rank's rows over the group."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        n = dist.get_world_size(ctx.group)
        mine = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]), dtype=g.dtype,
                           device=g.device)
        dist.reduce_scatter_tensor(mine, g.contiguous(), group=ctx.group)
        return mine, None


def gather_features(out: Dict, group=None) -> Dict:
    """`out` with its per-sample entries all-gathered over `group` (the
    default group when None) in rank order, the gradient flowing back to
    each rank's rows; other entries (logit_scale, the level banks' features)
    are the same on every rank and stay."""
    out = dict(out)
    for k in PER_SAMPLE_KEYS:
        if out.get(k) is not None:
            out[k] = _AllGather.apply(out[k], group)
    return out


def _logits(a, b, scale):
    return scale * (a.float() @ b.float().T)


def _symmetric_xent(logits):
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def clip_loss(image_features, text_features, logit_scale):
    """Symmetric InfoNCE over the batch (loss.py:102-132)."""
    return _symmetric_xent(_logits(image_features, text_features, logit_scale))


def daclip_loss_uir(out: Dict, output_dict: bool = True):
    """The original DA-CLIP loss: caption contrastive + degradation
    contrastive (universal-image-restoration/open_clip/loss.py:181-196)."""
    c = clip_loss(out["image_features"], out["text_features"], out["logit_scale"])
    d = clip_loss(out["image_degra_features"], out["text_degra_features"], out["logit_scale"])
    if output_dict:
        return {"contrastive_loss": c, "degra_loss": d}
    return c, d


def fcrc_loss(image_degra_features, all_d_type_tokens_features, gt_val,
              bin_center_features, deg_type, temperature: float = 0.07):
    """Fine-grained contrastive regression loss over every (sample, type)
    pair with a validity mask (the reference gathers the present pairs with
    `nonzero`, loss.py:218-270): absent pairs get zero λ weight and are left
    out of the mean; with no pair present the loss is 0.

    `all_d_type_tokens_features` is (28, D) or (B, 28, D); `bin_center_features`
    (4, 7) or (B, 4, 7); `gt_val` and `deg_type` (B, 4)."""
    B = image_degra_features.shape[0]
    N = B * NUM_TYPES
    dev = image_degra_features.device
    f32 = torch.float32

    m = deg_type.reshape(N).to(f32)
    f = image_degra_features.to(f32)
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-8)
    tok = all_d_type_tokens_features.to(f32)
    tok = tok / (torch.linalg.vector_norm(tok, dim=-1, keepdim=True) + 1e-8)
    if tok.ndim == 2:
        sim = torch.einsum("bd,kd->bk", f, tok)
    else:
        sim = torch.einsum("bd,bkd->bk", f, tok)
    sim_exp = torch.softmax(sim / temperature, dim=-1)                     # (B, 28)

    centers = torch.as_tensor(bin_center_features, dtype=f32, device=dev)
    centers = centers.expand(B, NUM_TYPES, NUM_BINS)
    gt = torch.as_tensor(gt_val, dtype=f32, device=dev)                     # (B, 4)
    bin_idx = (gt[..., None] - centers).abs().argmin(dim=-1)               # first minimum
    type_idx = torch.arange(NUM_TYPES, device=dev).expand(B, NUM_TYPES)
    pos = sim_exp.gather(1, type_idx * NUM_BINS + bin_idx).reshape(N)

    lows = torch.tensor([r[0] for r in TYPE_RANGES], dtype=f32, device=dev)
    highs = torch.tensor([r[1] for r in TYPE_RANGES], dtype=f32, device=dev)
    gt_norm = ((gt - lows) / (highs - lows + 1e-8)).reshape(N)

    tvec = type_idx.reshape(N)
    diff = (gt_norm[:, None] - gt_norm[None, :]).abs()
    same = (tvec[:, None] == tvec[None, :]).to(f32)
    lam = same * diff + (1.0 - same) * 4.0
    lam = lam * (m[:, None] * m[None, :])
    lam = lam / (lam.sum(dim=1, keepdim=True) + 1e-8)

    neg = (lam @ sim_exp.repeat_interleave(NUM_TYPES, dim=0)).sum(dim=1) - lam.diagonal() * pos
    loss_i = -torch.log(pos / (pos + neg + 1e-6))
    count = m.sum()
    return torch.where(count > 0, (loss_i * m).sum() / count.clamp(min=1.0),
                       torch.zeros((), dtype=f32, device=dev))


def distill_clip_loss(image_features, text_features, logit_scale, dist_image_features,
                      dist_text_features, dist_logit_scale, output_dict: bool = True):
    """DistillClipLoss (open_clip/loss.py:397-433): contrastive + the
    teacher's soft labels' cross-entropy, both directions."""
    def dist(teacher, student):
        return -(teacher.softmax(dim=1) * student.log_softmax(dim=1)).sum(dim=1).mean()

    lpi = _logits(image_features, text_features, logit_scale)
    dpi = _logits(dist_image_features, dist_text_features, dist_logit_scale)
    contrastive = _symmetric_xent(lpi)
    distill = 0.5 * (dist(dpi, lpi) + dist(dpi.T, lpi.T))
    if output_dict:
        return {"contrastive_loss": contrastive, "distill_loss": distill}
    return contrastive, distill


def coca_loss(image_features, text_features, logits, labels, logit_scale,
              caption_loss_weight: float = 2.0, clip_loss_weight: float = 1.0,
              pad_id: int = 0, output_dict: bool = True):
    """CoCaLoss (open_clip/loss.py:135-178; JAX `clip_loss.py:132`): the
    weighted contrastive loss plus the caption cross-entropy, its mean over
    the tokens that are not `pad_id`."""
    c = 0.0
    if clip_loss_weight:
        c = clip_loss_weight * clip_loss(image_features, text_features, logit_scale)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    mask = (labels != pad_id).float()
    caption = caption_loss_weight * (nll * mask).sum() / mask.sum().clamp_min(1)
    if output_dict:
        return {"contrastive_loss": c, "caption_loss": caption}
    return c, caption


def daclip_loss_fork(out: Dict, l1_loss_weight: float = 0.1, temperature: float = 0.07,
                     output_dict: bool = True):
    """The fork's DaClipLoss: clip + 0.1·L1(image, GT image features) + the
    masked regression MSE of the predicted levels + FCRC
    (da-clip/src/open_clip/loss.py:343-395). A term whose inputs are absent
    is 0."""
    c = clip_loss(out["image_features"], out["text_features"], out["logit_scale"])
    zero = torch.zeros((), dtype=torch.float32, device=c.device)

    gt_l1 = zero
    if out.get("gt_image_features") is not None:
        gt_l1 = l1_loss_weight * (out["image_features"].float()
                                  - out["gt_image_features"].float()).abs().mean()

    reg_ls = zero
    if out.get("gt_val") is not None:
        m = out["deg_type"].float()
        pred = out["pred"].float()
        gt = out["gt_val"].float()
        loss_exist = (pred * m - gt * m).square().sum() / (m.sum() + 1e-8)
        mn = 1.0 - m
        loss_non = (pred * mn).square().sum() / (mn.sum() + 1e-8)
        reg_ls = loss_exist + loss_non

    fcrc = zero
    if out.get("all_d_type_tokens_features") is not None:  # the predictor is on
        fcrc = fcrc_loss(out["image_degra_features"], out["all_d_type_tokens_features"],
                         out["gt_val"], out["bin_center_features"], out["deg_type"],
                         temperature)
    if output_dict:
        return {"contrastive_loss": c, "gt_l1_loss": gt_l1, "reg_ls_loss": reg_ls,
                "fcrc_loss": fcrc}
    return c, gt_l1, reg_ls, fcrc
