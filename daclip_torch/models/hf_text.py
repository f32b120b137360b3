"""The HuggingFace text tower (open_clip/hf_model.py:46-193), on transformers'
PyTorch models.

Counterpart of `daclip_tpu/models/hf_text.py:115-296`, which wraps
transformers' Flax models; here `AutoModel` builds the PyTorch one from a
config (a `PretrainedConfig`, a dict with `model_type`, or a local config
directory; never a download). transformers is imported inside the calls:
the package imports without it.

  * poolers (hf_model.py:43-104): `mean_pooler` (masked mean),
    `max_pooler` (masked max over the real tokens: daclip_tpu's fix of the
    upstream mask), `cls_pooler` (the model's pooler_output when it has a
    pooling head, else the first token), `cls_last_hidden_state_pooler`
    (always the first token);
  * projections (hf_model.py:141-155): None (the identity, when d_model is
    output_dim), `linear`, `mlp` (Linear → GELU → Linear, hidden
    (d_model + output_dim) // 2, no biases);
  * `output_tokens` (hf_model.py:157-168: cls_pooler drops the first
    position from the tokens it returns);
  * `lock_mask` (HFTextEncoder.lock, hf_model.py:170-186) as a 0/1 mask by
    parameter name, the form `train/locking.py` uses.

Parameter names are open_clip's HFTextEncoder's: the HF model under
`transformer.` (an encoder-decoder's encoder alone, as open_clip keeps it)
and the projection under `proj` (`proj.0`, `proj.2` for the MLP).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

# hf_configs.py:5-45: per model_type, the config's attribute names this
# module reads and the default pooler; layer_attr / token_embeddings_attr
# name the modules lock_mask reads
_BERT_LIKE = {"width": "hidden_size", "layers": "num_hidden_layers", "layer_attr": "layer",
              "token_embeddings_attr": "embeddings"}
_T5_LIKE = {"width": "d_model", "layers": "num_layers", "layer_attr": "block",
            "token_embeddings_attr": "embed_tokens"}
ARCH_DICT = {
    "roberta": {"config_names": _BERT_LIKE, "pooler": "mean_pooler"},
    "xlm-roberta": {"config_names": _BERT_LIKE, "pooler": "mean_pooler"},
    "mt5": {"config_names": _T5_LIKE, "pooler": "mean_pooler"},
    "bert": {"config_names": _BERT_LIKE, "pooler": "cls_pooler"},
    "t5": {"config_names": _T5_LIKE, "pooler": "mean_pooler"},
}
POOLERS = ("mean_pooler", "max_pooler", "cls_pooler", "cls_last_hidden_state_pooler")
_LN_NAMES = {"LayerNorm", "layer_norm", "layernorm", "final_layer_norm",
             "layer_normalization"}


def _arch(config):
    model_type = getattr(config, "model_type", None)
    if model_type not in ARCH_DICT:
        raise ValueError(f"unsupported HF model_type {model_type!r}; known: {sorted(ARCH_DICT)}")
    return ARCH_DICT[model_type]


def pool(hidden, attention_mask, pooler_type: str = "mean_pooler", pooler_output=None):
    """Pool (B, N, D) hidden states (hf_model.py:43-104)."""
    mask = attention_mask[..., None].to(hidden.dtype)
    if pooler_type == "mean_pooler":
        return (hidden * mask).sum(1) / mask.sum(1).clamp_min(1e-6)
    if pooler_type == "cls_pooler":
        return pooler_output if pooler_output is not None else hidden[:, 0]
    if pooler_type == "cls_last_hidden_state_pooler":
        return hidden[:, 0]
    if pooler_type == "max_pooler":
        return hidden.masked_fill(mask == 0, torch.finfo(hidden.dtype).min).amax(dim=1)
    raise ValueError(f"unknown pooler {pooler_type!r}; one of {POOLERS}")


class HFTextTower(nn.Module):
    """An HF PyTorch encoder, a pooler and a projection."""

    def __init__(self, hf_model: nn.Module, output_dim: int, pooler_type: Optional[str] = None,
                 proj: Optional[str] = "mlp", pad_id: Optional[int] = None):
        super().__init__()
        self.config = hf_model.config
        arch = _arch(self.config)
        self.output_dim = output_dim
        self.pooler_type = pooler_type or arch["pooler"]
        if self.pooler_type not in POOLERS:
            raise ValueError(f"unknown pooler {self.pooler_type!r}")
        pad = pad_id if pad_id is not None else getattr(self.config, "pad_token_id", None)
        self.pad_id = 0 if pad is None else int(pad)
        self.encoder_decoder = bool(getattr(self.config, "is_encoder_decoder", False))
        self.transformer = hf_model.get_encoder() if self.encoder_decoder else hf_model
        d_model = getattr(self.config, arch["config_names"]["width"])
        if proj is None:
            if d_model != output_dim:
                raise ValueError(f"proj=None needs d_model == output_dim "
                                 f"({d_model} != {output_dim})")
            self.proj = nn.Identity()
        elif proj == "linear":
            self.proj = nn.Linear(d_model, output_dim, bias=False)
        else:
            hidden = (d_model + output_dim) // 2
            self.proj = nn.Sequential(nn.Linear(d_model, hidden, bias=False), nn.GELU(),
                                      nn.Linear(hidden, output_dim, bias=False))

    @classmethod
    def from_config(cls, config, output_dim: int, pooler_type: Optional[str] = None,
                    proj: Optional[str] = "mlp", seed: int = 0, pad_id: Optional[int] = None,
                    **model_kwargs) -> "HFTextTower":
        """The tower from a transformers config (hf_model.py:108-131): a
        PretrainedConfig, a dict with 'model_type', or a local directory;
        its weights and the projection's drawn from `seed`. A BERT-like
        model gets its pooling head only where the pooler reads it."""
        from transformers import AutoConfig, AutoModel

        if isinstance(config, dict):
            config = dict(config)
            config = AutoConfig.for_model(config.pop("model_type"), **config)
        elif isinstance(config, str):
            config = AutoConfig.from_pretrained(config, local_files_only=True)
        arch = _arch(config)
        if not getattr(config, "is_encoder_decoder", False):
            model_kwargs.setdefault(
                "add_pooling_layer", (pooler_type or arch["pooler"]) == "cls_pooler")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return cls(AutoModel.from_config(config, **model_kwargs), output_dim,
                       pooler_type=pooler_type, proj=proj, pad_id=pad_id)

    def forward(self, input_ids, normalize: bool = False, output_tokens: bool = False):
        attention_mask = (input_ids != self.pad_id).long()
        out = self.transformer(input_ids=input_ids, attention_mask=attention_mask)
        hidden = out.last_hidden_state
        pooled = pool(hidden, attention_mask, self.pooler_type,
                      getattr(out, "pooler_output", None))
        feats = self.proj(pooled)
        if normalize:
            feats = F.normalize(feats, dim=-1)
        if output_tokens:
            # ClsPooler drops the CLS position; ClsLastHiddenStatePooler does not
            return feats, hidden[:, 1:] if self.pooler_type == "cls_pooler" else hidden
        return feats

    def lock_mask(self, unlocked_layers: int = 0,
                  freeze_layer_norm: bool = True) -> Dict[str, float]:
        """HFTextEncoder.lock (hf_model.py:170-186) as a mask by parameter
        name: 0 freezes the whole encoder; otherwise its token embeddings
        and all but its last `unlocked_layers` layers freeze. LayerNorms in
        frozen parts stay trainable with `freeze_layer_norm=False`; the
        projection always trains."""
        names = _arch(self.config)["config_names"]
        n_layers = getattr(self.config, names["layers"])
        layer_attr = names["layer_attr"]
        emb = {names["token_embeddings_attr"], "embeddings", "shared", "embed_tokens"}

        def trainable(path) -> bool:
            frozen = unlocked_layers == 0
            if not frozen:
                frozen = bool(path) and path[0] in emb
                for i, p in enumerate(path[:-1]):
                    if p == layer_attr and path[i + 1].isdigit():
                        frozen = int(path[i + 1]) < n_layers - unlocked_layers
                        break
            if frozen and not freeze_layer_norm and any(p in _LN_NAMES for p in path):
                return True
            return not frozen

        mask = {}
        for name, _ in self.named_parameters():
            top, _, rest = name.partition(".")
            mask[name] = 1.0 if top != "transformer" else float(trainable(rest.split(".")))
        return mask
