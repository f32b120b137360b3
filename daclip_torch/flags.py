"""Kernel-selecting switches of the ConditionalUNet, read from the environment
once at import, with the names and defaults of `daclip_tpu/flags.py:37-48`:

  DACLIP_TPU_V5_WRAP=1         the v5 linear-attention wrap (default); 0 selects
  DACLIP_TPU_V3_WRAP=0           the v4 wiring, or with V3_WRAP=1 the v3 wrap
  DACLIP_TPU_POINTWISE=0       1 runs each ResBlock's res_conv through the
  DACLIP_TPU_POINTWISE_MAXO      dual 1×1 kernel, at sites with out channels
                                 ≤ POINTWISE_MAXO (default: every site)

They only supply the defaults of `pipeline.RestorerConfig`, so the CLI and
the cog predictor follow the same variables as the JAX package's;
`ConditionalUNet` itself takes explicit arguments. The JAX package's TPU
layout switches (MERGE_RES, BLOCK_BARRIER, POLY_UP, TAP_FINAL, SPLIT_SKIP,
ATTN_PACK) re-express the same math for the TPU and are not ported.
"""
from __future__ import annotations

import os


def _on(name: str, default: str) -> bool:
    return os.environ.get(name, default) == "1"


V5_WRAP = _on("DACLIP_TPU_V5_WRAP", "1")
V3_WRAP = _on("DACLIP_TPU_V3_WRAP", "0")
POINTWISE = _on("DACLIP_TPU_POINTWISE", "0")
_maxo = os.environ.get("DACLIP_TPU_POINTWISE_MAXO")
POINTWISE_MAXO = None if _maxo is None else int(_maxo)  # None: every site

# the UNet's `linear_attention` argument, as daclip_tpu/models/unet.py:296-316 picks
LINEAR_ATTENTION = "v5" if V5_WRAP else ("v3" if V3_WRAP else "v4")
