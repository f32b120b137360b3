"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

(The attention core `linear_attention.linear_attention` is not re-exported
here: its name is its module's. `conv3x3` is, as daclip_tpu.ops exports its
counterpart, so `daclip_torch.ops.conv3x3` names the function; its module is
reached with `from daclip_torch.ops.conv3x3 import ...`.)"""
from daclip_torch.ops.conv3x3 import conv3x3, conv3x3_reference, conv3x3_weight
from daclip_torch.ops.flash_attention import attention_reference, flash_self_attention
from daclip_torch.ops.linear_attention import (attn_wrap, attn_wrap_fused, attn_wrap_reference,
                                               fused_composition_reference,
                                               linear_attention_fused,
                                               linear_attention_reference)
from daclip_torch.ops.pointwise import dual_conv1x1, dual_conv1x1_reference

__all__ = ["attn_wrap", "attn_wrap_reference", "attn_wrap_fused", "linear_attention_fused",
           "fused_composition_reference", "linear_attention_reference", "dual_conv1x1",
           "dual_conv1x1_reference", "flash_self_attention", "attention_reference", "conv3x3",
           "conv3x3_reference", "conv3x3_weight"]
