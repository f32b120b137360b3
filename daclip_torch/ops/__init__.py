"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from daclip_torch.ops.flash_attention import attention_reference, flash_self_attention
from daclip_torch.ops.linear_attention import attn_wrap, attn_wrap_reference

__all__ = ["attn_wrap", "attn_wrap_reference", "flash_self_attention",
           "attention_reference"]
