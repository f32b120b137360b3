"""daclip_torch — the PyTorch/CUDA port of daclip_tpu.

DaCLIP `encode_image(control=True)` → IR-SDE posterior sampler through the
ConditionalUNet, and the restoration training step, with hand-written Hopper
kernels for the UNet's linear attention, flash self-attention, dual 1×1 and
3×3 conv (`daclip_torch.ops`); DA-CLIP's text side (tokenizer, text tower,
zero-shot degradation classification, the level predictor), PSNR/SSIM,
the JAX package's `.npz` params, the restoration data layer and CLIs, and
DA-CLIP / CLIP training (`cli/train_daclip.py`). It imports torch, never
jax, and nothing of daclip_tpu; entry points run on CUDA unless given
`device="cpu"`.
"""
from daclip_torch.models import CLIPCfg, ConditionalUNet, DaCLIP, get_model_config
from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig
from daclip_torch.sde import IRSDE, make_schedule

__all__ = ["CLIPCfg", "ConditionalUNet", "DACLIPRestorer", "DaCLIP", "IRSDE",
           "RestorerConfig", "get_model_config", "make_schedule"]
