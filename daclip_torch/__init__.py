"""daclip_torch — the PyTorch/CUDA port of daclip_tpu's restore path.

DaCLIP `encode_image(control=True)` → IR-SDE posterior sampler through the
ConditionalUNet, with hand-written Hopper kernels for the UNet's
linear-attention wrap and flash self-attention (`daclip_torch.ops`). It
imports torch, never jax, and nothing of daclip_tpu; entry points run on
CUDA unless given `device="cpu"`.
"""
from daclip_torch.models import CLIPCfg, ConditionalUNet, DaCLIP, get_model_config
from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig
from daclip_torch.sde import IRSDE, make_schedule

__all__ = ["CLIPCfg", "ConditionalUNet", "DACLIPRestorer", "DaCLIP", "IRSDE",
           "RestorerConfig", "get_model_config", "make_schedule"]
