from daclip_torch.models.clip import (CLIP, CLIPCfg, DaCLIP, TextCfg, VisionCfg,
                                      get_model_config, list_models)
from daclip_torch.models.unet import ConditionalUNet

__all__ = ["CLIP", "CLIPCfg", "ConditionalUNet", "DaCLIP", "TextCfg", "VisionCfg",
           "get_model_config", "list_models"]
