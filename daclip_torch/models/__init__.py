from daclip_torch.models.clip import (CLIP, CLIPCfg, DaCLIP, MultiTypeDegradationPredictor,
                                      TextCfg, VisionCfg, add_model_config, get_model_config,
                                      list_models)
from daclip_torch.models.coca import CoCa, CoCaCfg, MultimodalCfg, MultimodalTransformer
from daclip_torch.models.coca import generate as coca_generate
from daclip_torch.models.coca import generate_beam as coca_generate_beam
from daclip_torch.models.transformer import (AttentionalPooler, TextTransformer, Transformer,
                                             VisionTransformer)
from daclip_torch.models.unet import ConditionalUNet

# daclip_tpu's exports but CustomTextCLIP (here `CLIP(custom_text=True)`)
__all__ = [
    "CLIP", "CLIPCfg", "DaCLIP", "MultiTypeDegradationPredictor",
    "TextCfg", "VisionCfg", "add_model_config", "get_model_config", "list_models",
    "CoCa", "CoCaCfg", "MultimodalCfg", "coca_generate", "coca_generate_beam",
    "AttentionalPooler", "MultimodalTransformer",
    "TextTransformer", "Transformer", "VisionTransformer", "ConditionalUNet",
]
