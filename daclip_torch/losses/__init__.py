from daclip_torch.losses.clip_loss import (clip_loss, coca_loss, daclip_loss_fork,
                                          daclip_loss_uir, distill_clip_loss, fcrc_loss,
                                          gather_features)
from daclip_torch.losses.matching import matching_loss

__all__ = ["clip_loss", "coca_loss", "daclip_loss_fork", "daclip_loss_uir", "distill_clip_loss",
           "fcrc_loss", "gather_features", "matching_loss"]
