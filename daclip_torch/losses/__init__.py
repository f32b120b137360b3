from daclip_torch.losses.matching import matching_loss

__all__ = ["matching_loss"]
