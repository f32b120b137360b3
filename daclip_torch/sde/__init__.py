from daclip_torch.sde.irsde import IRSDE, Schedule, make_schedule

__all__ = ["IRSDE", "Schedule", "make_schedule"]
