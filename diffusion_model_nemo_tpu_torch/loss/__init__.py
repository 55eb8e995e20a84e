from .simple_loss import DiffusionLoss

__all__ = ["DiffusionLoss"]
