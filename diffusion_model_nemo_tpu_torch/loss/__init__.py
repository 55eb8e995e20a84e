from .edm_loss import EDMLoss
from .sde_loss import SDEScoreFunctionLoss
from .simple_loss import DiffusionLoss
from .variational_bound_loss import VariationalBoundLoss, compute_variational_loss_terms

__all__ = ["DiffusionLoss", "EDMLoss", "SDEScoreFunctionLoss", "VariationalBoundLoss",
           "compute_variational_loss_terms"]
