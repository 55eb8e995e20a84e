from .likelihood import LikelihoodEstimate
from .score_fn import resolve_score_function
from .sde_lib import SDE, ReverseSDE, batch_mul
from .sub_vp_sde import subVPSDE
from .ve_sde import VESDE
from .vp_sde import VPSDE

__all__ = ["SDE", "ReverseSDE", "batch_mul", "VPSDE", "subVPSDE", "VESDE", "LikelihoodEstimate",
           "resolve_score_function"]
