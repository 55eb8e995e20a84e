"""The score-function adapter that the loss, the samplers and the
likelihood share.

Counterpart of ``diffusion_model_nemo_tpu/modules/sde_lib/score_fn.py``: for
VP and sub-VP the network's output is scaled by −1/std and the network
gets the float time label t·(N−1) (a discrete VP takes int labels and the
``sqrt_1m_alphas_cumprod`` table instead); for VE the label is the marginal
σ (continuous) or the reversed discrete index round((T − t)(N − 1)).
"""

from __future__ import annotations

from typing import Any

import torch

from .sde_lib import SDE, batch_mul, take
from .sub_vp_sde import subVPSDE
from .ve_sde import VESDE
from .vp_sde import VPSDE

__all__ = ["resolve_score_function", "probability_flow_drift"]


def _batched(labels: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The network's time input is [B]; a 0-d label serves the whole batch."""
    return labels.expand(x.shape[0]) if labels.ndim == 0 else labels


def resolve_score_function(model_fn, sde: SDE, continuous: bool = True):
    """``model_fn(params, x, labels)`` as ``score_fn(params, x, t)``, ``t``
    [B] or 0-d."""
    if isinstance(sde, (VPSDE, subVPSDE)):

        def score_fn(params: Any, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            if continuous or isinstance(sde, subVPSDE):
                labels = t * (sde.N - 1)
                score = model_fn(params, x, _batched(labels, x))
                _, std = sde.marginal_prob(torch.zeros_like(x), t)
            else:
                labels = (t * (sde.N - 1)).to(torch.int32)
                score = model_fn(params, x, _batched(labels, x))
                std = take(sde.sqrt_1m_alphas_cumprod, labels)
            return batch_mul(-1.0 / std, score)

    elif isinstance(sde, VESDE):

        def score_fn(params: Any, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            if continuous:
                labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
            else:
                labels = torch.round((sde.T - t) * (sde.N - 1)).to(torch.int32)
            return model_fn(params, x, _batched(labels, x))

    else:
        raise NotImplementedError(f"SDE class {sde.__class__.__name__} not yet supported.")

    return score_fn


def probability_flow_drift(model_fn, sde: SDE, params: Any, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The probability-flow ODE's drift at (x, t), the continuous score's
    (the probability-flow sampler's and the likelihood's ODE)."""
    score_fn = resolve_score_function(model_fn, sde, continuous=True)
    return sde.reverse(score_fn, probability_flow=True).sde(params, x, t)[0]
