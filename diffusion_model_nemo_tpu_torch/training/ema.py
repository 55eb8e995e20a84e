"""Exponential moving average of parameters.

Counterpart of ``diffusion_model_nemo_tpu/training/ema.py``:
ema ← d·ema + (1−d)·params with the warm-up d = min(decay, (1+step)/(10+step)),
where ``step`` counts the optimizer steps done before this update (the
first update uses d = 0.1). d is computed in float32, as the JAX package
computes it on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["init_ema", "ema_update", "ema_decay_at"]


def init_ema(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


def ema_decay_at(decay: float, step: Optional[int]) -> float:
    d = np.float32(decay)
    if step is not None:
        d = min(d, np.float32(1.0 + step) / np.float32(10.0 + step))
    return float(d)


def ema_update(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float, step: Optional[int] = None) -> None:
    """In place: ema = ema·d + params·(1−d)."""
    d = ema_decay_at(decay, step)
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, torch._foreach_mul([params[k].detach() for k in keys], float(np.float32(1.0) - np.float32(d))))
