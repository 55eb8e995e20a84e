"""Exponential moving average of parameters.

Counterpart of ``diffusion_model_nemo_tpu/training/ema.py``:
ema ← d·ema + (1−d)·params with the warm-up d = min(decay, (1+step)/(10+step)),
where ``step`` counts the optimizer steps done before this update (the
first update uses d = 0.1). d is computed in float32, as the JAX package
computes it on the device. The pair (d, 1 − d) of each step is a row of
``ema_decay_table``, built on the host over steps 0 … n: an update reads its
row on the device, so that a captured training step (``ops/graphs.py``)
reads each replay's own from a static buffer.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["init_ema", "ema_update", "ema_decay_at", "ema_decay_table"]


def init_ema(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


def ema_decay_at(decay: float, step: Optional[int]) -> float:
    d = np.float32(decay)
    if step is not None:
        d = min(d, np.float32(1.0 + step) / np.float32(10.0 + step))
    return float(d)


def ema_decay_table(decay: float, n: int, device) -> torch.Tensor:
    """[n + 1, 2] float32 on ``device``: (d, 1 - d) at steps 0 … n."""
    d = np.array([ema_decay_at(decay, step) for step in range(n + 1)], dtype=np.float32)
    return torch.from_numpy(np.stack([d, np.float32(1.0) - d], axis=1)).to(device)


def ema_update(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: torch.Tensor) -> None:
    """In place: ema = ema·d + params·(1−d), with ``decay`` the step's row
    (d, 1 - d) of ``ema_decay_table`` on the parameters' device."""
    d, one_minus = decay.unbind()
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, torch._foreach_mul([params[k].detach() for k in keys], one_minus))
