"""Abstract diffusion process: the schedule's constant table and the
``compute_constants`` hook.

Counterpart of ``diffusion_model_nemo_tpu/modules/diffusion_process.py``.
The network is passed in as ``model_fn(params, x, t) -> output`` with the
parameters explicit, as in the JAX package; randomness comes from explicit
``torch.Generator``s. Image tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..ops.schedules import SCHEDULE_NAMES, ScheduleConstants, compute_schedule_constants, extract

__all__ = ["AbstractDiffusionProcess", "ModelFn"]

ModelFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]


class AbstractDiffusionProcess:
    """Owns the timesteps, the schedule config, the device and the table."""

    use_class_conditioning: bool = False

    def __init__(
        self,
        timesteps: int,
        schedule_name: str,
        schedule_cfg: Optional[Dict[str, Any]] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if schedule_name not in SCHEDULE_NAMES:
            raise ValueError(f"Invalid schedule `{schedule_name}` provided to sampler !")
        self.timesteps = int(timesteps)
        self.schedule_name = schedule_name
        self.schedule_cfg = dict(schedule_cfg) if schedule_cfg is not None else {}
        self.device = torch.device(device)
        self.constants: Optional[ScheduleConstants] = None

    def compute_constants(self, timesteps: int) -> None:
        """(Re)build the constant table on the process's device."""
        self.timesteps = int(timesteps)
        self.constants = compute_schedule_constants(
            self.timesteps, self.schedule_name, self.schedule_cfg, device=self.device
        )

    def table_tensors(self) -> Tuple[torch.Tensor, ...]:
        """The tensors of the constant table: a captured step that reads
        the table is held to them (``ops/graphs.py:cached``), so that a
        ``compute_constants`` (a new T or schedule) captures anew instead of
        replaying the old table."""
        c = self.constants
        return tuple(getattr(c, f.name) for f in dataclasses.fields(c))

    @staticmethod
    def extract(table: torch.Tensor, t, x_shape) -> torch.Tensor:
        return extract(table, t, len(x_shape))

    def q_posterior(self, x_start, x, t):
        raise NotImplementedError()

    def q_sample(self, x_start, t, noise):
        raise NotImplementedError()

    def p_mean_variance(self, model_fn, params, x, t, model_output=None):
        raise NotImplementedError()

    def p_sample(self, model_fn, params, x, t, generator=None):
        raise NotImplementedError()

    def sample(self, model_fn, params, shape, generator=None, **kwargs):
        raise NotImplementedError()
