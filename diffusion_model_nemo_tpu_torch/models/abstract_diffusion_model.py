"""Base model: builds the network and the sampler from the config, owns the
parameters and their EMA copy, sets up the training data, and hot-swaps
samplers.

Counterpart of ``diffusion_model_nemo_tpu/models/abstract_diffusion_model.py``
without bits/dim, sample dumps and ``.dmn`` archives. Parameters are
``state_dict``-style dicts of float32 tensors (``params``, ``ema_params``) on
the model's device; ``get_model_fn()`` returns ``model_fn(params, x, t)``
that runs the network with the given parameters (inference), and
``train_model_fn`` the same with autograd.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch.func import functional_call

from ..config.config import Config, from_dict
from ..config.registry import get_target, instantiate
from ..data.hf_vision_data import build_dataloader

__all__ = ["AbstractDiffusionModel"]


class AbstractDiffusionModel:
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.cfg: Config = from_dict(cfg)
        self.device = torch.device(device)
        self.image_size = self.cfg.get("image_size")
        self.timesteps = self.cfg.get("timesteps")
        self.channels = self.cfg.get("channels", 3)
        self.seed = int(seed)
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        self._train_dl = None

    # ---- network plumbing -----------------------------------------------------
    def build_network(self) -> torch.nn.Module:
        """Instantiate ``cfg.diffusion_model`` on the model's device with
        weights drawn from ``seed`` (lecun-normal, like flax's init)."""
        net_cfg = dict(self.cfg.diffusion_model)
        target = get_target(str(net_cfg.pop("_target_")))
        net = target(**net_cfg)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        net.to(self.device)
        net.eval()
        net.requires_grad_(False)
        return net

    def init_params(self) -> Dict[str, torch.Tensor]:
        """Take the network's weights as ``params`` and copy them to ``ema_params``."""
        self.params = dict(self.diffusion_model.state_dict())
        self.ema_params = {k: v.clone() for k, v in self.params.items()}
        return self.params

    def model_fn(self, params, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return functional_call(self.diffusion_model, params, (x, t))

    def train_model_fn(self, params, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``model_fn`` with autograd on: gradients reach ``params``."""
        return functional_call(self.diffusion_model, params, (x, t))

    def get_model_fn(self):
        return self.model_fn

    def forward(self, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.model_fn(self.params, x_t, t)

    # ---- data ------------------------------------------------------------------
    def setup_training_data(self, train_data_config) -> None:
        """The JAX package's training-data setup: shuffle on, and a synthetic
        set defaults to the model's image size and channels."""
        cfg = from_dict(train_data_config)
        if "shuffle" in cfg:
            cfg["shuffle"] = True
        self._train_dl = None
        if cfg.get("name") is not None:
            cfg.setdefault("image_size", self.image_size)
            cfg.setdefault("channels", self.channels)
            self._train_dl = build_dataloader(cfg, mode="train")

    # ---- sampler hot-swap -----------------------------------------------------
    def change_sampler(self, sampler_cfg) -> None:
        """Re-instantiate the sampler and persist its config in ``cfg``."""
        sampler_cfg = from_dict(sampler_cfg)
        self.sampler = instantiate(sampler_cfg, device=self.device)
        self.cfg["sampler"] = sampler_cfg
