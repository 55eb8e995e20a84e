"""Class-conditional EDM with joint conditional / unconditional training and
classifier-free guidance.

Counterpart of ``diffusion_model_nemo_tpu/models/conditional_edm.py``:
``num_classes = K`` is required and index K is the null class; unlabelled
calls (sampling without a label, ``encode``, ``interpolate``, an unlabelled
NLL) run as the null class. In training each label becomes the null class
with probability ``cond_drop_prob`` (default 0.5): the mask is the
``label_mask`` draw, injected like the other draws. ``sample(label=...,
guidance_scale=w)`` guides on the raw network output, F = F_u + w·(F_c −
F_u), with one network call on the 2B batch ``[x, x]`` and labels
``[label, null]`` an evaluation (D and the ODE slope are affine in F, so
this is guidance on the score). The labels, and the scale as a float32 0-d
tensor, reach the sampler as a ``Conditioned`` model function, so a
captured chain holds them as static buffers: one guided graph serves every
label and every scale (the JAX package compiles one per (label, w)).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..config.registry import register_target
from ..modules.gaussian_diffusion import Conditioned
from .edm import EDM

__all__ = ["ConditionalEDM"]


@register_target("diffusion_model_nemo.models.ConditionalEDM", "diffusion_model_nemo_tpu.models.ConditionalEDM")
class ConditionalEDM(EDM):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        if self.cfg.get("num_classes") is None:
            raise ValueError("Conditional EDM must have the `num_classes` value inside cfg.model !")
        self.num_classes = int(self.cfg.num_classes)
        self.random_class_index = self.num_classes
        self.cond_drop_prob = float(self.cfg.get("cond_drop_prob", 0.5))

    def train_model_fn(self, params, x, t, classes=None, dropout_masks=None, aug_cond=None):
        """The network; no ``classes`` is the null class (``model_fn`` runs
        this under inference mode)."""
        if classes is None:
            classes = torch.full((x.shape[0],), self.random_class_index, dtype=torch.int32, device=x.device)
        return super().train_model_fn(params, x, t, classes, dropout_masks, aug_cond)

    def _bind_classes(self, fn, labels: Optional[torch.Tensor]):
        return fn if labels is None else Conditioned(fn, {"classes": labels.to(torch.int32)})

    def get_model_fn(self, batch: Optional[Dict] = None, training: bool = False, label_mask=None,
                     dropout_masks=None, aug_cond=None):
        """The network with ``batch``'s labels bound; in training the labels
        where ``label_mask`` is true become the null class."""
        fn = super().get_model_fn(training=training, dropout_masks=dropout_masks, aug_cond=aug_cond)
        if batch is None or "label" not in batch:
            return fn
        label = torch.as_tensor(batch["label"]).to(device=self.device, dtype=torch.int32)
        if label_mask is not None:
            label = torch.where(label_mask, self.random_class_index, label)
        return Conditioned(fn, {"classes": label})

    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """EDM's draws and the label mask ~ Bernoulli(cond_drop_prob) [B]."""
        draws = super().draw_training_inputs(shape, generator)
        draws["label_mask"] = torch.rand((shape[0],), generator=generator, device=self.device) < self.cond_drop_prob
        return draws

    def _label_array(self, batch_size: int, label: Optional[int]) -> torch.Tensor:
        """[B] int32 of ``label`` (in [0, K)), or of the null class K."""
        if label is not None and not 0 <= int(label) < self.num_classes:
            raise ValueError(f"label must be in [0, {self.num_classes}), got {label}")
        value = self.random_class_index if label is None else int(label)
        return torch.full((batch_size,), value, dtype=torch.int32, device=self.device)

    def _cfg_forward(self, params, x, t, classes, guidance_scale: torch.Tensor):
        """The guided network: one call on ``[x, x]`` with ``[classes,
        null]``; F_u + w·(F_c − F_u), ``w`` a float32 0-d device tensor."""
        null = torch.full_like(classes, self.random_class_index)
        out = self.model_fn(params, torch.cat([x, x]), torch.cat([t, t]), torch.cat([classes, null]))
        out_c, out_u = out.chunk(2, dim=0)
        return out_u + guidance_scale * (out_c - out_u)

    def sample(self, batch_size: int, image_size: int, generator: Optional[torch.Generator] = None,
               label: Optional[int] = None, guidance_scale: Optional[float] = None, **kwargs):
        """Class-conditional Algorithm 2 (the null class without a
        ``label``); ``guidance_scale`` (needs a label) guides. Other
        arguments as ``EDM.sample``."""
        if guidance_scale is not None and label is None:
            raise ValueError("guidance_scale requires label= (a class to guide toward)")
        labels = {"classes": self._label_array(batch_size, label)}
        if guidance_scale is None:
            model_fn = Conditioned(self.model_fn, labels)
        else:
            scale = torch.tensor(float(guidance_scale), dtype=torch.float32, device=self.device)
            model_fn = Conditioned(self._cfg_forward, {**labels, "guidance_scale": scale})
        return super().sample(batch_size, image_size, generator=generator, model_fn=model_fn, **kwargs)
