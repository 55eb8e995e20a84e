"""Class-conditional DDPM with joint conditional / unconditional training
and classifier-free guidance.

Counterpart of ``diffusion_model_nemo_tpu/models/conditional_ddpm.py``:
``num_classes = K`` is required and index K is the null class; in training
each label is masked to K with probability 0.5 (``label_mask``, drawn with
the flip, t and noise in ``draw_training_inputs`` and injected, so a test
can feed the JAX step's mask), so one network models both. ``sample(label=
...)`` samples one class, or the null class without a label;
``guidance_scale = w`` guides: one network call on the 2B batch
``[x, x]`` with labels ``[label, null]`` a step, ε = ε_u + w·(ε_c − ε_u)
(with a learned variance, 2C channels, the ε half is guided and the
variance taken from the conditional half). The labels, and the guidance
scale as a float32 0-d tensor, reach the network as a ``Conditioned`` model
function, so a captured chain holds them as static buffers: one guided graph
serves every scale (``modules/gaussian_diffusion.py``).
``interpolate(label=...)`` runs DDPM's with the label bound (the null class
without one).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..config.registry import register_target
from ..modules.gaussian_diffusion import Conditioned
from .ddpm import DDPM

__all__ = ["ConditionalDDPM"]


@register_target("diffusion_model_nemo.models.ConditionalDDPM")
class ConditionalDDPM(DDPM):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        if self.cfg.get("num_classes") is None:
            raise ValueError("Conditional ddpm must have the `num_classes` value inside cfg.model !")
        self.num_classes = int(self.cfg.num_classes)
        self.random_class_index = self.num_classes
        self.sampler.use_class_conditioning = True

    def train_model_fn(self, params, x, t, classes=None, dropout_masks=None):
        """The network; no ``classes`` is the null class (``model_fn`` runs
        this under inference mode)."""
        if classes is None and self.sampler.use_class_conditioning:
            classes = torch.full((x.shape[0],), self.random_class_index, dtype=torch.int32, device=x.device)
        return super().train_model_fn(params, x, t, classes, dropout_masks)

    def get_model_fn(self, batch: Optional[Dict] = None, training: bool = False, label_mask=None,
                     dropout_masks=None):
        """The network with ``batch``'s labels bound; in training the labels
        where ``label_mask`` is true become the null class, and the dropout
        masks are bound."""
        fn = super().get_model_fn(training=training, dropout_masks=dropout_masks)
        if not self.sampler.use_class_conditioning or batch is None or "label" not in batch:
            return fn
        label = torch.as_tensor(batch["label"]).to(device=self.device, dtype=torch.int32)
        if label_mask is not None:
            label = torch.where(label_mask, self.random_class_index, label)
        return Conditioned(fn, {"classes": label})

    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """DDPM's draws (the offset and the dropout masks among them) and
        the label mask ~ Bernoulli(0.5) [B] (bool)."""
        draws = super().draw_training_inputs(shape, generator)
        draws["label_mask"] = torch.rand((shape[0],), generator=generator, device=self.device) < 0.5
        return draws

    def change_sampler(self, sampler_cfg) -> None:
        super().change_sampler(sampler_cfg)
        self.sampler.use_class_conditioning = True

    def _label_array(self, batch_size: int, label: Optional[int]) -> torch.Tensor:
        """[B] int32 of ``label`` (in [0, K): an index past the table would
        fault on the card), or of the null class K."""
        if label is not None and not 0 <= int(label) < self.num_classes:
            raise ValueError(f"label must be in [0, {self.num_classes}), got {label}")
        value = self.random_class_index if label is None else int(label)
        return torch.full((batch_size,), value, dtype=torch.int32, device=self.device)

    def _cfg_forward(self, params, x, t, classes, guidance_scale: torch.Tensor):
        """The guided network: one call on ``[x, x]`` with ``[classes,
        null]``; ε_u + w·(ε_c − ε_u) (the ε half only, with the
        conditional variance, for a learned-variance output). ``w`` is a
        float32 0-d tensor on the device, read where a captured chain keeps
        it."""
        w = guidance_scale
        null = torch.full_like(classes, self.random_class_index)
        out = self.model_fn(params, torch.cat([x, x]), torch.cat([t, t]), torch.cat([classes, null]))
        out_c, out_u = out.chunk(2, dim=0)
        if out_c.shape[-1] == 2 * x.shape[-1]:
            eps_c, var_c = out_c.chunk(2, dim=-1)
            eps_u = out_u.chunk(2, dim=-1)[0]
            return torch.cat([eps_u + w * (eps_c - eps_u), var_c], dim=-1)
        return out_u + w * (out_c - out_u)

    def sample(
        self,
        batch_size: int,
        image_size: int,
        generator: Optional[torch.Generator] = None,
        label: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        use_ema: bool = False,
        graphs: Optional[bool] = None,
        return_frames: bool = False,
    ):
        """Class-conditional sampling (the null class without a ``label``);
        ``guidance_scale`` guides (w = 1 is the conditional chain up to
        rounding). Returns [B, H, W, C] in [0, 1] (and the trajectory under
        ``return_frames``, as ``DDPM.sample``)."""
        if guidance_scale is not None and label is None:
            raise ValueError("guidance_scale requires a class label")
        labels = {"classes": self._label_array(batch_size, label)}
        if guidance_scale is None:
            model_fn = Conditioned(self.model_fn, labels)
        else:
            scale = torch.tensor(float(guidance_scale), dtype=torch.float32, device=self.device)
            model_fn = Conditioned(self._cfg_forward, {**labels, "guidance_scale": scale})
        shape = (batch_size, image_size, image_size, int(self.channels))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.p_sample_loop(model_fn, params, shape, generator, graphs=graphs,
                                              return_frames=return_frames)

    def interpolate(self, x1, x2, t=None, lambd: float = 0.5, generator=None, graphs=None,
                    return_frames: bool = False, label: Optional[int] = None, model_fn=None):
        """``DDPM.interpolate`` with ``label`` bound (the null class
        without one)."""
        labels = {"classes": self._label_array(x1.shape[0], label)}
        return super().interpolate(x1, x2, t=t, lambd=lambd, generator=generator, graphs=graphs,
                                   return_frames=return_frames, model_fn=Conditioned(self.model_fn, labels))
