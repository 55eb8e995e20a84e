"""The trainable KL autoencoder: the first stage of latent diffusion.

Counterpart of ``diffusion_model_nemo_tpu/models/autoencoder_kl.py``: the
``AutoencoderKL`` network (``modules/autoencoder.py``) trained with LDM's
objective, ``loss = rec(x, x̂) + kl_weight · mean_B KL(q(z|x) ‖ N(0, I))``
(the KL summed per sample, ``kl_weight`` 1e-6 by default), on the Trainer's
step (no timestep, no sampler). The step's draws are injected, as in every
family: the flip, the posterior ε ``posterior`` at the latent's shape and
the dropout masks (``draw_training_inputs`` → ``training_step(params,
batch, draws)``).

``test_step`` / ``test_epoch_end`` report the mode reconstruction's MSE on
the [0, 1] scale, its PSNR and the KL. The services ``encode`` (the mode,
or a draw), ``decode``, ``reconstruct``, ``sample`` (prior draws decoded,
for the Trainer's dumps) and ``interpolate`` (a lerp of the modes) each run
as a captured graph on CUDA (``ops/graphs.py:captured_call``). Archives
record ``model_class: AutoencoderKLModel``.
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from ..config.registry import instantiate, register_target
from ..data.hf_vision_data import preprocess_batch
from ..modules.autoencoder import diagonal_gaussian_kl, diagonal_gaussian_sample
from ..ops import graphs as graphs_lib
from .abstract_diffusion_model import AbstractDiffusionModel

__all__ = ["AutoencoderKLModel", "display", "first_stage_call"]

log = logging.getLogger(__name__)


def _half(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def first_stage_call(net, params: Dict[str, torch.Tensor], what: str, x: torch.Tensor):
    """``net.encode`` (→ (mean, logvar)) or ``net.decode`` with ``params``
    (a ``state_dict`` of the whole autoencoder), deterministic."""
    name = {"encode": "encoder", "decode": "decoder"}[what]
    return functional_call(getattr(net, name), _half(params, name), (x,))


def display(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → [0, 1], clipped."""
    return ((img + 1.0) * 0.5).clamp(0.0, 1.0)


@register_target("diffusion_model_nemo.models.AutoencoderKLModel", "diffusion_model_nemo_tpu.models.AutoencoderKLModel")
class AutoencoderKLModel(AbstractDiffusionModel):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        self.diffusion_model = self.build_network()
        self.sampler = None  # no diffusion process
        self.loss = instantiate(self.cfg.get("loss"))
        self.kl_weight = float(self.cfg.get("kl_weight", 1.0e-6))
        self.graphs: dict = {}  # the captured services (ops/graphs.py:captured_call)
        self.init_params()
        n = sum(int(v.numel()) for v in self.params.values())
        log.info(f"Initialized AutoencoderKLModel with {n:,} parameters")

    @property
    def downsample_factor(self) -> int:
        return int(self.diffusion_model.downsample_factor)

    def latent_shape(self, batch: int, image_size: int) -> Tuple[int, int, int, int]:
        s = int(image_size) // self.downsample_factor
        return batch, s, s, int(self.diffusion_model.z_channels)

    # ---- training ----------------------------------------------------------------
    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One step's draws for images of ``shape`` [B, S, S, C]: the flip
        mask (p = 0.5), the posterior's ε ``posterior`` [B, S/f, S/f, z]
        and the dropout keep masks (``dropout/<site>``)."""
        B, dev = shape[0], self.device
        draws = {
            "flip": torch.rand((B,), generator=generator, device=dev) < 0.5,
            "posterior": torch.randn(self.latent_shape(B, shape[1]), generator=generator, device=dev,
                                     dtype=torch.float32),
        }
        draws.update(self.draw_dropout_masks(shape, generator))
        return draws

    def training_step(self, params, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reconstruction loss of the flipped batch's posterior draw plus
        ``kl_weight`` times the batch-mean KL; metrics ``train_loss``,
        ``rec_loss``, ``kl``."""
        if self.loss is None:
            raise ValueError("AutoencoderKLModel training needs a `loss` config")
        x = preprocess_batch(batch, self.device, flip=draws["flip"])["pixel_values"]
        masks = self.dropout_masks(draws) or None
        rec, mean, logvar = functional_call(self.diffusion_model, params, (x, draws["posterior"]),
                                            {"dropout_masks": masks})
        rec_loss = self.loss(input=rec, target=x)
        kl = diagonal_gaussian_kl(mean, logvar).mean()
        loss = rec_loss + self.kl_weight * kl
        return loss, {"train_loss": loss, "rec_loss": rec_loss, "kl": kl}

    # ---- evaluation --------------------------------------------------------------
    def test_step(self, batch, batch_nb: int, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The mode reconstruction of a raw uint8 batch: its MSE on the [0, 1]
        scale times B, and the summed KL."""
        x = preprocess_batch(batch, self.device)["pixel_values"]
        with torch.inference_mode():
            rec, mean, logvar = functional_call(self.diffusion_model, self.params, (x,))
            mse01 = ((rec - x) * 0.5).square().mean()
            return {"sum_mse": mse01 * x.shape[0], "sum_kl": diagonal_gaussian_kl(mean, logvar).sum(),
                    "num_samples": x.shape[0]}

    def test_epoch_end(self, outputs) -> Dict[str, float]:
        total = float(sum(o["num_samples"] for o in outputs))
        mse = float(sum(float(o["sum_mse"]) for o in outputs)) / total
        result = {
            "test_rec_mse": mse,
            "test_rec_psnr": float(-10.0 * np.log10(max(mse, 1e-12))),
            "test_kl": float(sum(float(o["sum_kl"]) for o in outputs)) / total,
        }
        log.info(f"Autoencoder test: {result}")
        return result

    # ---- services ----------------------------------------------------------------
    def _call(self, name: str, fn, inputs: Dict[str, torch.Tensor], params, graphs: Optional[bool]):
        with torch.inference_mode():
            inputs = {k: v.to(self.device) for k, v in inputs.items()}
            return graphs_lib.captured_call(self.graphs, name, functools.partial(fn, params), inputs,
                                            params.values(), graphs)

    def _params(self, use_ema: bool) -> Dict[str, torch.Tensor]:
        return self.ema_params if use_ema else self.params

    def encode(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None, use_ema: bool = False,
               graphs: Optional[bool] = None) -> torch.Tensor:
        """Images [B, H, W, C] in [-1, 1] → latents: the posterior's mode, or
        its draw with the caller's ``eps`` ~ N(0, I)."""
        net = self.diffusion_model
        if eps is None:
            return self._call("encode", lambda p, x: first_stage_call(net, p, "encode", x)[0], {"x": x},
                              self._params(use_ema), graphs)

        def draw(p, x, eps):
            return diagonal_gaussian_sample(*first_stage_call(net, p, "encode", x), eps)

        return self._call("encode_draw", draw, {"x": x, "eps": eps}, self._params(use_ema), graphs)

    def decode(self, z: torch.Tensor, use_ema: bool = False, graphs: Optional[bool] = None) -> torch.Tensor:
        """Latents → images in [-1, 1]."""
        net = self.diffusion_model
        return self._call("decode", lambda p, z: first_stage_call(net, p, "decode", z), {"z": z},
                          self._params(use_ema), graphs)

    def reconstruct(self, x01: torch.Tensor, use_ema: bool = False, graphs: Optional[bool] = None) -> torch.Tensor:
        """[0, 1] images → the mode's reconstruction in [0, 1], one graph."""
        net = self.diffusion_model

        def rec(p, x):
            mean, _ = first_stage_call(net, p, "encode", x * 2.0 - 1.0)
            return display(first_stage_call(net, p, "decode", mean))

        return self._call("reconstruct", rec, {"x": x01.float()}, self._params(use_ema), graphs)

    def sample(self, batch_size: int, image_size: int, generator: Optional[torch.Generator] = None,
               use_ema: bool = False, graphs: Optional[bool] = None, **_):
        """Prior draws z ~ N(0, I) from ``generator`` (default seeded 0)
        decoded → [B, H, W, C] in [0, 1] (the Trainer's dumps; a KL-weighted
        autoencoder is no generative prior)."""
        generator = generator or torch.Generator(device=self.device).manual_seed(0)
        z = torch.randn(self.latent_shape(batch_size, image_size), generator=generator, device=self.device)
        net = self.diffusion_model
        return self._call("sample_decode", lambda p, z: display(first_stage_call(net, p, "decode", z)), {"z": z},
                          self._params(use_ema), graphs)

    def interpolate(self, x1: torch.Tensor, x2: torch.Tensor, t=None, lambd: float = 0.5,
                    graphs: Optional[bool] = None, **_):
        """The decoded lerp of two [0, 1] batches' modes → [0, 1], one graph."""
        net, lambd = self.diffusion_model, float(lambd)

        def lerp(p, x1, x2):
            z1, _ = first_stage_call(net, p, "encode", x1 * 2.0 - 1.0)
            z2, _ = first_stage_call(net, p, "encode", x2 * 2.0 - 1.0)
            return display(first_stage_call(net, p, "decode", (1.0 - lambd) * z1 + lambd * z2))

        return self._call(f"interpolate_{lambd!r}", lerp, {"x1": x1.float(), "x2": x2.float()}, self.params, graphs)
