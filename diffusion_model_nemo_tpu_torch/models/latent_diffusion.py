"""Latent diffusion: a DDPM-family process in a frozen KL autoencoder's latent.

Counterpart of ``diffusion_model_nemo_tpu/models/latent_diffusion.py``
(Rombach et al. 2022). The U-Net and the samplers of the pixel families
run unchanged on the [B, S/f, S/f, z] latents of a trained
``AutoencoderKLModel``; the config's ``diffusion_model`` is the latent
geometry, and ``first_stage`` is either ``restore_from: <ae.dmn>`` (its
EMA weights under ``use_ema``, the default, when the archive has them) or
an inline ``autoencoder: {...AutoencoderKL}`` spec, initialised from a
generator of its own (seed + 1).

- The first stage is frozen: its weights are tensors without
  ``requires_grad``, outside the optimizer's, the EMA's and the
  checkpoints' state; the training step encodes under ``no_grad`` inside
  the captured step (the Trainer holds the graph to the first stage's
  tensors through ``frozen_tensors``).
- ``scale_factor`` maps latents to the diffusion's scale (``z ·
  scale_factor``; ``/`` on the way back). It lives in a 0-d device tensor
  that every graph reads as a buffer: ``calibrate_scale_factor`` (1 / the
  population std of one batch's posterior means) refills it, so no graph
  replays a stale factor and none is captured anew.
- The training step is JAX's override: the latent of the flipped batch (the
  posterior draw ``posterior`` under ``posterior_sample``, else the mode),
  then only ``loss(model output, noise or v)``: no Min-SNR-γ weight and no
  offset noise; dropout stays.
- ``sample`` runs the sampler's latent chain (captured steps on CUDA), then
  one decode and the display map as a captured graph of its own.
  ``interpolate`` encodes both endpoints with injected posterior draws,
  noises them to t, lerps, re-denoises with the configured sampler and
  decodes. ``return_frames``, ``mesh``, ``inpaint`` and ``edit`` (SDEdit
  would run the U-Net on pixels, which the JAX package's inherited method
  does and fails at) raise; so does pixel bits/dim.
- ``save_to`` writes a self-contained archive: the first stage's weights as
  the ``aux_first_stage`` member and its module spec as
  ``extra.first_stage_config``; ``restore_from`` needs no autoencoder file.

The JAX sampler's x̂₀ clip to [-1, 1] acts on the scaled latent, as in the
JAX package (ROADMAP §3).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple, Union

import torch

from ..config.registry import get_target, register_target
from ..config.yaml_config import from_dict
from ..data.hf_vision_data import preprocess_batch
from ..modules.autoencoder import AutoencoderKL, diagonal_gaussian_sample
from ..modules.gaussian_diffusion import _randn
from ..modules.parts import not_ported
from ..ops import graphs as graphs_lib
from ..training import checkpoints as ckpt_lib
from ..utils.weights import from_flax_params, to_flax_params
from .abstract_diffusion_model import resolve_archive_path
from .autoencoder_kl import display, first_stage_call
from .ddpm import DDPM

__all__ = ["LatentDiffusion"]

log = logging.getLogger(__name__)


def _build_first_stage(fs_cfg) -> AutoencoderKL:
    """The AutoencoderKL module of a first-stage spec."""
    net_cfg = dict(fs_cfg)
    target = get_target(str(net_cfg.pop("_target_", "diffusion_model_nemo.modules.AutoencoderKL")))
    return target(**net_cfg)


@register_target("diffusion_model_nemo.models.LatentDiffusion", "diffusion_model_nemo_tpu.models.LatentDiffusion")
class LatentDiffusion(DDPM):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        cfg = from_dict(cfg)
        fs = cfg.get("first_stage")
        if fs is None:
            raise ValueError(
                "LatentDiffusion requires cfg.first_stage (restore_from: <ae.dmn> "
                "or an inline autoencoder: {...AutoencoderKL} spec)"
            )
        fs = from_dict(fs)
        src = fs.get("restore_from")
        if src:
            ae_cfg, ae_params, ae_ema, _ = ckpt_lib.load_archive(resolve_archive_path(str(src)))
            self.first_stage = _build_first_stage(ae_cfg["diffusion_model"])
            chosen = ae_ema if (ae_ema is not None and bool(fs.get("use_ema", True))) else ae_params
            fs_params = from_flax_params(chosen, self.first_stage)
            log.info(f"LatentDiffusion first stage restored from : {src}")
        elif fs.get("autoencoder") is not None:
            self.first_stage = _build_first_stage(fs["autoencoder"])
            self.first_stage.reset_parameters(torch.Generator().manual_seed(int(seed) + 1))
            fs_params = dict(self.first_stage.state_dict())
            log.info("LatentDiffusion first stage randomly initialized (no restore_from given) — train the "
                     "AutoencoderKLModel first for real runs")
        else:
            raise ValueError("first_stage needs either restore_from: <path> or autoencoder: {...}")
        self.latent_channels = int(self.first_stage.z_channels)
        super().__init__(cfg, device=device, seed=seed)
        self.first_stage.eval().requires_grad_(False)  # a structure: its weights are first_stage_params
        self.first_stage_params = {k: v.to(self.device) for k, v in fs_params.items()}
        # LDM's latent scale: z · scale_factor is what the diffusion sees.
        self._scale = torch.tensor(float(self.cfg.get("scale_factor", 1.0)), dtype=torch.float32, device=self.device)
        self.posterior_sample = bool(self.cfg.get("posterior_sample", True))

        f = int(self.first_stage.downsample_factor)
        if int(self.image_size) % f:
            raise ValueError(
                f"image_size {self.image_size} is not divisible by the first stage's downsample factor {f}"
            )
        self.latent_size = int(self.image_size) // f
        net_ch = self.cfg.get("diffusion_model", {}).get("channels")
        if net_ch is not None and int(net_ch) != self.latent_channels:
            raise ValueError(
                f"diffusion_model.channels ({net_ch}) must equal the first stage's z_channels "
                f"({self.latent_channels}) — the U-Net runs in latent space"
            )
        self.graphs: dict = {}  # the decode graphs (ops/graphs.py:captured_call)

    # ---- geometry --------------------------------------------------------------
    def _example_input_channels(self) -> int:
        return self.latent_channels

    def _example_spatial_size(self) -> int:
        return self.latent_size

    def latent_shape(self, batch: int, image_size: Optional[int] = None) -> Tuple[int, int, int, int]:
        s = self._example_spatial_size() if image_size is None else int(image_size) // int(self.first_stage.downsample_factor)
        return batch, s, s, self.latent_channels

    @property
    def scale_factor(self) -> float:
        return float(self._scale)

    def frozen_tensors(self) -> Tuple[torch.Tensor, ...]:
        """The first stage's weights: what a captured step reads besides
        the trained parameters (the Trainer holds its graph to them)."""
        return tuple(self.first_stage_params.values())

    # ---- the first stage ----------------------------------------------------------
    def encode_to_latent(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[-1, 1] images → scaled latents (the posterior draw with ``eps``,
        else the mode)."""
        mean, logvar = first_stage_call(self.first_stage, self.first_stage_params, "encode", x)
        return diagonal_gaussian_sample(mean, logvar, eps) * self._scale

    def decode_from_latent(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents → [-1, 1] images."""
        return first_stage_call(self.first_stage, self.first_stage_params, "decode", z / self._scale)

    def _decode_display(self, z: torch.Tensor, graphs: Optional[bool]) -> torch.Tensor:
        """Scaled latents → [0, 1] images, a captured graph on CUDA."""
        return graphs_lib.captured_call(
            self.graphs, "decode", lambda z: display(self.decode_from_latent(z)),
            {"z": z}, self.frozen_tensors(), graphs)

    def calibrate_scale_factor(self, batch) -> float:
        """LDM's one-time latent normalization: ``scale_factor = 1 / std``
        of one raw batch's posterior means (the population std, as
        ``jnp.std``), written into ``cfg`` and into the factor's buffer."""
        x = preprocess_batch(batch, self.device)["pixel_values"]
        with torch.no_grad():
            mean, _ = first_stage_call(self.first_stage, self.first_stage_params, "encode", x)
            std = float(mean.std(correction=0))
            scale = 1.0 / max(std, 1e-8)
            self._scale.fill_(scale)
        self.cfg["scale_factor"] = scale
        log.info(f"Calibrated latent scale_factor = {scale:.4f} (std {std:.4f})")
        return scale

    # ---- training ------------------------------------------------------------------
    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One step's draws for images of ``shape`` [B, S, S, C]: the flip
        mask, t ~ U[0, T) (int32), the noise at the latent's shape, the
        posterior's ε ``posterior`` (under ``posterior_sample``) and the
        U-Net's dropout keep masks at the latent's shape."""
        B, dev = shape[0], self.device
        zshape = self.latent_shape(B, shape[1])
        draws = {
            "flip": torch.rand((B,), generator=generator, device=dev) < 0.5,
            "t": torch.randint(0, self.timesteps, (B,), generator=generator, device=dev, dtype=torch.int32),
            "noise": torch.randn(zshape, generator=generator, device=dev, dtype=torch.float32),
        }
        if self.posterior_sample:
            draws["posterior"] = torch.randn(zshape, generator=generator, device=dev, dtype=torch.float32)
        draws.update(self.draw_dropout_masks(zshape, generator))
        return draws

    def training_step(self, params, batch, draws):
        """DDPM's Algorithm 1 on the latents of the flipped batch (encoded
        under ``no_grad``), with only the loss against the noise (or v)."""
        self._check_training_options()
        proc = preprocess_batch(batch, self.device, flip=draws["flip"])
        with torch.no_grad():
            z = self.encode_to_latent(proc["pixel_values"], draws.get("posterior") if self.posterior_sample else None)
        model_fn = self.get_model_fn(proc, training=True, dropout_masks=self.dropout_masks(draws))
        t, noise = draws["t"], draws["noise"]
        z_t = self.sampler.q_sample(x_start=z, t=t, noise=noise)
        loss = self.loss(input=model_fn(params, z_t, t), target=self.training_target(z, t, noise))
        return loss, {"train_loss": loss}

    # ---- evaluation -----------------------------------------------------------------
    def test_step(self, batch, batch_nb: int, generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The latent ε-prediction loss of a raw batch's mode latents (times
        B), at t and noise drawn from ``generator`` (default seeded with
        ``batch_nb``) or given."""
        x = preprocess_batch(batch, self.device)["pixel_values"]
        B = x.shape[0]
        generator = generator or torch.Generator(device=self.device).manual_seed(int(batch_nb))
        with torch.inference_mode():
            z = self.encode_to_latent(x)
            if t is None:
                t = torch.randint(0, self.timesteps, (B,), generator=generator, device=self.device, dtype=torch.int32)
            if noise is None:
                noise = _randn(z.shape, generator, self.device)
            t, noise = t.to(self.device), noise.to(self.device)
            z_t = self.sampler.q_sample(x_start=z, t=t, noise=noise)
            loss = self.loss(input=self.model_fn(self.params, z_t, t), target=noise)
            return {"sum_loss": loss * B, "num_samples": B}

    def test_epoch_end(self, outputs) -> Dict[str, float]:
        total = float(sum(o["num_samples"] for o in outputs))
        result = {"test_latent_loss": float(sum(float(o["sum_loss"]) for o in outputs)) / total}
        log.info(f"LatentDiffusion test: {result}")
        return result

    def calculate_bits_per_dimension(self, *args, **kwargs):
        raise NotImplementedError("LatentDiffusion: the latent VLB is not the pixel NLL (compute_bpd: false); "
                                  "test_step reports the latent loss")

    # ---- inference ----------------------------------------------------------------------
    def sample(self, batch_size: int, image_size: int, generator: Optional[torch.Generator] = None,
               use_ema: bool = False, graphs: Optional[bool] = None, return_frames: bool = False, mesh=None,
               **_):
        """The sampler's chain in latent space, one decode, the display map:
        [B, image_size, image_size, C] in [0, 1] on the model's device."""
        if return_frames:
            raise NotImplementedError(
                "LatentDiffusion.sample(return_frames=True): the trajectory lives in latent space; decode "
                "selected frames via decode_from_latent instead"
            )
        if mesh is not None:
            raise not_ported("LatentDiffusion.sample", "mesh=", "multi-device")
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            z = self.sampler.p_sample_loop(self.get_model_fn(), params, self.latent_shape(batch_size, image_size),
                                           generator, unnormalize=False, graphs=graphs)
            return self._decode_display(z, graphs)

    def interpolate(self, x1: torch.Tensor, x2: torch.Tensor, t: Optional[int] = None, lambd: float = 0.5,
                    generator: Optional[torch.Generator] = None, graphs: Optional[bool] = None, **_):
        """LDM's interpolation of two batches in [-1, 1]: each endpoint's
        posterior draw (x1's, then x2's ε from ``generator``), noised to
        ``t`` (default T − 1; x1's, then x2's draw), lerped, the last ``t``
        steps of the sampler's chain, decoded → [0, 1]."""
        if x1.ndim != 4 or x1.shape != x2.shape:
            raise ValueError(f"x1 and x2 must be batches of one shape, got {list(x1.shape)} and {list(x2.shape)}")
        t = self.timesteps - 1 if t is None else int(t)
        sampler, dev = self.sampler, self.device
        with torch.inference_mode():
            zshape = self.latent_shape(x1.shape[0], x1.shape[1])
            z1 = self.encode_to_latent(x1.to(dev).float(), _randn(zshape, generator, dev))
            z2 = self.encode_to_latent(x2.to(dev).float(), _randn(zshape, generator, dev))
            t_b = torch.full((zshape[0],), t, dtype=torch.int32, device=dev)
            zt1 = sampler.q_sample(z1, t_b, _randn(zshape, generator, dev))
            zt2 = sampler.q_sample(z2, t_b, _randn(zshape, generator, dev))
            z = (1.0 - lambd) * zt1 + lambd * zt2
            z = sampler.p_sample_loop(self.get_model_fn(), self.params, zshape, generator, img=z, num_steps=t,
                                      unnormalize=False, graphs=graphs)
            return self._decode_display(z, graphs)

    def inpaint(self, *args, **kwargs):
        raise NotImplementedError(
            "RePaint blends pixel-space ancestral steps with the known pixels; in latent space the mask does "
            "not factorize across the decoder — use a pixel-space DDPM for inpainting"
        )

    def edit(self, *args, **kwargs):
        raise NotImplementedError(
            "LatentDiffusion.edit: SDEdit noises and denoises the input images themselves, and this model's "
            "U-Net takes latents (the JAX package's inherited edit fails on the channel count) — encode, edit "
            "in latent space and decode with a pixel-space pipeline instead"
        )

    # ---- persistence -------------------------------------------------------------------
    def first_stage_config(self) -> Dict:
        fs = self.first_stage
        return {
            "_target_": "diffusion_model_nemo.modules.AutoencoderKL",
            "dim": int(fs.dim),
            "dim_mults": [int(m) for m in fs.dim_mults],
            "z_channels": int(fs.z_channels),
            "channels": int(fs.channels),
            "resnet_block_groups": int(fs.resnet_block_groups),
            "dropout": fs.dropout,
            "dtype": "bfloat16" if fs.dtype == torch.bfloat16 else "float32",
        }

    def save_to(self, path: str) -> str:
        """A self-contained archive: the U-Net's weights and EMA, the frozen
        first stage as ``aux_first_stage`` and its spec in ``extra``."""
        net = self.diffusion_model
        ema = None if self.ema_params is None else to_flax_params(self.ema_params, net)
        return ckpt_lib.save_archive(
            path, self.cfg, to_flax_params(self.params, net), ema,
            extra={"model_class": type(self).__name__, "first_stage_config": self.first_stage_config()},
            aux_weights={"first_stage": to_flax_params(self.first_stage_params, self.first_stage)},
        )

    @classmethod
    def restore_from(cls, path: str, use_ema: bool = False, device: Union[str, torch.device] = "cuda"):
        path = resolve_archive_path(path)
        cfg, params, ema, extra = ckpt_lib.load_archive(path)
        aux = ckpt_lib.load_aux_weights(path)
        fs_cfg = (extra or {}).get("first_stage_config")
        if fs_cfg is None or "first_stage" not in aux:
            raise ValueError(f"{path} is not a LatentDiffusion archive (no embedded first stage)")
        cfg = from_dict(cfg)
        cfg["first_stage"] = {"autoencoder": dict(fs_cfg)}  # the module spec; the weights below
        model = cls(cfg=cfg, device=device)
        model.first_stage_params = {k: v.to(model.device)
                                    for k, v in from_flax_params(aux["first_stage"], model.first_stage).items()}
        model._load_flax(params, ema, use_ema)
        log.info(f"Model restored from : {path}")
        return model
