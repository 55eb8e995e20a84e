"""Spherical interpolation of two latents, denoised with the strided DDIM
sampler (counterpart of ``examples/ddpm/interpolate_ddim.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.interpolate_ddim model_path=DDPM.dmn \\
        num_interpolations=8 ddim_timesteps=50

Draws z1, z2 ~ N(0, I) from ``seed``, slerps ``num_interpolations`` points
between them and runs the DDIM chain from each. Writes ``slerp.png`` under
``output_dir``. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import torch

from ..models import DDPM
from ..utils.image import save_image_grid
from .common import hydra_runner

log = logging.getLogger(__name__)


@dataclass
class InterpolateDDIMConfig:
    model_path: str = "DDPM.dmn"
    num_interpolations: int = 8  # points along the slerp path
    ddim_eta: float = 0.0
    ddim_timesteps: int = 50
    image_size: int = -1
    output_dir: str = "interpolations_ddim"
    seed: int = 0
    use_ema: bool = True
    device: str = "cuda"


def slerp(z1: torch.Tensor, z2: torch.Tensor, alpha: float) -> torch.Tensor:
    """The great-circle point at ``alpha`` between z1 and z2 (the angle
    between the flattened latents)."""
    cos = (z1 * z2).sum() / (z1.norm() * z2.norm())
    theta = torch.arccos(cos.clamp(-1 + 1e-7, 1 - 1e-7))
    return torch.sin((1 - alpha) * theta) / torch.sin(theta) * z1 + torch.sin(alpha * theta) / torch.sin(theta) * z2


@hydra_runner(schema=InterpolateDDIMConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = InterpolateDDIMConfig(**cfg)
    model = DDPM.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    model.change_sampler(dict(model.cfg.sampler, _target_="diffusion_model_nemo.modules.GeneralizedGaussianDiffusion",
                              eta=cfg.ddim_eta, ddim_timesteps=cfg.ddim_timesteps))
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    shape = (image_size, image_size, int(model.channels))
    gen = torch.Generator(device=model.device).manual_seed(cfg.seed)
    z1 = torch.randn(shape, generator=gen, device=model.device)
    z2 = torch.randn(shape, generator=gen, device=model.device)
    alphas = torch.linspace(0.0, 1.0, cfg.num_interpolations).tolist()
    latents = torch.stack([slerp(z1, z2, a) for a in alphas])
    imgs = model.interpolate(latents, latents, generator=gen)
    out_dir = Path(cfg.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_image_grid(imgs, str(out_dir / "slerp.png"), nrow=cfg.num_interpolations)
    log.info(f"Saved DDIM slerp to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
