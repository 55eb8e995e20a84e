"""Interpolate pairs of dataset images in q space and re-denoise with the
port (counterpart of ``examples/ddpm/interpolate_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.interpolate_ddpm model_path=DDPM.dmn \\
        batch_size=8 t=500 lambd=0.5 output_dir=interpolations

Takes 2·batch_size images of the test split of ``dataset_name`` (default
the archive's training set; the port has the synthetic sets), noises the
two halves to ``t`` (default T−1), lerps them by ``lambd`` and runs the
ancestral chain's last t steps. Writes ``interpolation.png``,
``endpoint_a.png`` and ``endpoint_b.png`` under ``output_dir``.
``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from ..data import preprocess_batch
from ..models import DDPM
from ..utils.image import save_image_grid
from .common import hydra_runner

log = logging.getLogger(__name__)


@dataclass
class InterpolateConfig:
    model_path: str = "DDPM.dmn"
    dataset_name: Optional[str] = None
    dataset_split: str = "test"
    batch_size: int = 8
    t: Optional[int] = None  # noising depth; default T-1
    lambd: float = 0.5
    output_dir: str = "interpolations"
    seed: int = 0
    use_ema: bool = True
    device: str = "cuda"


def run(model_cls, cfg: InterpolateConfig) -> Path:
    """Restore a ``model_cls`` archive and interpolate; returns the output
    directory."""
    model = model_cls.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    name = cfg.dataset_name or (model.cfg.get("train_ds") or {}).get("name")
    dl = model._setup_dataloader({"name": name, "split": cfg.dataset_split, "batch_size": 2 * cfg.batch_size},
                                 mode="test")
    x = preprocess_batch(next(iter(dl)), model.device)["pixel_values"]
    x1, x2 = x[: cfg.batch_size], x[cfg.batch_size: 2 * cfg.batch_size]
    out = model.interpolate(x1, x2, t=cfg.t, lambd=cfg.lambd,
                            generator=torch.Generator(device=model.device).manual_seed(cfg.seed))
    out_dir = Path(cfg.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_image_grid(out, str(out_dir / "interpolation.png"), nrow=cfg.batch_size)
    save_image_grid((x1 + 1) / 2, str(out_dir / "endpoint_a.png"), nrow=cfg.batch_size)
    save_image_grid((x2 + 1) / 2, str(out_dir / "endpoint_b.png"), nrow=cfg.batch_size)
    log.info(f"Saved interpolations to {out_dir}")
    return out_dir


@hydra_runner(schema=InterpolateConfig)
def main(cfg):
    """Returns the output directory."""
    return run(DDPM, InterpolateConfig(**cfg))


if __name__ == "__main__":
    main()
