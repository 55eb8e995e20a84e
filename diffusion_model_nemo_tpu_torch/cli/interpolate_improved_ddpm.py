"""Interpolate pairs of dataset images in q space and re-denoise with an
ImprovedDDPM archive's learned-variance ancestral chain (counterpart of
``examples/improved_ddpm/interpolate_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.interpolate_improved_ddpm \\
        model_path=ImprovedDDPM.dmn batch_size=8 t=500

The fields and outputs of ``interpolate_ddpm``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models import ImprovedDDPM
from .common import hydra_runner
from .interpolate_ddpm import InterpolateConfig, run


@dataclass
class ImprovedInterpolateConfig(InterpolateConfig):
    model_path: str = "ImprovedDDPM.dmn"


@hydra_runner(schema=ImprovedInterpolateConfig)
def main(cfg):
    """Returns the output directory."""
    return run(ImprovedDDPM, ImprovedInterpolateConfig(**cfg))


if __name__ == "__main__":
    main()
