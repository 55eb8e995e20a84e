"""Serve a DDPM, ImprovedDDPM, ConditionalDDPM or ScoreSDE archive as a batched
sampling daemon with the port (counterpart of ``examples/serve.py``; the
archive's recorded class is restored through
``restore_model_from_archive``).

    python -m diffusion_model_nemo_tpu_torch.cli.serve model_path=DDPM.dmn \\
        port=8000 max_batch=64 use_ddim_sampler=true ddim_timesteps=50

    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/sample -d '{"num_images": 4, "seed": 0, "format": "png"}'
    curl -s -X POST localhost:8000/sample -d '{"num_images": 4, "label": 3, "guidance_scale": 3.0}'

The fields are those of the JAX script's ``ServeConfig`` that the port's
server has; ``device=cpu`` serves from the CPU. A ScoreSDE archive needs
``use_ddim_sampler=false`` (it serves with its own predictor–corrector
sampler; the DDIM swap raises, as in the JAX script).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..serving import serve
from .common import hydra_runner

__all__ = ["ServeConfig", "build_server", "main"]


@dataclass
class ServeConfig:
    model_path: str = "DDPM.dmn"
    host: str = "127.0.0.1"
    port: int = 8000
    max_batch: int = 64
    linger_ms: float = 5.0
    use_ema: bool = True
    base_seed: int = 0
    use_ddim_sampler: bool = True
    ddim_timesteps: int = 50
    ddim_eta: float = 0.0
    image_size: Optional[int] = None
    device: str = "cuda"


@hydra_runner(schema=ServeConfig)
def build_server(cfg):
    """The warmed-up server for ``argv`` (not listening yet)."""
    cfg = ServeConfig(**cfg)
    return serve(
        cfg.model_path, host=cfg.host, port=cfg.port, max_batch=cfg.max_batch,
        linger_ms=cfg.linger_ms, use_ema=cfg.use_ema, use_ddim_sampler=cfg.use_ddim_sampler,
        ddim_timesteps=cfg.ddim_timesteps, ddim_eta=cfg.ddim_eta, base_seed=cfg.base_seed,
        image_size=cfg.image_size, device=cfg.device,
    )


def main(argv=None):
    build_server(argv).serve_forever()


if __name__ == "__main__":
    main()
