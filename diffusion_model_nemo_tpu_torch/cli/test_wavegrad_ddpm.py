"""Dataset-level bits/dim of a WavegradDDPM archive with the port
(counterpart of ``examples/wavegrad_ddpm/test_wavegrad_ddpm.py``): a
``search_timesteps`` schedule is searched first (``search_iters``
candidates, seed 0), and the VLB runs over its T steps;
``search_timesteps=-1`` keeps the archive's schedule.

    python -m diffusion_model_nemo_tpu_torch.cli.test_wavegrad_ddpm \\
        model_path=Wavegrad-DDPM-UNet.dmn dataset_name=synthetic batch_size=32 limit_test_batches=1
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..models import WavegradDDPM
from .common import hydra_runner
from .test_ddpm import run_test


@dataclass
class TestConfig:
    __test__ = False  # not a pytest class

    model_path: Optional[str] = "WavegradDDPM.dmn"
    pretrained_model: Optional[str] = None
    dataset_name: Optional[str] = None
    dataset_split: str = "test"
    batch_size: int = 32
    limit_test_batches: Optional[int] = None
    use_ema: bool = True
    search_timesteps: int = 50
    search_iters: int = 100
    device: str = "cuda"


@hydra_runner(schema=TestConfig)
def main(cfg):
    """Returns ``trainer.test``'s result (``test_total_bpd``, ...)."""
    cfg = TestConfig(**cfg)

    def search(model):
        if cfg.search_timesteps > 0:
            model.sampler.use_searched_schedule(cfg.search_timesteps, cfg.search_iters, seed=0)

    return run_test(WavegradDDPM, cfg, prepare=search)


if __name__ == "__main__":
    main()
