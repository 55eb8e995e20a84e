"""Dataset-level bits/dim of a ConditionalDDPM archive with the port
(counterpart of ``examples/conditional_ddpm/test_conditional_ddpm.py``): the
network sees each test batch's labels.

    python -m diffusion_model_nemo_tpu_torch.cli.test_conditional_ddpm \\
        model_path=ConditionalDDPM.dmn dataset_name=synthetic batch_size=32 limit_test_batches=1
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..models import ConditionalDDPM
from .common import hydra_runner
from .test_ddpm import run_test


@dataclass
class TestConfig:
    __test__ = False  # not a pytest class

    model_path: Optional[str] = "ConditionalDDPM.dmn"
    pretrained_model: Optional[str] = None
    dataset_name: Optional[str] = None
    dataset_split: str = "test"
    batch_size: int = 32
    limit_test_batches: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=TestConfig)
def main(cfg):
    """Returns ``trainer.test``'s result (``test_total_bpd``, ...)."""
    return run_test(ConditionalDDPM, TestConfig(**cfg))


if __name__ == "__main__":
    main()
