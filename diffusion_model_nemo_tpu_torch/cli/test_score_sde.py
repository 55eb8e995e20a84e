"""Dataset-level ODE bits/dim and NFE of a ScoreSDE archive with the port
(counterpart of ``examples/score_sde/test_score_sde.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.test_score_sde model_path=ScoreSDE.dmn \\
        dataset_name=synthetic batch_size=32 limit_test_batches=1

Reports ``test_total_bpd`` and ``avg_num_forward_evaluations`` through
``Trainer.test``. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..models import ScoreSDE
from .common import hydra_runner
from .test_ddpm import run_test


@dataclass
class TestConfig:
    __test__ = False  # not a pytest class

    model_path: Optional[str] = "ScoreSDE.dmn"
    pretrained_model: Optional[str] = None
    dataset_name: Optional[str] = None
    dataset_split: str = "test"
    batch_size: int = 32
    limit_test_batches: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=TestConfig)
def main(cfg):
    """Returns ``trainer.test``'s result (``test_total_bpd``,
    ``avg_num_forward_evaluations``)."""
    return run_test(ScoreSDE, TestConfig(**cfg))


if __name__ == "__main__":
    main()
