"""Dataset-level evaluation of a rectified-flow archive with the port
(counterpart of ``examples/rectified_flow/test_rectified_flow.py``): the
flow-matching loss and, under ``compute_nll`` (default true), the exact
change-of-variables bits/dim and its NFE.

    python -m diffusion_model_nemo_tpu_torch.cli.test_rectified_flow \\
        model_path=RectifiedFlow.dmn dataset_name=synthetic batch_size=32 limit_test_batches=1

Reports ``test_fm_loss`` (and ``test_total_bpd``,
``avg_num_forward_evaluations``) through ``Trainer.test``. ``device=cpu``
runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..models import RectifiedFlow
from ..training import Trainer
from .common import hydra_runner

log = logging.getLogger(__name__)


@dataclass
class TestConfig:
    __test__ = False  # not a pytest class

    model_path: Optional[str] = "RectifiedFlow.dmn"
    pretrained_model: Optional[str] = None
    dataset_name: Optional[str] = None
    dataset_split: str = "test"
    batch_size: int = 32
    limit_test_batches: Optional[int] = None
    compute_nll: bool = True
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=TestConfig)
def main(cfg):
    """Returns ``trainer.test``'s result."""
    cfg = TestConfig(**cfg)
    if cfg.model_path:
        model = RectifiedFlow.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    else:
        model = RectifiedFlow.from_pretrained(cfg.pretrained_model, use_ema=cfg.use_ema, device=cfg.device)
    model.cfg["compute_nll"] = bool(cfg.compute_nll)
    name = cfg.dataset_name or (model.cfg.get("train_ds") or {}).get("name")
    model.setup_test_data({"name": name, "split": cfg.dataset_split, "batch_size": cfg.batch_size})
    result = Trainer(devices=-1, limit_test_batches=cfg.limit_test_batches).test(model)
    log.info(f"Result: {result}")
    return result


if __name__ == "__main__":
    main()
