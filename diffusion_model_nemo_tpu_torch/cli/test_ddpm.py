"""Dataset-level bits/dim of a DDPM archive with the port (counterpart of
``examples/ddpm/test_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.test_ddpm model_path=DDPM.dmn \\
        dataset_name=synthetic batch_size=32 limit_test_batches=1

``device=cpu`` runs on the CPU. Without ``model_path`` the model comes from
the local hub (``pretrained_model=<name>``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..models import DDPM
from ..training import Trainer
from .common import hydra_runner

log = logging.getLogger(__name__)


@dataclass
class TestConfig:
    __test__ = False  # not a pytest class

    model_path: Optional[str] = "DDPM.dmn"
    pretrained_model: Optional[str] = None
    dataset_name: Optional[str] = None
    dataset_split: str = "test"
    batch_size: int = 32
    limit_test_batches: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


def run_test(model_class, cfg, prepare=None):
    """The test scripts' body for ``model_class``: ``trainer.test``'s result
    (``prepare(model)`` runs after the restore)."""
    if cfg.model_path:
        model = model_class.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    else:
        model = model_class.from_pretrained(cfg.pretrained_model, use_ema=cfg.use_ema, device=cfg.device)
    if prepare is not None:
        prepare(model)
    name = cfg.dataset_name or (model.cfg.get("train_ds") or {}).get("name")
    model.setup_test_data({"name": name, "split": cfg.dataset_split, "batch_size": cfg.batch_size})
    result = Trainer(devices=-1, limit_test_batches=cfg.limit_test_batches).test(model)
    log.info(f"Result: {result}")
    return result


@hydra_runner(schema=TestConfig)
def main(cfg):
    """Returns ``trainer.test``'s result (``test_total_bpd``, ...)."""
    return run_test(DDPM, TestConfig(**cfg))


if __name__ == "__main__":
    main()
