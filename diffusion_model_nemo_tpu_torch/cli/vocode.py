"""Synthesize waveforms from mel features with a vocoder archive (counterpart
of ``examples/wavegrad_ddpm/vocode.py``): a ``sample_timesteps`` schedule
is searched first (``search_iters`` candidates, seed 0; -1 runs the full
chain), and the mel features of a held-out batch of the archive's dataset
are vocoded.

    python -m diffusion_model_nemo_tpu_torch.cli.vocode model_path=Wavegrad-Vocoder.dmn \\
        batch_size=4 sample_timesteps=50 output_dir=vocoded

Writes ``vocoded.npy`` (the waveforms) and ``reference.npy`` (the batch's
own) under ``output_dir``. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..data import build_dataloader
from ..models import WavegradVocoderModel
from .common import hydra_runner

log = logging.getLogger(__name__)


@dataclass
class VocodeConfig:
    model_path: str = "Wavegrad-Vocoder.dmn"
    batch_size: int = 4
    sample_timesteps: int = 50  # short-schedule synthesis; -1 = the full chain
    search_iters: int = 500
    output_dir: str = "vocoded"
    seed: int = 0
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=VocodeConfig)
def main(cfg):
    """Returns (output directory, waveforms [B, T] on the host)."""
    cfg = VocodeConfig(**cfg)
    model = WavegradVocoderModel.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if cfg.sample_timesteps > 0:
        model.sampler.use_searched_schedule(cfg.sample_timesteps, cfg.search_iters, seed=0)
    loader = build_dataloader(dict(model.cfg.train_ds, batch_size=cfg.batch_size), mode="test")
    wav = torch.from_numpy(next(iter(loader))["audio"]).to(model.device)
    out = model.vocode(model.compute_mel(wav), generator=torch.Generator(device=model.device).manual_seed(cfg.seed))
    out = out.float().cpu().numpy()
    out_dir = Path(cfg.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "vocoded.npy", out)
    np.save(out_dir / "reference.npy", wav.cpu().numpy())
    log.info(f"Saved {out.shape[0]} waveforms ({out.shape[1]} samples) to {out_dir}")
    return out_dir, out


if __name__ == "__main__":
    main()
