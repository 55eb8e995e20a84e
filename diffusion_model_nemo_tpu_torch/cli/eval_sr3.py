"""Super-resolve images with an SR3 archive (counterpart of
``examples/sr3/eval_sr3.py``). The inputs are high-resolution ground truth,
degraded here as in training, so PSNR against them can be reported.

    python -m diffusion_model_nemo_tpu_torch.cli.eval_sr3 model_path=SR3.dmn \\
        input_path=hr_images/ batch_size=8
    ... use_ddim_sampler=true ddim_timesteps=50     # or use_dpm_solver=true dpm_steps=20
    ... dataset_name=synthetic                     # instead of input_path

``input_path`` is an ``.npy`` / ``.npz`` file or an image directory (a
``name: file`` dataset) at the model's size. Writes ``hr.png``,
``lr_upsampled.png``, ``sr.png`` (grids) and ``sr_<i>.png`` under
``output_dir`` with the port's PNG writer. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.hf_vision_data import build_dataloader
from ..models import SR3
from ..utils.image import encode_png, save_image_grid, to_uint8
from .common import hydra_runner
from .eval_ddpm import generator_of, output_dir

log = logging.getLogger(__name__)

DDIM = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
DPM = "diffusion_model_nemo.modules.DPMSolverDiffusion"


@dataclass
class EvalConfig:
    model_path: str = "SR3.dmn"
    input_path: str = ""  # HR images: a directory / .npy / .npz (the file-dataset formats)
    dataset_name: str = ""  # or a dataset name (synthetic)
    batch_size: int = 8

    # sampler swaps (DPM-Solver++ over DDIM)
    use_ddim_sampler: bool = False
    ddim_timesteps: int = 50
    eta: float = 0.0
    use_dpm_solver: bool = False
    dpm_steps: int = 20

    output_dir: str = "sr_samples"
    add_timestamp: bool = True
    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


def swap_sampler(model, target: str, **fields) -> None:
    """``model``'s sampler swapped for ``target`` with ``fields`` over its
    own config."""
    model.change_sampler(dict(model.cfg.sampler, _target_=target, **fields))


def hr_images(model, cfg) -> np.ndarray:
    """The first ``batch_size`` HR images of ``input_path`` (or
    ``dataset_name``) at the model's size, [B, H, W, C] in [0, 1]."""
    if not (cfg.input_path or cfg.dataset_name):
        raise ValueError("eval_sr3 needs input_path= or dataset_name=")
    size, channels = int(model.image_size), int(model.channels)
    ds_cfg = {"name": "file", "path": cfg.input_path} if cfg.input_path else {"name": cfg.dataset_name}
    ds_cfg.update(batch_size=cfg.batch_size, image_size=size, channels=channels, shuffle=False,
                  num_workers=0)
    hr = next(iter(build_dataloader(ds_cfg, mode="test")))["image"][: cfg.batch_size]
    return hr.astype(np.float32) / 255.0


@hydra_runner(schema=EvalConfig)
def main(cfg):
    """Returns (the output directory, the PSNR [B] in dB)."""
    cfg = EvalConfig(**cfg)
    model = SR3.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if cfg.use_dpm_solver:
        swap_sampler(model, DPM, solver_steps=cfg.dpm_steps)
    elif cfg.use_ddim_sampler:
        swap_sampler(model, DDIM, eta=cfg.eta, ddim_timesteps=cfg.ddim_timesteps)
    hr = torch.from_numpy(hr_images(model, cfg)).to(model.device)
    with torch.inference_mode():
        lr = (model.degrade(hr * 2.0 - 1.0) + 1.0) * 0.5  # display-space LR
        lr_up = ((model.upsample(lr * 2.0 - 1.0) + 1.0) * 0.5).clamp(0.0, 1.0)
    sr = model.super_resolve(lr, generator=generator_of(model, cfg))
    psnr = model.psnr(sr, hr).cpu().numpy()
    log.info(f"PSNR vs ground truth: mean {psnr.mean():.2f} dB ({psnr.round(2).tolist()})")
    out_dir = output_dir(cfg)
    sr = sr.float().cpu().numpy()
    save_image_grid(hr.cpu().numpy(), str(out_dir / "hr.png"), nrow=6)
    save_image_grid(lr_up.cpu().numpy(), str(out_dir / "lr_upsampled.png"), nrow=6)
    save_image_grid(sr, str(out_dir / "sr.png"), nrow=6)
    for i, img in enumerate(to_uint8(sr)):
        (out_dir / f"sr_{i}.png").write_bytes(encode_png(img))
    log.info(f"Saved {sr.shape[0]} super-resolved images to {out_dir}")
    return out_dir, psnr


if __name__ == "__main__":
    main()
