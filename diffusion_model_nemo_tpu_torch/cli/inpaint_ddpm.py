"""RePaint inpainting from a DDPM-family archive with the port
(counterpart of ``examples/ddpm/inpaint_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.inpaint_ddpm model_path=DDPM.dmn \\
        input_path=images.npy mask=center jump_length=10 jump_n_sample=10

Inputs: ``input_path`` a ``.npy`` array or a ``.npz`` archive (its
``images``), [N, H, W, C] or [N, C, H, W] or [N, H, W], uint8 or floats
in [0, 1] / [-1, 1], or an image directory (PNG without Pillow), read as a
``name: file`` dataset, at the model's image size; or nothing, and the
ground truth is sampled from the model itself (the self-inpainting demo). The mask is a named pattern (left|right|top|bottom half, center
box, random pixels, ``mask_fraction`` of the image) or a ``.npy`` file (1 =
keep). Writes ``input.png``, ``masked.png``, ``inpainted.png`` and
``inpainted_<i>.png`` under ``output_dir``. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.hf_vision_data import build_dataloader
from ..models import restore_model_from_archive
from ..utils.image import encode_png, save_image_grid, to_uint8
from .common import hydra_runner
from .eval_ddpm import output_dir

log = logging.getLogger(__name__)


@dataclass
class InpaintConfig:
    model_path: str = "DDPM.dmn"
    input_path: str = ""  # .npy / .npz / image directory; "" = sample from the model
    batch_size: int = 8

    mask: str = "center"  # left|right|top|bottom|center|random | path to .npy
    mask_fraction: float = 0.5  # masked fraction for the named patterns
    jump_length: int = 10
    jump_n_sample: int = 10

    output_dir: str = "inpainted"
    add_timestamp: bool = True
    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


def build_mask(name: str, shape, fraction: float, generator: torch.Generator) -> np.ndarray:
    """[1, H, W, 1] float mask, 1 = keep, 0 = generate."""
    H, W = shape[1], shape[2]
    m = np.ones((1, H, W, 1), np.float32)
    k = max(1, int(round(fraction * H)))
    kw = max(1, int(round(fraction * W)))
    if name == "left":
        m[:, :, :kw] = 0.0
    elif name == "right":
        m[:, :, W - kw:] = 0.0
    elif name == "top":
        m[:, :k] = 0.0
    elif name == "bottom":
        m[:, H - k:] = 0.0
    elif name == "center":
        h0, w0 = (H - k) // 2, (W - kw) // 2
        m[:, h0: h0 + k, w0: w0 + kw] = 0.0
    elif name == "random":
        keep = torch.rand((1, H, W, 1), generator=generator, device=generator.device) < 1.0 - fraction
        m = keep.float().cpu().numpy()
    elif name.endswith(".npy"):
        m = np.load(name).astype(np.float32)
        m = m.reshape((1, H, W, -1))[..., :1]
    else:
        raise ValueError(f"unknown mask pattern {name!r}")
    return m


def load_images(path: str, batch_size: int, image_size: int, channels: int) -> np.ndarray:
    """The first ``batch_size`` images (all, if fewer) of an ``.npy`` /
    ``.npz`` file or an image directory, read as a ``name: file`` dataset
    (JAX ``examples/ddpm/inpaint_ddpm.py:load_images``), as [B, H, W, C]
    floats in [0, 1] at the model's size."""
    dl = build_dataloader({"name": "file", "path": path, "batch_size": batch_size, "shuffle": False,
                           "num_workers": 0}, mode="test")
    dl.drop_last = False  # a file with fewer images than batch_size gives them all
    imgs = next(iter(dl))["image"]
    if imgs.shape[1:] != (image_size, image_size, channels):
        raise ValueError(f"images must be [N, {image_size}, {image_size}, {channels}] for this model, "
                         f"got {imgs.shape}")
    return imgs.astype(np.float32) / 255.0


def source_images(model, cfg, generator: torch.Generator) -> torch.Tensor:
    """``cfg.input_path``'s images, or a batch sampled from the model."""
    if cfg.input_path:
        src = torch.from_numpy(load_images(cfg.input_path, cfg.batch_size, int(model.image_size),
                                           int(model.channels))).to(model.device)
    else:
        log.info("No input_path given: sampling the source images from the model")
        src = model.sample(batch_size=cfg.batch_size, image_size=int(model.image_size), generator=generator)
    return src[: cfg.batch_size].float()


@hydra_runner(schema=InpaintConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = InpaintConfig(**cfg)
    model = restore_model_from_archive(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if not hasattr(model, "inpaint"):
        raise ValueError(f"{type(model).__name__} has no inpaint surface (RePaint needs a DDPM-family "
                         "ancestral sampler)")
    gen = torch.Generator(device=model.device).manual_seed(cfg.seed if cfg.seed is not None else 0)
    known = source_images(model, cfg, gen)
    mask = build_mask(cfg.mask, known.shape, cfg.mask_fraction, gen)
    out = model.inpaint(known, torch.from_numpy(mask), generator=gen, jump_length=cfg.jump_length,
                        jump_n_sample=cfg.jump_n_sample).float().cpu().numpy()
    known = known.cpu().numpy()
    out_dir = output_dir(cfg)
    save_image_grid(known, str(out_dir / "input.png"), nrow=6)
    save_image_grid(known * mask, str(out_dir / "masked.png"), nrow=6)  # holes shown black
    save_image_grid(out, str(out_dir / "inpainted.png"), nrow=6)
    for i, img in enumerate(to_uint8(out)):
        (out_dir / f"inpainted_{i}.png").write_bytes(encode_png(img))
    log.info(f"Saved {out.shape[0]} inpainted images to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
