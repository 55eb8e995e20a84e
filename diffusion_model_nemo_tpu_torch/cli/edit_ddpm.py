"""SDEdit image-to-image from a DDPM-family archive with the port
(counterpart of ``examples/ddpm/edit_ddpm.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.edit_ddpm model_path=DDPM.dmn \\
        input_path=images.npy strength=0.5 output_dir=edited

Inputs as in ``inpaint_ddpm`` (a ``.npy`` / ``.npz`` file or an image
directory, or nothing: the sources are sampled from the model). ``strength`` in [0, 1] is the share
of the reverse chain run again: low keeps the structure, high re-imagines.
The ancestral partial chain runs whatever sampler the archive names.
Writes ``input.png``, ``edited.png`` and ``edited_<i>.png`` under
``output_dir``. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import torch

from ..models import restore_model_from_archive
from ..utils.image import encode_png, save_image_grid, to_uint8
from .common import hydra_runner
from .eval_ddpm import output_dir
from .inpaint_ddpm import source_images

log = logging.getLogger(__name__)


@dataclass
class EditConfig:
    model_path: str = "DDPM.dmn"
    input_path: str = ""  # .npy / .npz / image directory; "" = sample from the model
    batch_size: int = 8
    strength: float = 0.5  # share of the reverse chain run again

    output_dir: str = "edited"
    add_timestamp: bool = True
    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=EditConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = EditConfig(**cfg)
    model = restore_model_from_archive(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if not hasattr(model, "edit"):
        raise ValueError(f"{type(model).__name__} has no edit surface (SDEdit needs a DDPM-family "
                         "ancestral sampler)")
    gen = torch.Generator(device=model.device).manual_seed(cfg.seed if cfg.seed is not None else 0)
    src = source_images(model, cfg, gen)
    out = model.edit(src, strength=cfg.strength, generator=gen).float().cpu().numpy()
    out_dir = output_dir(cfg)
    save_image_grid(src.cpu().numpy(), str(out_dir / "input.png"), nrow=6)
    save_image_grid(out, str(out_dir / "edited.png"), nrow=6)
    for i, img in enumerate(to_uint8(out)):
        (out_dir / f"edited_{i}.png").write_bytes(encode_png(img))
    log.info(f"Saved {out.shape[0]} edited images (strength={cfg.strength}) to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
