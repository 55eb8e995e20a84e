"""Prompted sampling from a TextConditionalDDPM archive with the port
(counterpart of ``examples/dit/sample_text_dit.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.sample_text_dit \\
        model_path=TextDDPM-DiT.dmn text="a photo of class 3" guidance_scale=3.0 \\
        batch_size=16 use_ddim_sampler=true ddim_timesteps=50

``text`` ("" = the null context), ``negative_text`` (the guidance anchor;
needs guidance), ``guidance_scale`` (<= 0: none), ``context_npy`` (an
``.npy`` float context [B|1, L, D] or [L, D] from an outside text encoder
in place of the prompts; [1, L, D] is repeated over the batch). The
model's own sampler unless ``use_ddim_sampler``. Writes ``sample_<i>.png``
and ``samples_grid.png`` under ``output_dir``; ``device=cpu`` runs on the
CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..models import TextConditionalDDPM, restore_model_from_archive
from ..utils.image import encode_png, save_image_grid, to_uint8
from .common import hydra_runner
from .eval_ddpm import generator_of, maybe_use_ddim_sampler, output_dir

log = logging.getLogger(__name__)


@dataclass
class SampleTextConfig:
    model_path: str = "TextDDPM-DiT.dmn"
    text: str = ""  # "" = the null context
    negative_text: str = ""  # the guidance anchor (needs guidance)
    context_npy: str = ""  # a float context [B|1, L, D] or [L, D] (replaces text)
    guidance_scale: float = -1.0  # <= 0: no guidance
    batch_size: int = 16
    image_size: int = -1

    use_ddim_sampler: bool = False
    ddim_eta: float = 0.0
    ddim_timesteps: int = 50

    output_dir: str = "samples"
    add_timestamp: bool = True
    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


@hydra_runner(schema=SampleTextConfig)
def main(cfg):
    """Returns the output directory."""
    cfg = SampleTextConfig(**cfg)
    model = restore_model_from_archive(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if not isinstance(model, TextConditionalDDPM):
        raise ValueError(f"{cfg.model_path} is a {type(model).__name__} archive; sample_text_dit needs a "
                         "TextConditionalDDPM")
    maybe_use_ddim_sampler(model, cfg)
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    w = cfg.guidance_scale if cfg.guidance_scale > 0 else None
    context = None
    if cfg.context_npy:
        context = np.load(cfg.context_npy, allow_pickle=False)
        if context.ndim == 3 and context.shape[0] == 1:
            context = np.tile(context, (cfg.batch_size, 1, 1))
    imgs = model.sample(batch_size=cfg.batch_size, image_size=image_size, generator=generator_of(model, cfg),
                        text=cfg.text or None, guidance_scale=w, negative_text=cfg.negative_text or None,
                        context=context)
    imgs = imgs.float().cpu().numpy()
    out_dir = output_dir(cfg)
    save_image_grid(imgs, str(out_dir / "samples_grid.png"), nrow=4)
    for i, img in enumerate(to_uint8(imgs)):
        (out_dir / f"sample_{i}.png").write_bytes(encode_png(img))
    what = f"external context {cfg.context_npy!r}" if cfg.context_npy else f"prompt {cfg.text!r}"
    log.info(f"Saved {imgs.shape[0]} samples for {what} (guidance={w}) to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
