"""Sample from a ScoreSDE archive with the port (counterpart of
``examples/score_sde/eval_score_sde.py``): the archive's predictor–corrector
sampler, another predictor / corrector, or the probability-flow ODE.

    python -m diffusion_model_nemo_tpu_torch.cli.eval_score_sde model_path=ScoreSDE.dmn \\
        batch_size=16 predictor=reverse_diffusion corrector=langevin
    python -m diffusion_model_nemo_tpu_torch.cli.eval_score_sde model_path=ScoreSDE.dmn \\
        use_probability_flow_sampler=true

Writes ``sample_<i>.png`` and ``samples_grid.png`` under ``output_dir``
(plus a timestamp directory unless ``add_timestamp=false``) and logs the
NFE. ``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ..models import ScoreSDE
from ..utils.image import encode_png, save_image_grid, to_uint8
from .common import hydra_runner
from .eval_ddpm import generator_of, output_dir

log = logging.getLogger(__name__)

PROBABILITY_FLOW = "diffusion_model_nemo.modules.ProbabilityFlowSampler"


@dataclass
class EvalConfig:
    model_path: str = "ScoreSDE.dmn"
    batch_size: int = 32
    image_size: int = -1

    # sampler override
    use_probability_flow_sampler: bool = False
    predictor: Optional[str] = None  # e.g. reverse_diffusion / euler_maruyama
    corrector: Optional[str] = None  # e.g. langevin / ald
    snr: float = 0.16
    n_steps: int = 1

    output_dir: str = "samples"
    add_timestamp: bool = True
    grid_plot: bool = True
    seed: Optional[int] = None
    use_ema: bool = True
    device: str = "cuda"


def maybe_change_sampler(model: ScoreSDE, cfg) -> None:
    """The JAX script's sampler override."""
    if cfg.use_probability_flow_sampler:
        model.change_sampler({"_target_": PROBABILITY_FLOW, "denoise": True})
    elif cfg.predictor is not None or cfg.corrector is not None:
        sampler_cfg = dict(model.cfg.sampler)
        sampler_cfg.update(predictor=cfg.predictor, corrector=cfg.corrector, snr=cfg.snr, n_steps=cfg.n_steps)
        model.change_sampler(sampler_cfg)


@hydra_runner(schema=EvalConfig)
def main(cfg):
    """Returns (the output directory, the NFE)."""
    cfg = EvalConfig(**cfg)
    model = ScoreSDE.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    maybe_change_sampler(model, cfg)
    image_size = cfg.image_size if cfg.image_size > 0 else int(model.image_size)
    imgs, nfe = model.sample(batch_size=cfg.batch_size, image_size=image_size,
                             generator=generator_of(model, cfg), return_nfe=True)
    nfe = int(nfe)
    imgs = imgs.float().cpu().numpy()
    out_dir = output_dir(cfg)
    if cfg.grid_plot:
        save_image_grid(imgs, str(out_dir / "samples_grid.png"), nrow=6)
    for i, img in enumerate(to_uint8(imgs)):
        (out_dir / f"sample_{i}.png").write_bytes(encode_png(img))
    log.info(f"Saved {imgs.shape[0]} samples to {out_dir} (NFE={nfe})")
    return out_dir, nfe


if __name__ == "__main__":
    main()
