"""Serve an archive of any ported family (DDPM, ImprovedDDPM,
ConditionalDDPM, TextConditionalDDPM, ScoreSDE, WavegradDDPM, the WaveGrad
vocoder, ...) as a batched sampling daemon with the port
(counterpart of ``examples/serve.py``; the archive's recorded class is
restored through ``restore_model_from_archive``).

    python -m diffusion_model_nemo_tpu_torch.cli.serve model_path=DDPM.dmn \\
        port=8000 max_batch=64 use_ddim_sampler=true ddim_timesteps=50

    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/sample -d '{"num_images": 4, "seed": 0, "format": "png"}'
    curl -s -X POST localhost:8000/sample -d '{"num_images": 4, "label": 3, "guidance_scale": 3.0}'
    # a TextConditionalDDPM archive takes prompts (requests with different prompts share a batch):
    curl -s -X POST localhost:8000/sample -d '{"num_images": 4, "text": "a photo of class 3",
        "guidance_scale": 3.0, "negative_text": "a photo of class 5"}'
    # POST /edit {"images_npy": <base64 of np.save'd [N, H, W, C]>, "strength": 0.5, "seed": 0}

    ... use_dpm_solver=true dpm_steps=20   # or use_karras_sampler / use_unipc (UniPC > Karras > DPM > DDIM)

The fields are those of the JAX script's ``ServeConfig`` that the port's
server has; ``device=cpu`` serves from the CPU. A ScoreSDE archive needs
``use_ddim_sampler=false`` (it serves with its own predictor–corrector
sampler; the DDIM swap raises, as in the JAX script), and so does a vocoder
archive, which serves ``POST /vocode`` only:

    python -m diffusion_model_nemo_tpu_torch.cli.serve model_path=Wavegrad-Vocoder.dmn \
        use_ddim_sampler=false max_batch=8 [mel_frames=24]
    # POST /vocode {"mel_npy": <base64 of np.save'd [N, mel_frames, n_mels] float32>, "seed": 0}
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..serving import serve
from .common import hydra_runner

__all__ = ["ServeConfig", "build_server", "main"]


@dataclass
class ServeConfig:
    model_path: str = "DDPM.dmn"
    host: str = "127.0.0.1"
    port: int = 8000
    max_batch: int = 64
    linger_ms: float = 5.0
    use_ema: bool = True
    base_seed: int = 0
    use_ddim_sampler: bool = True
    ddim_timesteps: int = 50
    ddim_eta: float = 0.0
    use_dpm_solver: bool = False  # DPM-Solver++(2M): overrides DDIM when true
    dpm_steps: int = 20
    dpm_order: int = 2
    dpm_time_spacing: str = "strided"
    use_karras_sampler: bool = False  # EDM Heun / churn: overrides both when true
    karras_steps: int = 18
    karras_order: int = 2
    karras_s_churn: float = 0.0
    use_unipc: bool = False  # UniPC predictor-corrector: overrides all when true
    unipc_steps: int = 20
    unipc_order: int = 2
    unipc_corrector: bool = True
    image_size: Optional[int] = None
    mel_frames: Optional[int] = None
    device: str = "cuda"


@hydra_runner(schema=ServeConfig)
def build_server(cfg):
    """The warmed-up server for ``argv`` (not listening yet)."""
    cfg = ServeConfig(**cfg)
    return serve(
        cfg.model_path, host=cfg.host, port=cfg.port, max_batch=cfg.max_batch,
        linger_ms=cfg.linger_ms, use_ema=cfg.use_ema, use_ddim_sampler=cfg.use_ddim_sampler,
        ddim_timesteps=cfg.ddim_timesteps, ddim_eta=cfg.ddim_eta, use_dpm_solver=cfg.use_dpm_solver,
        dpm_steps=cfg.dpm_steps, dpm_order=cfg.dpm_order, dpm_time_spacing=cfg.dpm_time_spacing,
        use_karras_sampler=cfg.use_karras_sampler, karras_steps=cfg.karras_steps, karras_order=cfg.karras_order,
        karras_s_churn=cfg.karras_s_churn, use_unipc=cfg.use_unipc, unipc_steps=cfg.unipc_steps,
        unipc_order=cfg.unipc_order, unipc_corrector=cfg.unipc_corrector, base_seed=cfg.base_seed,
        image_size=cfg.image_size, device=cfg.device, mel_frames=cfg.mel_frames,
    )


def main(argv=None):
    build_server(argv).serve_forever()


if __name__ == "__main__":
    main()
