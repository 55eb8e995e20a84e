"""WaveGrad neural vocoder: mel-conditioned waveform diffusion.

Counterpart of ``diffusion_model_nemo_tpu/models/wavegrad_vocoder.py``:
``WaveGradDiffusion`` (continuous √ᾱ level, re-schedulable sampling) on
[B, T, 1] waveforms, ``WaveGradVocoder`` as the network, and log-mel
features computed inside the training step from the raw waveform batch
(``ops/audio.py``). The step's draws (the level's ``s`` and ``u``, the
noise) come in as tensors, as for the image models. ``vocode`` runs the
sampler's ancestral chain (on CUDA as replays of one captured step) with
the mel features bound to the network as a ``Conditioned`` model function,
whose tensors a captured chain holds as static buffers. The JAX package's
mesh-sharded synthesis (``mesh=``) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..config.registry import register_target
from ..modules.gaussian_diffusion import Conditioned
from ..modules.parts import not_ported
from ..modules.wavegrad_diffusion import WaveGradDiffusion
from ..ops.audio import log_mel_spectrogram, mel_filterbank
from .ddpm import DDPM

__all__ = ["WavegradVocoderModel"]


@register_target("diffusion_model_nemo.models.WavegradVocoderModel",
                 "diffusion_model_nemo_tpu.models.WavegradVocoderModel")
class WavegradVocoderModel(DDPM):
    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        assert isinstance(self.sampler, WaveGradDiffusion), "WavegradVocoderModel requires a WaveGradDiffusion sampler"
        audio = self.cfg.get("audio") or {}
        self.sample_rate = int(audio.get("sample_rate", 24000))
        self.n_fft = int(audio.get("n_fft", 1024))
        self.hop = int(audio.get("hop", 300))
        self.n_mels = int(audio.get("n_mels", 80))
        self.segment_frames = int(audio.get("segment_frames", 24))
        self.mel_fb = mel_filterbank(n_mels=self.n_mels, n_fft=self.n_fft, sample_rate=self.sample_rate,
                                     device=self.device)

    @property
    def segment_length(self) -> int:
        return self.segment_frames * self.hop

    def compute_mel(self, waveform: torch.Tensor) -> torch.Tensor:
        """[B, T] → [B, T // hop, n_mels] log-mel."""
        mel = log_mel_spectrogram(waveform, self.mel_fb.to(waveform.device), n_fft=self.n_fft, hop=self.hop)
        return mel[:, : waveform.shape[1] // self.hop, :]

    def vocoder_fn(self, params, y: torch.Tensor, level: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        """The network with ``params``, autograd on where it is on."""
        return functional_call(self.diffusion_model, params, (y, level, mel))

    def _inference_fn(self, params, y, level, mel):
        with torch.inference_mode():
            return self.vocoder_fn(params, y, level, mel)

    # ---- training ------------------------------------------------------------
    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One step's draws for waveforms of ``shape`` [B, T]: the level's
        s ~ U{1 … T} and u ~ U[0, 1), and the noise [B, T, 1]."""
        B, dev = shape[0], self.device
        return {
            "s": torch.randint(1, self.sampler.timesteps + 1, (B,), generator=generator, device=dev,
                               dtype=torch.int32),
            "u": torch.rand((B,), generator=generator, device=dev),
            "noise": torch.randn((*tuple(shape), 1), generator=generator, device=dev, dtype=torch.float32),
        }

    def training_step(self, params, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A raw waveform batch ``{"audio": [B, T]}`` in [-1, 1] → the loss of
        the predicted noise at a continuous level, the mel computed here."""
        self._check_training_options()
        wav = batch["audio"]
        wav = (wav if torch.is_tensor(wav) else torch.as_tensor(np.asarray(wav))).to(self.device, torch.float32)
        B = wav.shape[0]
        mel = self.compute_mel(wav)
        level = self.sampler.sample_continuous_noise_level(draws["s"], draws["u"]).reshape(B, 1, 1)
        y_noisy = self.sampler.q_sample_continuous(wav[..., None], level, draws["noise"])
        loss = self.loss(input=self.vocoder_fn(params, y_noisy, level, mel), target=draws["noise"])
        return loss, {"train_loss": loss}

    # ---- synthesis -----------------------------------------------------------
    def vocode(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None, use_ema: bool = False,
               mesh=None, shard_axis: str = "batch", graphs: Optional[bool] = None) -> torch.Tensor:
        """[B, F, n_mels] log-mel → [B, F·hop] waveform through the
        sampler's (possibly re-scheduled) ancestral chain; the draws come
        from ``generator`` (default seeded 0)."""
        if mesh is not None or shard_axis != "batch":
            raise not_ported("WavegradVocoderModel.vocode", "mesh= / shard_axis=", "parallelism")
        mel = torch.as_tensor(mel).to(self.device, torch.float32)
        B, frames, _ = mel.shape
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = self.ema_params if use_ema else self.params
        model_fn = Conditioned(self._inference_fn, {"mel": mel})
        with torch.inference_mode():
            out = self.sampler.p_sample_loop(model_fn, params, (B, frames * self.hop, 1), generator,
                                             unnormalize=False, graphs=graphs)
        return out[..., 0]

    def sample(self, batch_size: int, image_size: int = 0, generator=None, mel=None, **kwargs):
        """A waveform per mel input; ``mel`` is required."""
        if mel is None:
            raise ValueError("WavegradVocoderModel.sample requires mel=")
        return self.vocode(mel, generator=generator, **kwargs)

    def _save_image_step(self, batch_size: int, step: int):
        return None  # an audio model dumps no image grid

    def interpolate(self, *args, **kwargs):
        raise NotImplementedError()
