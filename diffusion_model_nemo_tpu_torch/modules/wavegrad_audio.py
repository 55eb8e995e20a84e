"""WaveGrad's audio vocoder network (mel → waveform), channels-last 1-D.

Counterpart of ``diffusion_model_nemo_tpu/modules/wavegrad_audio.py``: a
DBlock chain downsamples the noisy waveform [B, T, 1]; a FiLM per stage
turns its features and the continuous noise level into (scale, shift); a
UBlock chain upsamples the mel features [B, F, n_mels] by the hop's
factors and is modulated by the FiLMs (deep to shallow), so that the
output is the predicted noise [B, F·hop, 1]. Every convolution is the
flax ``nn.Conv`` on [B, T, C] (``parts.Conv1d``, XLA's ``SAME`` padding
where flax has it); upsampling repeats each frame (``jnp.repeat``). As in
the JAX package, these are library convolutions: no TPU kernel stands
behind them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.registry import register_target
from .parts import Conv1d, noise_level_sinusoid, resolve_dtype

__all__ = ["NoiseLevelEncoding", "FiLM1D", "DBlock", "UBlock", "WaveGradVocoder"]


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class NoiseLevelEncoding(nn.Module):
    """The level's sinusoid [B, channels] (no parameters)."""

    def __init__(self, channels: int, scale: float = 5000.0):
        super().__init__()
        self.channels, self.scale = channels, scale

    def forward(self, level: torch.Tensor) -> torch.Tensor:
        return noise_level_sinusoid(level, self.channels, self.scale)


class FiLM1D(nn.Module):
    """(scale, shift) from a DBlock's features and the noise level; the
    encoding is cast to the features' dtype before the add, as in flax."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.signal_conv = Conv1d(in_channels, in_channels, 3, padding=1, dtype=dtype)
        self.level_enc = NoiseLevelEncoding(in_channels)
        self.scale_conv = Conv1d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.shift_conv = Conv1d(in_channels, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, level: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = _leaky(self.signal_conv(x))
        h = h + self.level_enc(level).to(h.dtype)[:, None, :]
        return self.scale_conv(h), self.shift_conv(h)


class DBlock(nn.Module):
    """Waveform downsampling by ``factor``: a strided 1-wide residual, and
    three LeakyReLU + k3 convs (stride ``factor`` first, then dilations 2
    and 4)."""

    def __init__(self, in_channels: int, out_channels: int, factor: int, dtype=torch.float32):
        super().__init__()
        self.res = Conv1d(in_channels, out_channels, 1, stride=factor, dtype=dtype)
        self.conv0 = Conv1d(in_channels, out_channels, 3, stride=factor, dtype=dtype)
        self.conv1 = Conv1d(out_channels, out_channels, 3, dilation=2, dtype=dtype)
        self.conv2 = Conv1d(out_channels, out_channels, 3, dilation=4, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for conv in (self.conv0, self.conv1, self.conv2):
            h = conv(_leaky(h))
        return h + self.res(x)


class UBlock(nn.Module):
    """Feature upsampling by ``factor`` (each frame repeated), with two
    FiLM-modulated dilated stages."""

    def __init__(self, in_channels: int, out_channels: int, factor: int, dilations: Sequence[int] = (1, 2, 4, 8),
                 dtype=torch.float32):
        super().__init__()
        self.factor = factor
        self.res = Conv1d(in_channels, out_channels, 1, dtype=dtype)
        self.conv0 = Conv1d(in_channels, out_channels, 3, dilation=dilations[0], dtype=dtype)
        self.conv1 = Conv1d(out_channels, out_channels, 3, dilation=dilations[1], dtype=dtype)
        self.conv2 = Conv1d(out_channels, out_channels, 3, dilation=dilations[2], dtype=dtype)
        self.conv3 = Conv1d(out_channels, out_channels, 3, dilation=dilations[3], dtype=dtype)

    def forward(self, x: torch.Tensor, film: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        scale, shift = film
        up = x.repeat_interleave(self.factor, dim=1)
        h = self.conv0(_leaky(up))
        h = scale * h + shift
        h = self.conv1(_leaky(h)) + self.res(up)
        res2 = h
        h = self.conv2(_leaky(scale * h + shift))
        h = self.conv3(_leaky(scale * h + shift))
        return h + res2


@register_target("diffusion_model_nemo.modules.WaveGradVocoder", "diffusion_model_nemo_tpu.modules.WaveGradVocoder")
class WaveGradVocoder(nn.Module):
    """Mel → waveform denoiser conditioned on the continuous noise level:
    ``forward(y_noisy [B, T, 1], noise_level [B, 1, 1] or [B], mel [B,
    frames, n_mels])`` → the predicted noise [B, T, 1] float32, T = frames
    · hop; ``prod(upsample_factors)`` must equal ``hop``."""

    def __init__(
        self,
        n_mels: int = 80,
        hop: int = 300,
        upsample_factors: Sequence[int] = (5, 5, 3, 2, 2),
        up_channels: Sequence[int] = (512, 512, 256, 128, 128),
        down_channels: Sequence[int] = (128, 128, 256, 512),
        base_channels: int = 32,
        dtype: str = "float32",
    ):
        super().__init__()
        factors = tuple(int(f) for f in upsample_factors)
        if int(np.prod(factors)) != int(hop):
            raise ValueError(f"prod(upsample_factors)={int(np.prod(factors))} must equal hop={hop}")
        dt = resolve_dtype(dtype)
        self.dtype, self.n_mels, self.hop = dt, int(n_mels), int(hop)
        up_channels, down_channels = list(up_channels), list(down_channels)
        self.d_stem = Conv1d(1, base_channels, 5, dtype=dt)
        feats = [base_channels]
        down_factors = list(reversed(factors))[:-1]  # the stages between FiLMs
        self.n_down = len(list(zip(down_channels, down_factors)))
        for i, (ch, f) in enumerate(zip(down_channels, down_factors)):
            self.add_module(f"dblock_{i}", DBlock(feats[-1], ch, f, dt))
            feats.append(ch)
        # A FiLM per stage, deep to shallow, each matched to its UBlock's rate.
        self.n_film = len(feats)
        for i, c in enumerate(reversed(feats)):
            self.add_module(f"film_{i}", FiLM1D(c, up_channels[i], dt))
        self.u_stem = Conv1d(self.n_mels, up_channels[0], 3, dtype=dt)
        c = up_channels[0]
        self.n_up = len(list(zip(up_channels, factors)))
        for i, (ch, f) in enumerate(zip(up_channels, factors)):
            self.add_module(f"ublock_{i}", UBlock(c, ch, f, dtype=dt))
            c = ch
        self.out_conv = Conv1d(c, 1, 3, dtype=dt)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """lecun-normal kernels and zero biases, drawn from ``generator`` in
        module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, y: torch.Tensor, noise_level: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        y, mel = y.to(self.dtype), mel.to(self.dtype)
        h = self.d_stem(y)
        feats = [h]
        for i in range(self.n_down):
            h = getattr(self, f"dblock_{i}")(h)
            feats.append(h)
        films = [getattr(self, f"film_{i}")(f, noise_level) for i, f in enumerate(reversed(feats))]
        x = self.u_stem(mel)
        for i in range(self.n_up):
            x = getattr(self, f"ublock_{i}")(x, films[i])
        return self.out_conv(x).float()
