"""Audio features for the WaveGrad vocoder: framing, STFT magnitude, the mel
filterbank and log-mel.

Counterpart of ``diffusion_model_nemo_tpu/ops/audio.py``: centered frames
with reflection padding, a periodic Hann window, the rFFT magnitude
(``torch.fft.rfft``, on the card cuFFT), the HTK mel filterbank built on
the host in numpy (the JAX package's code, copied) and log compression with
a floor. The features run on the tensors' device; the filterbank is a
constant the caller keeps.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["hann_window", "stft_magnitude", "mel_filterbank", "log_mel_spectrogram"]


def hann_window(win_length: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def _frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[B, T] → [B, F, frame_length], frames centred by reflection padding."""
    pad = frame_length // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(1, frame_length, hop)


def stft_magnitude(x: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                   win_length: Optional[int] = None) -> torch.Tensor:
    """[B, T] waveform → [B, F, n_fft // 2 + 1] magnitude spectrogram."""
    win_length = win_length or n_fft
    frames = _frame(x, win_length, hop) * hann_window(win_length, x.device)
    if win_length < n_fft:
        frames = F.pad(frames, (0, n_fft - win_length))
    return torch.fft.rfft(frames, n=n_fft, dim=-1).abs()


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int = 80, n_fft: int = 1024, sample_rate: int = 24000, fmin: float = 0.0,
                   fmax: Optional[float] = None, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """[n_fft // 2 + 1, n_mels] triangular HTK mel filterbank (float32,
    built on the host)."""
    fmax = fmax or sample_rate / 2
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_bins)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return torch.from_numpy(fb).to(device)


def log_mel_spectrogram(x: torch.Tensor, mel_fb: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                        win_length: Optional[int] = None, floor: float = 1e-5) -> torch.Tensor:
    """[B, T] waveform → [B, F, n_mels] log-mel features."""
    mel = stft_magnitude(x, n_fft=n_fft, hop=hop, win_length=win_length) @ mel_fb
    return torch.log(mel.clamp(min=floor))
