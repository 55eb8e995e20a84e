"""Full-reference image quality: PSNR and SSIM.

Counterpart of ``diffusion_model_nemo_tpu/metrics/image_quality.py`` on
tensors of either device: SSIM (Wang et al. 2004) with the standard
settings (an 11×11 Gaussian window of σ 1.5, K1 = 0.01, K2 = 0.03, 'valid'
borders) as five depthwise float32 convolutions over NHWC batches, with
TF32 off around them (cuDNN's default TF32 would move SSIM by about 1e-3
on the card). No kernel: the JAX package computes both with plain XLA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import no_tf32

__all__ = ["psnr", "ssim"]


def _float(a) -> torch.Tensor:
    return (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))).float()


def psnr(a, b, max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB of each image of two [B, H, W, C] batches on one scale → [B]."""
    a, b = _float(a), _float(b)
    mse = ((a - b) ** 2).mean(dim=tuple(range(1, a.ndim)))
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - (size - 1) / 2.0) / sigma) ** 2)
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Depthwise 'valid' convolution of [B, H, W, C] with a [k, k] window."""
    C = x.shape[-1]
    w = kern[None, None].expand(C, 1, *kern.shape)
    with no_tf32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, groups=C)
    return y.permute(0, 2, 3, 1)


def ssim(a, b, max_val: float = 1.0, window_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM of each image (Gaussian-windowed, 'valid' borders, as
    scikit-image's ``gaussian_weights=True``) of two [B, H, W, C] batches
    (H, W >= window_size) → [B]."""
    a, b = _float(a), _float(b)
    if a.shape != b.shape or a.ndim != 4:
        raise ValueError(f"ssim expects matching [B,H,W,C], got {tuple(a.shape)} vs {tuple(b.shape)}")
    if min(a.shape[1], a.shape[2]) < window_size:
        raise ValueError(f"image {a.shape[1]}x{a.shape[2]} smaller than the {window_size}-tap window")
    kern = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(a.device)
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    mu_a, mu_b = _filter(a, kern), _filter(b, kern)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = _filter(a * a, kern) - mu_aa
    var_b = _filter(b * b, kern) - mu_bb
    cov = _filter(a * b, kern) - mu_ab
    ssim_map = ((2.0 * mu_ab + c1) * (2.0 * cov + c2)) / ((mu_aa + mu_bb + c1) * (var_a + var_b + c2))
    return ssim_map.mean(dim=(1, 2, 3))
