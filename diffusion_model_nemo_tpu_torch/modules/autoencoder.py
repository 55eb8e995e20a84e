"""KL-regularized convolutional autoencoder: the first stage of latent diffusion.

Counterpart of ``diffusion_model_nemo_tpu/modules/autoencoder.py``
(Rombach et al. 2022's ``AutoencoderKL`` on this repo's part set, NHWC):
stem 3×3 conv → per level two ``ResnetBlock`` (no time input) and a strided
``Downsample`` on all but the last level → mid [block, full attention,
block] → GroupNorm/SiLU → 3×3 conv to 2·z channels, the moments cast to
float32 before the split into (mean, logvar). The decoder mirrors it with
the transposed-conv ``Upsample`` and returns float32. The downsample factor
is 2^(len(dim_mults) − 1).

The parts are the U-Net's, so the kernels dispatch here as there: every
GroupNorm+SiLU is kernel #1 and the mid attention the bottleneck
attention-block kernel #4 (N ≤ 64), else the plain path (or #7 where
1024 ≤ N ≤ 4096). Module names are the flax ones (``encoder/down_0_block1``,
``decoder/up_1_upsample``, ...), so ``utils/weights.py`` carries the nested
flax tree both ways.

The posterior draw takes an injected ε (``eps=None``: the mode, the mean
unclipped); only the draw and the KL clip logvar to ``LOGVAR_CLIP``.
Dropout, where configured, takes injected keep masks keyed by site
(``encoder/<block>/block2``, ``decoder/<block>/block2``; ``dropout_shapes``),
as the U-Net's do; without masks the forward is the deterministic one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config.registry import register_target
from .parts import Conv2d, Downsample, FusedGroupNormSiLU, ResnetBlock, SelfAttentionBlock, Upsample, resolve_dtype

__all__ = ["AutoencoderKL", "Encoder", "Decoder", "diagonal_gaussian_sample", "diagonal_gaussian_kl", "LOGVAR_CLIP"]

# LDM clamps the encoder's logvar to [-30, 20] before exp() so early-training
# outliers cannot overflow the posterior std in float32.
LOGVAR_CLIP = (-30.0, 20.0)

Masks = Optional[Dict[str, torch.Tensor]]


def diagonal_gaussian_sample(mean: torch.Tensor, logvar: torch.Tensor, eps: Optional[torch.Tensor]) -> torch.Tensor:
    """z = μ + σ·ε with the caller's ε ~ N(0, I); ``eps=None`` → the mode μ."""
    if eps is None:
        return mean
    logvar = logvar.clamp(*LOGVAR_CLIP)
    return mean + torch.exp(0.5 * logvar) * eps


def diagonal_gaussian_kl(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(μ, σ²) ‖ N(0, I)) summed over the latent dims → [B] (LDM's
    per-sample sum, against which ``kl_weight`` ≈ 1e-6 is set)."""
    logvar = logvar.clamp(*LOGVAR_CLIP)
    return 0.5 * (mean.square() + logvar.exp() - 1.0 - logvar).sum(dim=tuple(range(1, mean.ndim)))


class _Stage(nn.Module):
    """What the encoder and the decoder share: ResNet blocks (no time
    input), each called with its dropout site's mask."""

    def _block(self, c_in: int, c_out: int) -> ResnetBlock:
        return ResnetBlock(c_in, c_out, None, self.groups, "bn_act_conv", self.dtype, dropout=self.dropout)

    def _run(self, name: str, x: torch.Tensor, masks: Masks) -> torch.Tensor:
        return getattr(self, name)(x, None, (masks or {}).get(f"{name}/block2"))


class Encoder(_Stage):
    """Image [B, S, S, channels] → (mean, logvar), each [B, S/f, S/f, z] float32."""

    def __init__(self, dim: int, dim_mults: Sequence[int] = (1, 2, 4), z_channels: int = 4, channels: int = 3,
                 resnet_block_groups: int = 8, dropout: Optional[float] = None, dtype="float32"):
        super().__init__()
        self.dtype, self.groups, self.dropout = resolve_dtype(dtype), resnet_block_groups, dropout
        self.dims: List[int] = [dim * m for m in dim_mults]
        dims, dt = self.dims, self.dtype
        self.stem = Conv2d(channels, dims[0], 3, padding=1, dtype=dt)
        c = dims[0]
        for ind, dim_out in enumerate(dims):
            setattr(self, f"down_{ind}_block1", self._block(c, dim_out))
            setattr(self, f"down_{ind}_block2", self._block(dim_out, dim_out))
            c = dim_out
            if ind < len(dims) - 1:
                setattr(self, f"down_{ind}_downsample", Downsample(dim_out, dt))
        self.mid_block1 = self._block(c, c)
        self.mid_attn = SelfAttentionBlock(c, linear=False, dtype=dt)
        self.mid_block2 = self._block(c, c)
        self.out_norm = FusedGroupNormSiLU(c, resnet_block_groups, 1e-5, dt)
        self.out_conv = Conv2d(c, 2 * z_channels, 3, padding=1, dtype=dt)

    def block_sites(self, size: int) -> Dict[str, Tuple[int, int]]:
        """{block name: (spatial size, channels) of its output} at image size ``size``."""
        out = {}
        for ind, d in enumerate(self.dims):
            out[f"down_{ind}_block1"] = out[f"down_{ind}_block2"] = (size >> ind, d)
        last = (size >> (len(self.dims) - 1), self.dims[-1])
        out["mid_block1"] = out["mid_block2"] = last
        return out

    def forward(self, x: torch.Tensor, dropout_masks: Masks = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.stem(x.to(self.dtype))
        for ind in range(len(self.dims)):
            x = self._run(f"down_{ind}_block1", x, dropout_masks)
            x = self._run(f"down_{ind}_block2", x, dropout_masks)
            if ind < len(self.dims) - 1:
                x = getattr(self, f"down_{ind}_downsample")(x)
        x = self._run("mid_block1", x, dropout_masks)
        x = self.mid_attn(x)
        x = self._run("mid_block2", x, dropout_masks)
        moments = self.out_conv(self.out_norm(x)).float()
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar


class Decoder(_Stage):
    """Latent [B, S/f, S/f, z] → image [B, S, S, channels] float32 (in [-1, 1])."""

    def __init__(self, dim: int, dim_mults: Sequence[int] = (1, 2, 4), z_channels: int = 4, channels: int = 3,
                 resnet_block_groups: int = 8, dropout: Optional[float] = None, dtype="float32"):
        super().__init__()
        self.dtype, self.groups, self.dropout = resolve_dtype(dtype), resnet_block_groups, dropout
        self.dims: List[int] = [dim * m for m in dim_mults]
        dims, dt = self.dims, self.dtype
        c = dims[-1]
        self.stem = Conv2d(z_channels, c, 3, padding=1, dtype=dt)
        self.mid_block1 = self._block(c, c)
        self.mid_attn = SelfAttentionBlock(c, linear=False, dtype=dt)
        self.mid_block2 = self._block(c, c)
        for ind, dim_out in enumerate(reversed(dims)):
            setattr(self, f"up_{ind}_block1", self._block(c, dim_out))
            setattr(self, f"up_{ind}_block2", self._block(dim_out, dim_out))
            c = dim_out
            if ind < len(dims) - 1:
                setattr(self, f"up_{ind}_upsample", Upsample(dim_out, dt))
        self.out_norm = FusedGroupNormSiLU(c, resnet_block_groups, 1e-5, dt)
        self.out_conv = Conv2d(c, channels, 3, padding=1, dtype=dt)

    def block_sites(self, size: int) -> Dict[str, Tuple[int, int]]:
        """{block name: (spatial size, channels) of its output} at image size ``size``."""
        last = len(self.dims) - 1
        out = {"mid_block1": (size >> last, self.dims[-1]), "mid_block2": (size >> last, self.dims[-1])}
        for ind, d in enumerate(reversed(self.dims)):
            out[f"up_{ind}_block1"] = out[f"up_{ind}_block2"] = (size >> (last - ind), d)
        return out

    def forward(self, z: torch.Tensor, dropout_masks: Masks = None) -> torch.Tensor:
        x = self.stem(z.to(self.dtype))
        x = self._run("mid_block1", x, dropout_masks)
        x = self.mid_attn(x)
        x = self._run("mid_block2", x, dropout_masks)
        for ind in range(len(self.dims)):
            x = self._run(f"up_{ind}_block1", x, dropout_masks)
            x = self._run(f"up_{ind}_block2", x, dropout_masks)
            if ind < len(self.dims) - 1:
                x = getattr(self, f"up_{ind}_upsample")(x)
        return self.out_conv(self.out_norm(x)).float()


def _sub(masks: Masks, prefix: str) -> Masks:
    """The masks under ``prefix/``, with the prefix taken off."""
    if not masks:
        return None
    n = len(prefix) + 1
    return {k[n:]: v for k, v in masks.items() if k.startswith(prefix + "/")}


@register_target("diffusion_model_nemo_tpu.modules.AutoencoderKL", "diffusion_model_nemo.modules.AutoencoderKL")
class AutoencoderKL(nn.Module):
    """Encoder + diagonal-Gaussian posterior + decoder. ``encode`` /
    ``decode`` apply each half; ``forward(x, eps)`` returns
    (reconstruction, posterior mean, posterior logvar), decoding the draw
    with ``eps`` (the mode without)."""

    def __init__(self, dim: int = 64, dim_mults: Sequence[int] = (1, 2, 4), z_channels: int = 4, channels: int = 3,
                 resnet_block_groups: int = 8, dropout: Optional[float] = None, dtype="float32"):
        super().__init__()
        self.dim, self.dim_mults = int(dim), tuple(int(m) for m in dim_mults)
        self.z_channels, self.channels = int(z_channels), int(channels)
        self.resnet_block_groups, self.dropout, self.dtype = int(resnet_block_groups), dropout, resolve_dtype(dtype)
        kw = dict(dim=self.dim, dim_mults=self.dim_mults, z_channels=self.z_channels, channels=self.channels,
                  resnet_block_groups=self.resnet_block_groups, dropout=dropout, dtype=dtype)
        self.encoder = Encoder(**kw)
        self.decoder = Decoder(**kw)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.dim_mults) - 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """lecun-normal kernels, zero biases, unit norm scales (flax's
        initialisers), drawn from ``generator`` in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def dropout_shapes(self, shape: Sequence[int]) -> Dict[str, Tuple[int, ...]]:
        """{site: the keep mask's shape} for images of ``shape`` [B, S, S, C]
        (none without dropout): each ResNet block's ``block2`` output."""
        if not self.dropout:
            return {}
        B, S = shape[0], shape[1]
        out = {}
        for prefix, stage in (("encoder", self.encoder), ("decoder", self.decoder)):
            for name, (s, c) in stage.block_sites(S).items():
                out[f"{prefix}/{name}/block2"] = (B, s, s, c)
        return out

    def encode(self, x: torch.Tensor, dropout_masks: Masks = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(x, _sub(dropout_masks, "encoder"))

    def decode(self, z: torch.Tensor, dropout_masks: Masks = None) -> torch.Tensor:
        return self.decoder(z, _sub(dropout_masks, "decoder"))

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                dropout_masks: Masks = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean, logvar = self.encode(x, dropout_masks)
        rec = self.decode(diagonal_gaussian_sample(mean, logvar, eps), dropout_masks)
        return rec, mean, logvar
