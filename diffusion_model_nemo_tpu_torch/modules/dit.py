"""DiT — Diffusion Transformer backbone (PyTorch, NHWC in and out).

Counterpart of ``diffusion_model_nemo_tpu/modules/dit.py``: patchify stem
(a strided conv), fixed 2-D sin-cos position embeddings, pre-LN transformer
blocks conditioned by adaLN-Zero (per-block shift / scale / gate regressed
from the time embedding; zero-initialised, so a fresh network outputs
exactly zero), a zero-initialised linear head and the unpatchify. Same call
contract as the U-Net: ``forward(x, time)`` with x [B, H, W, C], float32
out of the same spatial shape (2x channels under ``learned_variance``).
Submodules carry the flax names (``patch_embed``, ``time_dense0``,
``block_3.qkv``, ``final_linear``, ...), so ``utils/weights.py`` carries a
flax tree over one to one. The attention core is ``ops/attention.py:
fused_attention`` (the Hopper kernel at 1024 ≤ N ≤ 4096 on CUDA).

``num_classes = K`` adds ``class_embed`` [K + 1, dim], added to the
conditioning vector c after ``time_dense1``; ``classes=None`` is the null
class K, whose row here is learned (the DiT paper's convention), unlike the
U-Net's zero row.

``dropout`` acts in training only, on the self-attention output and the MLP
output of each block (flax sites ``block_<i>/Dropout_0`` and
``block_<i>/Dropout_1``), through injected keep masks (``dropout_shapes``);
with no masks the forward is the deterministic one.

``aug_dim = D`` adds ``aug_embed``, a zero-initialised no-bias Dense [D →
dim] on the augmentation descriptor ``aug_cond`` [B, D] (None = zeros),
added to c after the class embedding, as in the JAX DiT.

Options of the JAX DiT that later slices bring raise
``NotImplementedError``: mixture-of-experts MLPs, cross-attention context
and sequence parallelism.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.registry import register_target
from ..ops import attention as A
from .parts import (
    Conv2d, Dense, Embed, SinusoidalPositionEmbeddings, dropout, not_ported, remat_call, resolve_dtype,
)

__all__ = ["DiT", "DiTBlock", "sincos_position_embedding_2d", "depth_to_space"]


def sincos_position_embedding_2d(h: int, w: int, dim: int) -> np.ndarray:
    """Fixed 2-D sin-cos table ``[h*w, dim]``: half the channels encode the
    row, half the column, each a 1-D sin‖cos sinusoid of base 10000."""
    if dim % 4:
        raise ValueError(f"DiT position embedding needs dim % 4 == 0, got {dim}")
    half = dim // 2

    def emb_1d(pos: np.ndarray) -> np.ndarray:  # [M] -> [M, half]
        quarter = half // 2
        freq = np.exp(-math.log(10000.0) * np.arange(quarter) / quarter)
        ang = pos[:, None] * freq[None, :]
        return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)

    gy, gx = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    return np.concatenate([emb_1d(gy.reshape(-1)), emb_1d(gx.reshape(-1))], axis=-1).astype(np.float32)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, h, w, r·r·C] → [B, h·r, w·r, C], channels (r, r, C)-contiguous."""
    B, h, w, rrC = x.shape
    C = rrC // (r * r)
    x = x.reshape(B, h, w, r, r, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h * r, w * r, C)


def _layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """flax ``LayerNorm(use_bias=False, use_scale=False)``: float32 one-pass
    statistics E[x²] − E[x]² clipped at zero, result cast to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _modulate(h: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return h * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero conditioning."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, dtype=torch.float32,
                 dropout: Optional[float] = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.dim, self.heads, self.head_dim = dim, heads, dim // heads
        self.dropout = float(dropout or 0.0)
        dt = resolve_dtype(dtype)
        hidden = int(dim * mlp_ratio)
        self.adaln_mod = Dense(dim, 6 * dim, dtype=dt)
        self.qkv = Dense(dim, 3 * dim, dtype=dt)
        self.attn_out = Dense(dim, dim, dtype=dt)
        self.mlp_in = Dense(dim, hidden, dtype=dt)
        self.mlp_out = Dense(hidden, dim, dtype=dt)

    def forward(self, x: torch.Tensor, c: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                mlp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attn_mask`` / ``mlp_mask``: training's keep masks of the two
        dropout sites (the attention and MLP outputs, before their gates)."""
        sh1, sc1, g1, sh2, sc2, g2 = self.adaln_mod(F.silu(c)).chunk(6, dim=-1)
        h = _modulate(_layer_norm(x), sh1, sc1)
        B, N, D = h.shape
        qkv = self.qkv(h).reshape(B, N, 3, self.heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = A.fused_attention(q * self.head_dim**-0.5, k, v)
        attn = dropout(self.attn_out(attn.to(h.dtype).reshape(B, N, D)), attn_mask, self.dropout)
        x = x + g1[:, None, :] * attn
        h = _modulate(_layer_norm(x), sh2, sc2)
        h = self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))  # flax nn.gelu: tanh form
        return x + g2[:, None, :] * dropout(h, mlp_mask, self.dropout)


@register_target("diffusion_model_nemo.modules.DiT", "diffusion_model_nemo_tpu.modules.DiT")
class DiT(nn.Module):
    """Diffusion Transformer; drop-in for ``Unet`` in the DDPM family.
    ``input_dim``, ``moe_every``, ``moe_capacity_factor`` and
    ``context_vocab`` are accepted for config compatibility; ``dropout``
    acts in training through injected masks (the module docstring).
    ``remat`` recomputes each block's activations in the backward
    (``parts.remat_call``), as the JAX package's ``nn.remat`` does.
    ``in_channels`` (default ``channels``) is the patch embedding's input
    width, which flax infers from the input (SR3's 2C)."""

    def __init__(
        self,
        dim: int = 384,
        depth: int = 12,
        heads: int = 6,
        patch_size: int = 2,
        channels: int = 3,
        input_dim: Optional[int] = None,
        out_dim: Optional[int] = None,
        mlp_ratio: float = 4.0,
        time_freq_dim: int = 256,
        dropout: Optional[float] = None,
        learned_variance: bool = False,
        num_classes: Optional[int] = None,
        moe_experts: int = 0,
        moe_every: int = 2,
        moe_capacity_factor: float = 1.0,
        aug_dim: int = 0,
        context_dim: int = 0,
        context_vocab: int = 0,
        dtype: str = "float32",
        remat: bool = False,
        seq_axis_name: Optional[str] = None,
        in_channels: Optional[int] = None,
    ):
        super().__init__()
        if moe_experts:
            raise not_ported("DiT", f"moe_experts={moe_experts}", "DiT mixture-of-experts")
        if context_dim:
            raise not_ported("DiT", f"context_dim={context_dim}", "text-conditional DiT")
        if seq_axis_name is not None:
            raise not_ported("DiT", f"seq_axis_name={seq_axis_name!r}", "sequence-parallel ring attention")
        dt = resolve_dtype(dtype)
        self.dtype, self.dim, self.patch_size = dt, dim, int(patch_size)
        self.remat = bool(remat)
        p = self.patch_size
        self.out_dim = out_dim if out_dim is not None else channels * (2 if learned_variance else 1)
        self.patch_embed = Conv2d(in_channels or channels, dim, p, stride=p, dtype=dt)
        self.time_sinusoid = SinusoidalPositionEmbeddings(time_freq_dim)
        self.time_dense0 = Dense(time_freq_dim, dim, dtype=dt)
        self.time_dense1 = Dense(dim, dim, dtype=dt)
        self.num_classes = None if num_classes is None else int(num_classes)
        if self.num_classes is not None:
            self.class_embed = Embed(self.num_classes + 1, dim)
        self.aug_dim = int(aug_dim or 0)
        if self.aug_dim:
            self.aug_embed = Dense(self.aug_dim, dim, bias=False, dtype=dt)
        self.dropout = float(dropout or 0.0)
        for i in range(depth):
            self.add_module(f"block_{i}", DiTBlock(dim, heads, mlp_ratio, dt, dropout=self.dropout))
        self.depth = depth
        self.final_mod = Dense(dim, 2 * dim, dtype=dt)
        self.final_linear = Dense(dim, p * p * self.out_dim, dtype=dt)
        self._pos: Dict[Tuple, torch.Tensor] = {}

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers, drawn from ``generator`` in module order:
        lecun-normal kernels (biases are zero from construction), and the
        adaLN-Zero layers (``adaln_mod``, ``final_mod``, ``final_linear``)
        zero."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        zero = [self.final_mod, self.final_linear] + ([self.aug_embed] if self.aug_dim else [])
        zero += [getattr(self, f"block_{i}").adaln_mod for i in range(self.depth)]
        with torch.no_grad():
            for m in zero:
                m.weight.zero_()

    def dropout_shapes(self, shape) -> Dict[str, Tuple[int, ...]]:
        """{site: the keep mask's shape} for an input of ``shape`` [B, H, W,
        C]: two sites a block, [B, N, dim] each (none without dropout)."""
        if not self.dropout:
            return {}
        n = (shape[1] // self.patch_size) * (shape[2] // self.patch_size)
        return {f"block_{i}/Dropout_{j}": (shape[0], n, self.dim) for i in range(self.depth) for j in (0, 1)}

    def _position_embedding(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._pos:
            table = sincos_position_embedding_2d(h, w, self.dim)
            self._pos[key] = torch.from_numpy(table).to(device=device, dtype=self.dtype)
        return self._pos[key]

    def forward(self, x: torch.Tensor, time: torch.Tensor, classes: Optional[torch.Tensor] = None,
                dropout_masks: Optional[Dict[str, torch.Tensor]] = None,
                aug_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, H, W, C] float; time: [B] (int or float); classes: [B] int
        (a network with ``num_classes``; None = the null class);
        ``dropout_masks``: training's keep mask of each site; ``aug_cond``:
        the augmentation descriptor [B, aug_dim] (None = zeros) → [B, H, W,
        out] float32."""
        masks = dropout_masks or {}
        B, H, W, _ = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"DiT: image {H}x{W} not divisible by patch_size {p}")
        h, w = H // p, W // p
        tok = self.patch_embed(x.to(self.dtype)).reshape(B, h * w, self.dim)
        tok = tok + self._position_embedding(h, w, x.device)[None]
        t = self.time_sinusoid(time.reshape(-1))
        c = self.time_dense1(F.silu(self.time_dense0(t.to(self.dtype))))
        if self.num_classes is not None:
            if classes is None:
                classes = torch.full((B,), self.num_classes, dtype=torch.int32, device=x.device)
            c = c + self.class_embed(classes).to(self.dtype)
        if self.aug_dim:
            a = aug_cond if aug_cond is not None else torch.zeros((B, self.aug_dim), device=x.device)
            c = c + self.aug_embed(a.to(self.dtype))
        for i in range(self.depth):
            blk = getattr(self, f"block_{i}")
            m = (masks.get(f"block_{i}/Dropout_0"), masks.get(f"block_{i}/Dropout_1"))
            tok = remat_call(blk, tok, c, *m) if self.remat else blk(tok, c, *m)
        sh, sc = self.final_mod(F.silu(c)).chunk(2, dim=-1)
        out = self.final_linear(_modulate(_layer_norm(tok), sh, sc))
        return depth_to_space(out.reshape(B, h, w, p * p * self.out_dim), p).float()
