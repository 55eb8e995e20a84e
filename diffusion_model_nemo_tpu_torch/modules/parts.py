"""U-Net building blocks (PyTorch, NHWC at every public function).

Counterpart of ``diffusion_model_nemo_tpu/modules/parts.py``. Module and
parameter names follow the flax names, so a flax parameter tree maps onto
``state_dict`` one to one (``utils/weights.py``). Parameters stay float32;
each module computes in its ``dtype`` by casting input, weight and bias, as
flax does for ``nn.Conv`` / ``nn.Dense`` with ``dtype=bfloat16``.

Convolutions run on the NHWC tensors through an NCHW view whose memory is
channels-last (``x.permute(0, 3, 1, 2)``), so the output permuted back to
NHWC is contiguous and the kernels' ``[B, N, C]`` views cost nothing.

Kept reference bug: ``Block`` runs conv→norm→act for both 'conv_bn_act' and
'bn_act_conv'; 'true_bn_act_conv' is the corrected pre-activation order.
``Block``/``FusedGroupNormSiLU`` take the JAX package's optional FiLM
``scale_shift`` (kernel #5, or #6 under its switch); no module of the U-Net
passes one. WaveGrad's FiLM modules (``PositionalEncoding``,
``FeatureWiseLinearModulation``) compute a (scale, shift) pair that the
WaveGrad U-Net applies as ``x·scale + shift`` itself, as the JAX package
does. ConvNeXt blocks are not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops import attention as A
from ..ops.norm import group_norm_silu

__all__ = [
    "resolve_dtype",
    "not_ported",
    "remat_call",
    "Conv1d",
    "Conv2d",
    "ConvTranspose2d",
    "Dense",
    "Conv1x1",
    "Embed",
    "GNParams",
    "FusedGroupNormSiLU",
    "Block",
    "ResnetBlock",
    "Attention",
    "LinearAttention",
    "SinusoidalPositionEmbeddings",
    "SelfAttentionBlock",
    "Downsample",
    "Upsample",
    "noise_level_sinusoid",
    "PositionalEncoding",
    "FeatureWiseLinearModulation",
]

VALID_BLOCK_ORDERS = ("conv_bn_act", "bn_act_conv", "true_bn_act_conv")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def not_ported(network: str, option: str, slice_: str) -> NotImplementedError:
    """The error a network raises for an option of the JAX package that a
    later slice of the port brings."""
    return NotImplementedError(
        f"{network}({option}) is not ported yet; it comes with the {slice_} slice (ROADMAP.md)"
    )


def remat_call(module: nn.Module, *args):
    """``module(*args)`` with its activations recomputed in the backward
    instead of kept (the JAX package's ``nn.remat`` around a block class),
    where autograd records: ``torch.utils.checkpoint``, non-reentrant. The
    module's parameters go in as explicit inputs and the recompute runs under
    ``functional_call`` with them, so it reads the tensors the forward read,
    also when the forward itself ran under ``functional_call`` (training).
    Elsewhere (sampling, ``no_grad``) a plain call."""
    if not torch.is_grad_enabled():
        return module(*args)
    names, tensors = zip(*[*module.named_parameters(), *module.named_buffers()])
    n = len(names)

    def run(*flat):
        return functional_call(module, dict(zip(names, flat[:n])), flat[n:])

    return checkpoint(run, *tensors, *args, use_reentrant=False)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        draw = torch.randn(w.shape, generator=generator, dtype=torch.float32)
        w.copy_(draw * (1.0 / math.sqrt(fan_in)))


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on NHWC: weight OIHW, zero-initialised bias."""

    def __init__(self, c_in, c_out, k, stride=1, padding=0, bias=True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, resolve_dtype(dtype)

    def reset_parameters(self, generator=None) -> None:
        o, i, kh, kw = self.weight.shape
        _lecun_normal_(self.weight, i * kh * kw, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


def same_padding(length: int, k: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` for one spatial dim: ceil(length / stride)
    outputs, the total padding split with the smaller half on the left."""
    out = -(-length // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - length, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """flax ``nn.Conv`` with one spatial dim on [B, T, C]: weight [O, I, K],
    zero-initialised bias. ``padding``: an int (both sides) or ``"SAME"``
    (XLA's rule, asymmetric where the total is odd: at k = 3, stride 2 on an
    even T it pads (0, 1), which a symmetric torch padding cannot say)."""

    def __init__(self, c_in, c_out, k, stride=1, dilation=1, padding: Union[int, str] = "SAME",
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride, self.dilation, self.padding, self.dtype = stride, dilation, padding, resolve_dtype(dtype)

    def reset_parameters(self, generator=None) -> None:
        o, i, k = self.weight.shape
        _lecun_normal_(self.weight, i * k, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = x.to(dt).transpose(1, 2)
        k = self.weight.shape[-1]
        pads = same_padding(h.shape[-1], k, self.stride, self.dilation) if self.padding == "SAME" \
            else (self.padding, self.padding)
        if any(pads):
            h = F.pad(h, pads)
        y = F.conv1d(h, self.weight.to(dt), self.bias.to(dt), self.stride, 0, self.dilation)
        return y.transpose(1, 2).contiguous()


class ConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose`` 'SAME' k4 s2 on NHWC, as torch's
    ConvTranspose2d(k=4, s=2, p=1): weight IOHW (the flax kernel flipped)."""

    def __init__(self, c_in, c_out, k=4, stride=2, padding=1, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, c_out, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride, self.padding, self.dtype = stride, padding, resolve_dtype(dtype)

    def reset_parameters(self, generator=None) -> None:
        i, o, kh, kw = self.weight.shape
        _lecun_normal_(self.weight, i * kh * kw, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv_transpose2d(
            x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt),
            self.stride, self.padding,
        )
        return y.permute(0, 2, 3, 1).contiguous()


class Dense(nn.Module):
    """flax ``nn.Dense``: weight [out, in]."""

    def __init__(self, c_in, c_out, bias=True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.dtype = resolve_dtype(dtype)

    def reset_parameters(self, generator=None) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv1x1(Dense):
    """The JAX package's ``Conv1x1``: a 1×1 convolution computed as a matmul
    over [B, N, C] tokens. Its flax kernel [1, 1, C, F] is stored as [F, C]."""


class Embed(nn.Module):
    """flax ``nn.Embed``: a float32 table ``weight`` [num, features] (flax's
    ``embedding``), looked up by index."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, generator=None) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)  # flax's variance_scaling(1, fan_in)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight[idx.long()]


class GNParams(nn.Module):
    """GroupNorm(1)'s parameters (flax ``scale``/``bias`` → weight/bias),
    consumed by the fused blocks or by the plain ``_gn1``."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


ScaleShift = Optional[Tuple[torch.Tensor, torch.Tensor]]


class FusedGroupNormSiLU(GNParams):
    """GroupNorm → optional FiLM x·(scale+1)+shift → SiLU as one fused op
    (Hopper kernel on CUDA)."""

    def __init__(self, c, groups=8, eps=1e-5, dtype=torch.float32):
        super().__init__(c)
        self.groups, self.eps, self.dtype = groups, eps, resolve_dtype(dtype)

    def forward(self, x: torch.Tensor, scale_shift: ScaleShift = None) -> torch.Tensor:
        return group_norm_silu(
            x, self.weight, self.bias, self.groups, self.eps, scale_shift=scale_shift
        ).to(self.dtype)


class Block(nn.Module):
    """conv3×3 → GroupNorm → (optional FiLM scale/shift) → SiLU (dropout is
    not ported: the U-Net raises for dropout > 0 in training)."""

    def __init__(self, c_in, c_out, groups=8, order="bn_act_conv", dtype=torch.float32):
        super().__init__()
        if order not in VALID_BLOCK_ORDERS:
            raise ValueError(f"Valid ordering for block are : {VALID_BLOCK_ORDERS}")
        self.order = order
        self.proj = Conv2d(c_in, c_out, 3, padding=1, dtype=dtype)
        norm_c = c_in if order == "true_bn_act_conv" else c_out
        self.norm = FusedGroupNormSiLU(norm_c, groups, 1e-5, dtype)

    def forward(self, x: torch.Tensor, scale_shift: ScaleShift = None) -> torch.Tensor:
        if self.order == "true_bn_act_conv":
            return self.proj(self.norm(x, scale_shift))
        return self.norm(self.proj(x), scale_shift)


class ResnetBlock(nn.Module):
    """Two Blocks with a time-embedding bias between them, + residual 1×1."""

    def __init__(self, c_in, c_out, time_dim=None, groups=8, order="bn_act_conv",
                 dtype=torch.float32):
        super().__init__()
        self.block1 = Block(c_in, c_out, groups, order, dtype)
        self.mlp = Dense(time_dim, c_out, dtype=dtype) if time_dim else None
        self.block2 = Block(c_out, c_out, groups, order, dtype)
        self.res_conv = Conv2d(c_in, c_out, 1, dtype=dtype) if c_in != c_out else None

    def forward(self, x: torch.Tensor, time_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.block1(x)
        if self.mlp is not None and time_emb is not None:
            h = h + self.mlp(F.silu(time_emb))[:, None, None, :]
        h = self.block2(h)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class Attention(nn.Module):
    """Full softmax attention over the H·W tokens, 4 heads × 32."""

    def __init__(self, c, heads=4, dim_head=32, dtype=torch.float32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Conv1x1(c, hidden * 3, bias=False, dtype=dtype)
        self.to_out = Conv1x1(hidden, c, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        hidden = self.heads * self.dim_head
        qkv = self.to_qkv(x.reshape(B, H * W, C)).reshape(B, H * W, 3, self.heads, self.dim_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = A.fused_attention(q * self.dim_head**-0.5, k, v)
        out = out.to(x.dtype).reshape(B, H * W, hidden)
        return self.to_out(out).reshape(B, H, W, C)


class LinearAttention(nn.Module):
    """O(N) linear attention: q softmax over d, k softmax over N, per-head
    context; out 1×1 projection + GroupNorm(1)."""

    def __init__(self, c, heads=4, dim_head=32, dtype=torch.float32):
        super().__init__()
        hidden = heads * dim_head
        self.heads, self.dim_head, self.dtype = heads, dim_head, resolve_dtype(dtype)
        self.to_qkv = Conv1x1(c, hidden * 3, bias=False, dtype=dtype)
        self.to_out = Conv1x1(hidden, c, dtype=dtype)
        self.out_norm = GNParams(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        out = A.fused_linear_attention_tokens(
            x.reshape(B, H * W, C).to(self.dtype),
            self.to_qkv.weight.t(),
            self.heads,
            self.dim_head,
            self.dim_head**-0.5,
        ).to(x.dtype)
        out = self.to_out(out)
        out = A._gn1(out, self.out_norm.weight, self.out_norm.bias, 1e-5).to(self.dtype)
        return out.reshape(B, H, W, C)


class SinusoidalPositionEmbeddings(nn.Module):
    """Transformer sinusoid of the timestep, base 10000, float32."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, time: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        emb = math.log(10000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=time.device) * -emb)
        emb = time.float()[:, None] * emb[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class SelfAttentionBlock(nn.Module):
    """``Residual(PreNorm(LinearAttention or Attention))`` as one module.

    Dispatch follows the JAX package: the whole-block linear-attention kernel
    where ``use_packed_linattn_block`` holds, the bottleneck attention-block
    kernel where ``use_small_attn_block`` holds; then, for a linear block
    under the switch ``DMN_TPU_PALLAS_LINATTN_BLOCK=1`` (read at call time),
    the whole-block kernel v1 (#9, or the plain block where its rule fails);
    and the composed modules otherwise (whose linear attention may still
    reach the qkv-fused kernel).
    """

    def __init__(self, c, linear=True, heads=4, dim_head=32, dtype=torch.float32):
        super().__init__()
        self.linear, self.heads, self.dim_head = linear, heads, dim_head
        self.dtype = resolve_dtype(dtype)
        self.norm = GNParams(c)
        cls = LinearAttention if linear else Attention
        self.attn = cls(c, heads, dim_head, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        shape = (B, H * W, C)
        a, n = self.attn, self.norm
        scale = self.dim_head**-0.5
        if self.linear and A.use_packed_linattn_block(shape, self.dtype, self.heads, self.dim_head):
            out = A.fused_linear_attention_block_packed(
                x.reshape(shape).to(self.dtype), n.weight, n.bias,
                a.to_qkv.weight.t(), a.to_out.weight.t(), a.to_out.bias,
                a.out_norm.weight, a.out_norm.bias,
                self.heads, self.dim_head, scale, 1e-5,
            )
            return out.reshape(B, H, W, C).to(x.dtype)
        if not self.linear and A.use_small_attn_block(shape, self.dtype, self.heads, self.dim_head):
            out = A.fused_attention_block_small(
                x.reshape(shape).to(self.dtype), n.weight, n.bias,
                a.to_qkv.weight.t(), a.to_out.weight.t(), a.to_out.bias,
                self.heads, self.dim_head, scale, 1e-5,
            )
            return out.reshape(B, H, W, C).to(x.dtype)
        if self.linear and os.environ.get("DMN_TPU_PALLAS_LINATTN_BLOCK") == "1":
            out = A.fused_linear_attention_block(
                x.reshape(shape).to(self.dtype), n.weight, n.bias,
                a.to_qkv.weight.t(), a.to_out.weight.t(), a.to_out.bias,
                a.out_norm.weight, a.out_norm.bias,
                self.heads, self.dim_head, scale, 1e-5,
            )
            return out.reshape(B, H, W, C)
        h = A._gn1(x.reshape(shape).to(self.dtype), n.weight, n.bias, 1e-5)
        return self.attn(h.reshape(B, H, W, C)) + x


class Downsample(nn.Module):
    """Strided conv k4 s2 p1."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(dim, dim, 4, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Transposed conv k4 s2 p1 → exact 2×."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.conv = ConvTranspose2d(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def noise_level_sinusoid(level: torch.Tensor, channels: int, scale: float = 5000.0) -> torch.Tensor:
    """WaveGrad's encoding of a continuous noise level: [B] (any shape with
    B leading) → [B, channels], sin‖cos of ``scale·level·1e-4^(i/half)``.
    The frequencies are float32(1e-4) to the float32 exponents in float64,
    rounded once: XLA's float32 pow gives exactly these, torch's float32
    pow sits an ulp away in a few, and at angles up to 5000 rad an ulp of a
    frequency moves the sine by ~3e-4."""
    level = level.reshape(level.shape[0]).float()
    half = channels // 2
    exponents = torch.arange(half, dtype=torch.float32, device=level.device) / float(half)
    base = torch.tensor(1e-4, dtype=torch.float32).item()  # float32(1e-4), exactly, as a Python float
    freqs = torch.pow(base, exponents.double()).float()
    angles = scale * level[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class PositionalEncoding(nn.Module):
    """WaveGrad noise-level encoding as a [B, 1, 1, C] map (no parameters)."""

    def __init__(self, n_channels: int):
        super().__init__()
        self.n_channels = n_channels

    def forward(self, noise_level: torch.Tensor) -> torch.Tensor:
        return noise_level_sinusoid(noise_level, self.n_channels)[:, None, None, :]


class FeatureWiseLinearModulation(nn.Module):
    """FiLM statistics: 3×3 conv + LeakyReLU(0.2), plus the noise level's
    encoding (float32: the sum is promoted, as in flax), then the 3×3 scale
    and shift convs; returns (scale, shift) in the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.signal_conv = Conv2d(in_channels, in_channels, 3, padding=1, dtype=dtype)
        self.positional_encoding = PositionalEncoding(in_channels)
        self.scale_conv = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.shift_conv = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, noise_level: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.leaky_relu(self.signal_conv(x), 0.2)
        h = h + self.positional_encoding(noise_level)
        return self.scale_conv(h), self.shift_conv(h)
