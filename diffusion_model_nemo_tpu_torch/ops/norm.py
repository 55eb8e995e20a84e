"""Fused GroupNorm(+FiLM)+SiLU: the plain PyTorch version and the wrapper of
its hand-written Hopper kernel (``csrc/group_norm_silu.cu``).

Counterpart of ``diffusion_model_nemo_tpu/ops/norm.py``. A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises. The
FiLM branch (``scale_shift``) is the TPU kernel ``_kernel_film``, which no
module of the ResNet U-Net reaches and the port has not written yet: on CUDA
it raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "group_norm_silu", "group_norm_silu_reference", "group_norm_silu_cuda", "LAUNCHES",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the kernel, counted where the wrapper launches it.
LAUNCHES = {"group_norm_silu": 0}


def group_norm_silu_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    groups: int,
    eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GroupNorm → optional x·(scale+1)+shift → SiLU on NHWC ``x``.

    Statistics in float32 in the one-pass form E[x²] − E[x]², clipped at
    zero (the JAX package's formula, not torch's two-pass form); the result
    is cast back to ``x.dtype``."""
    B, H, W, C = x.shape
    xg = x.reshape(B, H * W, groups, C // groups).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    out = xn * gamma.float() + beta.float()
    if scale is not None:
        out = out * (scale.float() + 1.0) + shift.float()
    return (out * torch.sigmoid(out)).to(x.dtype)


def group_norm_silu_cuda(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float = 1e-5
) -> torch.Tensor:
    """Launch the Hopper GroupNorm+SiLU kernel on NHWC ``x`` (bf16 or f32)."""
    if not x.is_cuda:
        raise ValueError(f"group_norm_silu_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm_silu_cuda takes bf16 or f32, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NHWC tensor, got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    if C % groups:
        raise ValueError(f"C={C} is not divisible by groups={groups}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.shape != (C,) or p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{C}] tensor on {x.device}")
    out = torch.empty_like(x)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "group_norm_silu", "dmn_group_norm_silu",
        [vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, ci, vp],
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        B, H * W, C, groups, eps, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    LAUNCHES["group_norm_silu"] += 1
    return out


def group_norm_silu(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    groups: int,
    eps: float = 1e-5,
    scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Public fused op on NHWC ``x``: the plain version on the CPU, the
    Hopper kernel on CUDA."""
    if x.device.type == "cpu":
        scale, shift = scale_shift if scale_shift is not None else (None, None)
        return group_norm_silu_reference(x, gamma, beta, groups, eps, scale, shift)
    if scale_shift is not None:
        raise NotImplementedError(
            "GroupNorm+FiLM+SiLU on CUDA is TPU kernel #5 (diffusion_model_nemo_tpu/"
            "ops/norm.py:_kernel_film), not ported yet"
        )
    return group_norm_silu_cuda(x, gamma, beta, groups, eps)
