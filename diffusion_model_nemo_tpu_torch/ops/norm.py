"""Fused GroupNorm(+FiLM)+SiLU: the plain PyTorch version, the JAX package's
dispatch rule for the batch-minor route, and the wrappers of the
hand-written Hopper kernels (``csrc/group_norm_silu.cu``,
``csrc/group_norm_bm.cu``).

Counterpart of ``diffusion_model_nemo_tpu/ops/norm.py``. Three TPU kernels:
#1 ``_kernel`` (NHWC, no FiLM), #5 ``_kernel_film`` (NHWC with FiLM) and #6
``_kernel_bm`` (batch-minor [HW, C, B], with or without FiLM). #6 is the
JAX package's opt-in route, read at call time from the same switch,
``DMN_TPU_PALLAS_NORM_BM`` (any value but ``0``), under the same shape rule
(``use_norm_bm``); elsewhere #1 or #5 runs. A tensor on the CPU takes the
plain version; a CUDA tensor launches a kernel or raises. Every route is
differentiable (``recompute.kernel_call``): the backward recomputes the
plain version, as the JAX package's ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from . import _build
from .recompute import kernel_call

__all__ = [
    "group_norm_silu",
    "group_norm_silu_reference",
    "group_norm_silu_cuda",
    "group_norm_silu_film_cuda",
    "group_norm_silu_bm_cuda",
    "use_norm_bm",
    "LAUNCHES",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _CI, _CL, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float

# Launches of each kernel, counted where its wrapper launches it.
LAUNCHES = {"group_norm_silu": 0, "group_norm_silu_film": 0, "group_norm_silu_bm": 0}

_BM_LANES = 128  # the TPU kernel's samples per grid step: B must be a multiple
_BM_VMEM_BYTES = 12 * 1024 * 1024


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


# ---------------------------------------------------------------- dispatch --
def use_norm_bm(shape, dtype: torch.dtype, scale_numel: Optional[int] = None) -> bool:
    """The JAX package's rule for the batch-minor kernel #6 (``_use_pallas_bm``)
    as it reads on a TPU: ``DMN_TPU_PALLAS_NORM_BM`` set and not ``0``,
    B % 128 == 0, C <= 128, FiLM only per (sample, channel) (B·C elements),
    and a [HW, C, 128] block within 12 MiB."""
    if os.environ.get("DMN_TPU_PALLAS_NORM_BM", "0") == "0":
        return False
    B, H, W, C = shape
    if B % _BM_LANES != 0 or C > 128:
        return False
    if scale_numel is not None and scale_numel != B * C:
        return False
    return H * W * C * _BM_LANES * dtype.itemsize <= _BM_VMEM_BYTES


def group_norm_silu(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    groups: int,
    eps: float = 1e-5,
    scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Public fused op on NHWC ``x``: the plain version on the CPU; on CUDA
    kernel #6 where ``use_norm_bm`` holds, else #1 (no FiLM) or #5 (FiLM)."""
    args = (x, gamma, beta, groups, eps)
    if scale_shift is not None:
        args += tuple(scale_shift)
    scale_numel = None if scale_shift is None else scale_shift[0].numel()
    if use_norm_bm(x.shape, x.dtype, scale_numel):
        kernel = group_norm_silu_bm_cuda
    elif scale_shift is None:
        kernel = group_norm_silu_cuda
    else:
        kernel = group_norm_silu_film_cuda
    return kernel_call(kernel, group_norm_silu_reference, *args)


# ---------------------------------------------------------- kernel wrappers --
def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, what: str):
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes bf16 or f32, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous NHWC tensor, got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if C % groups:
        raise ValueError(f"C={C} is not divisible by groups={groups}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.shape != (C,) or p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{C}] tensor on {x.device}")
    return x.shape


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def group_norm_silu_cuda(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float = 1e-5
) -> torch.Tensor:
    """Launch kernel #1 (GroupNorm+SiLU) on NHWC ``x`` (bf16 or f32)."""
    B, H, W, C = _check(x, gamma, beta, groups, "group_norm_silu_cuda")
    out = torch.empty_like(x)
    _build.launch(
        "group_norm_silu", "dmn_group_norm_silu",
        [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CF, _CI, _VP],
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        B, H * W, C, groups, eps, _DTYPE_CODES[x.dtype], _stream(x),
    )
    LAUNCHES["group_norm_silu"] += 1
    return out


def _film_view(t: torch.Tensor, x: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` broadcast to x's [B, H, W, C] as a view the kernel reads with a
    (sample, pixel) stride pair and unit channel stride; a copy only where
    the broadcast has no such strides."""
    if t.device != x.device or t.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"{name} must be float32 or {x.dtype} on {x.device}, got {t.dtype} on {t.device}")
    v = t.expand(x.shape)
    if v.stride(3) != 1 or v.stride(1) != v.shape[2] * v.stride(2):
        v = v.contiguous()
    return v


def group_norm_silu_film_cuda(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float,
    scale: torch.Tensor, shift: torch.Tensor,
) -> torch.Tensor:
    """Launch kernel #5 (GroupNorm+FiLM+SiLU) on NHWC ``x``; ``scale`` and
    ``shift`` broadcast to x's shape ([B,1,1,C], [B,H,W,C], ...), float32 or
    x's dtype, read in place where their strides allow."""
    B, H, W, C = _check(x, gamma, beta, groups, "group_norm_silu_film_cuda")
    sc, sh = _film_view(scale, x, "scale"), _film_view(shift, x, "shift")
    if sc.dtype != sh.dtype:
        sh = sh.to(sc.dtype)
    out = torch.empty_like(x)
    _build.launch(
        "group_norm_silu", "dmn_group_norm_silu_film",
        [_VP] * 5 + [_CL] * 4 + [_VP] + [_CI] * 4 + [_CF, _CI, _CI, _VP],
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), sc.data_ptr(), sh.data_ptr(),
        sc.stride(0), sc.stride(2), sh.stride(0), sh.stride(2), out.data_ptr(),
        B, H * W, C, groups, eps, _DTYPE_CODES[x.dtype], int(sc.dtype == torch.bfloat16),
        _stream(x),
    )
    LAUNCHES["group_norm_silu_film"] += 1
    return out


def _bm_splits(B: int, HW: int, C: int, groups: int) -> int:
    """Ranges each (group, 32 samples) slice is split into: enough blocks to
    fill the 132 SMs about four times, at least 64 rows a range."""
    blocks = (B // 32) * groups
    return max(1, min(math.ceil(4 * 132 / blocks), math.ceil(HW * (C // groups) / 64)))


def group_norm_silu_bm_cuda(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch kernel #6 (batch-minor GroupNorm(+FiLM)+SiLU) as the TPU
    launcher runs it: x [B,H,W,C] transposed to [HW, C, B], normalised there
    in place, transposed back. FiLM scale/shift hold B·C elements (per
    sample and channel) and go to the kernel as [C, B] float32."""
    B, H, W, C = _check(x, gamma, beta, groups, "group_norm_silu_bm_cuda")
    if B % 32:
        raise ValueError(f"group_norm_silu_bm_cuda takes a batch that is a multiple of 32, got {B}")
    film = ()
    if scale is not None:
        if scale.numel() != B * C or shift.numel() != B * C:
            raise ValueError(f"FiLM scale/shift must hold B*C = {B * C} elements per sample and channel")
        film = tuple(t.reshape(B, C).t().float().contiguous() for t in (scale, shift))
    xt = x.reshape(B, H * W, C).permute(1, 2, 0).contiguous()  # [HW, C, B]
    splits = _bm_splits(B, H * W, C, groups)
    part = torch.empty((splits, groups, B, 2), dtype=torch.float32, device=x.device)
    sc, sh = film if film else (None, None)
    _build.launch(
        "group_norm_bm", "dmn_group_norm_bm",
        [_VP] * 6 + [_CI] * 5 + [_CF, _CI, _VP],
        xt.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if sc is None else sc.data_ptr(), None if sh is None else sh.data_ptr(),
        part.data_ptr(), H * W, C, B, groups, splits, eps, _DTYPE_CODES[x.dtype], _stream(x),
    )
    LAUNCHES["group_norm_silu_bm"] += 1
    return xt.permute(2, 0, 1).reshape(B, H, W, C).contiguous()
