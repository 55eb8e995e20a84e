"""The 2-D transpose of TPU kernel #13: plain version and the wrapper of the
hand-written Hopper kernel (``csrc/transpose.cu``).

Counterpart of ``_tr_kernel`` / ``transpose_probe`` in the JAX package's
``tools/microbench_attn_lanes.py``, the probe of the batch-minor layout's
primitive: [rows, cols] → [cols, rows]. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .recompute import kernel_call

__all__ = ["transpose2d_reference", "transpose2d", "transpose2d_cuda", "LAUNCHES"]

# Launches of the kernel, counted where its wrapper launches it.
LAUNCHES = {"transpose2d": 0}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_MAX_INT = 2**31 - 1


def transpose2d_reference(x: torch.Tensor) -> torch.Tensor:
    """[rows, cols] → contiguous [cols, rows]."""
    return x.t().contiguous()


def transpose2d(x: torch.Tensor) -> torch.Tensor:
    """[rows, cols] → [cols, rows] through kernel #13; differentiable."""
    return kernel_call(transpose2d_cuda, transpose2d_reference, x)


def transpose2d_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the tiled transpose on a contiguous 2-D CUDA tensor of 2- or
    4-byte elements; moves the bits as they are."""
    what = "transpose2d_cuda"
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.element_size() not in (2, 4):
        raise TypeError(f"{what} takes 2- or 4-byte elements, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous [rows, cols] tensor, got {tuple(x.shape)}")
    rows, cols = x.shape
    if rows > _MAX_INT or cols > 65535 * 32 or x.numel() == 0:
        raise ValueError(f"{what} takes 0 < rows < 2^31 and 0 < cols <= {65535 * 32}, got {tuple(x.shape)}")
    y = torch.empty((cols, rows), dtype=x.dtype, device=x.device)
    _build.launch(
        "transpose", "dmn_transpose2d",
        [_VP, _VP, _CI, _CI, _CI, _VP],
        x.data_ptr(), y.data_ptr(), rows, cols, x.element_size(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    LAUNCHES["transpose2d"] += 1
    return y
