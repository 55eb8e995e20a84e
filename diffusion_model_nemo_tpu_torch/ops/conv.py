"""The 3×3 convolution of TPU kernel #11: plain version, the JAX package's
gate, and the wrapper of the hand-written Hopper kernel (``csrc/conv3x3.cu``).

Counterpart of ``diffusion_model_nemo_tpu/ops/conv.py``. Its Pallas kernel
(``_tap_split_kernel``) split the nine taps between the GEMM's contraction and
output dimensions to widen a 32-channel conv on the TPU's 128-lane matrix
unit. Every MAC runs once either way, so the CUDA kernel is a direct SAME 3×3
conv with f32 accumulation; ``pack_tap_split_weights`` is kept for the JAX
layout's sake and is bitwise equal to the JAX function. The public functions
keep the JAX layouts: NHWC ``x``, HWIO ``w`` [3, 3, C, F], bias [F].

No network of the repository calls this op (the U-Net's convs go to cuDNN
through ``F.conv2d``); the JAX package reaches its kernel through
``DMN_TPU_TAP_SPLIT_CONV=1`` and its microbenchmark
(``tools/microbench_conv.py``; here ``tools/microbench_conv.py`` of this
package). A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .recompute import kernel_call

__all__ = [
    "conv3x3_reference",
    "pack_tap_split_weights",
    "use_tap_split",
    "conv3x3",
    "conv3x3_tap_split",
    "conv3x3_cuda",
    "LAUNCHES",
]

# Launches of the kernel, counted where its wrapper launches it.
LAUNCHES = {"conv3x3": 0}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_WIDTH = 128  # a band of the kernel holds at most 128 output pixels


@contextlib.contextmanager
def _no_tf32():
    """cuDNN runs a float32 convolution in TF32 by default; the plain
    version is the float32 reference, so TF32 is off around it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """NHWC SAME 3×3 conv with f32 accumulation, out in x's dtype (the JAX
    ``conv3x3_reference``): w rounded to x's dtype, the bias added in f32."""
    xc = x.float().permute(0, 3, 1, 2)
    wc = w.to(x.dtype).float().permute(3, 2, 0, 1)
    with _no_tf32():
        y = F.conv2d(xc, wc, padding=1)
    if b is not None:
        y = y + b.float()[:, None, None]
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def pack_tap_split_weights(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, F] → [(ty·C + ci), (tx·F + co)], the tap-split GEMM's operand."""
    kh, kw, C, Fo = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_tap_split_weights takes a 3x3 kernel, got {tuple(w.shape)}")
    return w.permute(0, 2, 1, 3).reshape(3 * C, 3 * Fo)


def use_tap_split(shape, w_shape) -> bool:
    """The JAX package's gate (``_use_tap_split``) as it reads on a TPU:
    ``DMN_TPU_TAP_SPLIT_CONV=1``, a 3×3 kernel, C < 128, F < 128,
    (H·W) % 8 == 0 and B % 8 == 0."""
    if os.environ.get("DMN_TPU_TAP_SPLIT_CONV") != "1":
        return False
    B, H, W, C = shape
    return (
        tuple(w_shape[:2]) == (3, 3)
        and C < 128
        and w_shape[-1] < 128
        and (H * W) % 8 == 0
        and B % 8 == 0
    )


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """SAME 3×3 conv + bias through kernel #11 at any shape it takes, without
    the gate (as the JAX microbenchmark calls ``_pallas_conv3x3``);
    differentiable through the plain version."""
    return kernel_call(conv3x3_cuda, conv3x3_reference, x, w, b)


def conv3x3_tap_split(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``conv3x3_tap_split``: kernel #11 where
    ``use_tap_split`` holds, the plain conv otherwise. Reverse mode
    recomputes the plain conv (``recompute.kernel_call``)."""
    if use_tap_split(x.shape, w.shape):
        return conv3x3(x, w, b)
    return conv3x3_reference(x, w, b)


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the 3×3 conv kernel on a contiguous float32 or bf16 NHWC x
    (W <= 128); w and b are rounded to x's dtype first, as the JAX launcher
    does. → [B, H, W, F] in x's dtype."""
    what = "conv3x3_cuda"
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} takes float32 or bf16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous NHWC x, got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"{what} takes w [3, 3, {C}, F], got {tuple(w.shape)}")
    Fo = w.shape[3]
    if b is not None and tuple(b.shape) != (Fo,):
        raise ValueError(f"{what} takes a bias [{Fo}], got {tuple(b.shape)}")
    if W > _MAX_WIDTH or B > 65535:
        raise ValueError(f"{what} takes W <= {_MAX_WIDTH} and B <= 65535, got {tuple(x.shape)}")
    wt = w.to(x.dtype).contiguous()
    bt = None if b is None else b.to(x.dtype).contiguous()
    y = torch.empty((B, H, W, Fo), dtype=x.dtype, device=x.device)
    _build.launch(
        "conv3x3", "dmn_conv3x3",
        [_VP] * 4 + [_CI] * 6 + [_VP],
        x.data_ptr(), wt.data_ptr(), None if bt is None else bt.data_ptr(), y.data_ptr(),
        B, H, W, C, Fo, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    LAUNCHES["conv3x3"] += 1
    return y
