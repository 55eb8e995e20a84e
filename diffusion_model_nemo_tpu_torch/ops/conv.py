"""The 3×3 convolution of TPU kernel #11: plain version, the JAX package's
gate, and the wrapper of the hand-written Hopper kernel (``csrc/conv3x3.cu``).

Counterpart of ``diffusion_model_nemo_tpu/ops/conv.py``. Its Pallas kernel
(``_tap_split_kernel``) split the nine taps between the GEMM's contraction and
output dimensions to widen a 32-channel conv on the TPU's 128-lane matrix
unit. Every MAC runs once either way, so the card's kernel is the implicit
GEMM of a SAME 3×3 conv with f32 accumulation: on the tensor cores in bf16
(``wgmma`` at F >= 64, ``mma.sync`` below; ``conv3x3_route``), with the
weights repacked once per parameter version into the layout the instruction
reads (``pack_conv3x3_weights_wgmma``, ``pack_conv3x3_weights``), on CUDA
cores in float32.
``pack_tap_split_weights`` is kept for the JAX layout's sake and is bitwise
equal to the JAX function. The public functions keep the JAX layouts: NHWC
``x``, HWIO ``w`` [3, 3, C, F], bias [F].

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
from .weights import _derived, fragment_order, fragment_order_inverse

__all__ = [
    "conv3x3_reference",
    "pack_tap_split_weights",
    "pack_conv3x3_weights",
    "unpack_conv3x3_weights",
    "pack_conv3x3_weights_wgmma",
    "unpack_conv3x3_weights_wgmma",
    "conv3x3_route",
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
def no_tf32():
    """cuDNN runs a float32 convolution in TF32 by default; a float32
    reference (the plain conv here, SSIM's windows and InceptionV3 in
    ``metrics/``) turns TF32 off around its own, for the convolutions and
    for the matmuls (whose default is off, but a caller may have switched
    it on), and leaves both switches as it found them."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """NHWC SAME 3×3 conv with f32 accumulation, out in x's dtype (the JAX
    ``conv3x3_reference``): w rounded to x's dtype, the bias added in f32."""
    xc = x.float().permute(0, 3, 1, 2)
    wc = w.to(x.dtype).float().permute(3, 2, 0, 1)
    with no_tf32():
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


def conv3x3_route(F_out: int) -> str:
    """The bf16 kernel's form, by the output channels alone: "wgmma" (two
    warpgroups of ``wgmma.m64nNk16``, a block owning N = 64 or 128 output
    channels) where F >= 64, "mma" (``mma.sync.m16n8k16``, a block owning
    32) below, where an n64 tile would be mostly padding."""
    return "wgmma" if F_out >= 64 else "mma"


def _padded_rows(w: torch.Tensor, nt: int) -> torch.Tensor:
    """[3, 3, C, F] → [C'/32, 288, F'] in the kernel's K order (chunk of 32
    input channels, then tap, then channel), C and F zero-padded to
    multiples of 32 and of ``nt``."""
    kh, kw, C, Fo = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the conv3x3 kernel takes a 3x3 weight, got {tuple(w.shape)}")
    Cp, Fp = -(-C // 32) * 32, -(-Fo // nt) * nt
    wp = F.pad(w, (0, Fp - Fo, 0, Cp - C))  # [3, 3, C', F']
    return wp.reshape(9, Cp // 32, 32, Fp).permute(1, 0, 2, 3).reshape(Cp // 32, 9 * 32, Fp)


def _rows_to_weight(rows: torch.Tensor, C: int, F_out: int) -> torch.Tensor:
    """``_padded_rows``' output back to [3, 3, C, F]."""
    q, _, Fp = rows.shape
    w = rows.reshape(q, 9, 32, Fp).permute(1, 0, 2, 3).reshape(3, 3, q * 32, Fp)
    return w[:, :, :C, :F_out].contiguous()


def pack_conv3x3_weights(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, F] → the B operand of the bf16 kernel's mma.sync form: the
    GEMM weight with rows in the kernel's K order (chunk of 32 input
    channels, tap, channel), C and F padded to C' and F' (multiples of 32)
    with zeros, in ``mma.m16n8k16`` fragment order: [C'/32 · 9, F'/8, 32, 8]
    (``weights.fragment_order``). A permutation of the padded weight, in w's
    dtype; ``unpack_conv3x3_weights`` undoes it."""
    rows = _padded_rows(w, 32)
    return fragment_order(rows.reshape(-1, rows.shape[-1]))


def unpack_conv3x3_weights(packed: torch.Tensor, C: int, F_out: int) -> torch.Tensor:
    """``pack_conv3x3_weights``'s output back to [3, 3, C, F]."""
    rows = fragment_order_inverse(packed)  # [C'·9, F']
    return _rows_to_weight(rows.reshape(-1, 288, rows.shape[-1]), C, F_out)


_KATOMS = 5  # 64-k atoms a chunk's 288 k take in the wgmma form (the last half zeros)


def _swizzle128(t: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle on [..., rows, 64] bf16: the 16-byte piece p of
    row r goes to position p XOR (r % 8). Its own inverse."""
    rows = t.shape[-2]
    idx = torch.arange(8).repeat(rows, 1) ^ (torch.arange(rows) % 8)[:, None]  # [rows, 8]
    pieces = t.reshape(*t.shape[:-1], 8, 8)
    idx = idx.to(t.device).reshape((1,) * (t.dim() - 2) + (rows, 8, 1)).expand(pieces.shape)
    return torch.gather(pieces, -2, idx).reshape(t.shape)


def pack_conv3x3_weights_wgmma(w: torch.Tensor, nt: int) -> torch.Tensor:
    """[3, 3, C, F] → the B operand of the bf16 kernel's wgmma form: per
    chunk of 32 input channels and per output tile of ``nt`` channels, 5
    atoms of 64 k (the chunk's 288 k in K order, zero-padded to 320) × nt
    rows (output channels) × 64 k, K-major in the 128-byte swizzle:
    [C'/32, F'/nt, 5, nt, 64], a block's chunk one contiguous run. A
    permutation of the padded weight, in w's dtype;
    ``unpack_conv3x3_weights_wgmma`` undoes it."""
    rows = F.pad(_padded_rows(w, nt), (0, 0, 0, _KATOMS * 64 - 288))  # [q, 320, F']
    q, _, Fp = rows.shape
    v = rows.reshape(q, _KATOMS, 64, Fp // nt, nt).permute(0, 3, 1, 4, 2)  # [q, F'/nt, atom, n, k]
    return _swizzle128(v.contiguous())


def unpack_conv3x3_weights_wgmma(packed: torch.Tensor, C: int, F_out: int) -> torch.Tensor:
    """``pack_conv3x3_weights_wgmma``'s output back to [3, 3, C, F]."""
    q, nft, _, nt, _ = packed.shape
    v = _swizzle128(packed).permute(0, 2, 4, 1, 3)  # [q, atom, k, F'/nt, n]
    rows = v.reshape(q, _KATOMS * 64, nft * nt)[:, :288]
    return _rows_to_weight(rows, C, F_out)


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
    does (in bf16, w goes to the kernel repacked for the form
    ``conv3x3_route`` picks, once per parameter version; the wgmma form's
    block owns 64 output channels where F = 64, else 128). → [B, H, W, F] in
    x's dtype."""
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bt = None if b is None else b.to(x.dtype).contiguous()
    y = torch.empty((B, H, W, Fo), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        route = conv3x3_route(Fo)
        if route == "wgmma":
            nt = 64 if Fo <= 64 else 128
            wt = _derived.get(f"conv3x3:wgmma:{nt}", (w,),
                              lambda: pack_conv3x3_weights_wgmma(w.to(x.dtype), nt))
        else:
            nt = 32
            wt = _derived.get("conv3x3:mma", (w,), lambda: pack_conv3x3_weights(w.to(x.dtype)))
        _build.launch(
            "conv3x3", "dmn_conv3x3_bf16", [_VP] * 4 + [_CI] * 7 + [_VP],
            x.data_ptr(), wt.data_ptr(), None if bt is None else bt.data_ptr(), y.data_ptr(),
            B, H, W, C, Fo, int(route == "wgmma"), nt, stream,
        )
    else:
        wt = w.to(x.dtype).contiguous()
        _build.launch(
            "conv3x3", "dmn_conv3x3_f32", [_VP] * 4 + [_CI] * 5 + [_VP],
            x.data_ptr(), wt.data_ptr(), None if bt is None else bt.data_ptr(), y.data_ptr(),
            B, H, W, C, Fo, stream,
        )
    LAUNCHES["conv3x3"] += 1
    return y
