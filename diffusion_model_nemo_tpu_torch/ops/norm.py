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
import dataclasses
import functools
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
    "group_norm_plan",
    "GroupNormPlan",
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


# ------------------------------------------------------ kernel #1/#5's plan --
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 CTA may use
_GN_THREADS = 256  # csrc/group_norm_silu.cu: THREADS
_GN_MAX_CLUSTER = 8  # the portable cluster size
_GN_SHARE_BYTES = 32 * 1024  # the most of a sample's slab one CTA takes: a cluster only above it
_GN_KREG = 4  # 16-byte pieces a thread holds in the register form
_GN_FORMS = ("twice", "shared", "registers")  # csrc/group_norm_silu.cu: Form


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """How kernel #1/#5 lays one sample's [HW, C] slab out: a cluster of
    ``cluster`` CTAs, CTA r owning pixels [r·pixels, (r+1)·pixels);
    ``vec``: 16-byte pieces (else one element a piece); ``smem_bytes`` of
    shared memory a CTA; ``form``: where a CTA keeps its share between the
    statistics and the output pass, ``"registers"`` (at most 4 pieces a
    thread), ``"shared"`` (shared memory) or ``"twice"`` (nowhere: read
    again, from L2)."""

    cluster: int
    pixels: int
    vec: bool
    smem_bytes: int
    form: str


def _group_norm_smem(C: int, pixels: int, form: str, esize: int, vec: bool) -> int:
    """Shared memory of one CTA of kernel #1/#5: the mirror of ``gn_layout``
    in ``csrc/group_norm_silu.cu`` (the C entry refuses a plan whose bytes
    differ). The share of x (form ``"shared"``, rounded up to 16 bytes),
    then f32 partials [2][rows][C] (rows = 256 / pieces a pixel, at least
    1), the reduction [2][S][C] (S = 256 / C, at least 1), the per-channel
    sums [2][C], γ, β and a per-sample FiLM [4][C] and the coefficients
    [2][C], the whole rounded up to 16 bytes."""
    pieces = C // (16 // esize) if vec else C
    rows = max(1, _GN_THREADS // pieces)
    S = max(1, _GN_THREADS // C)
    share = -(-pixels * C * esize // 16) * 16 if form == "shared" else 0
    return -(-(share + 4 * (2 * rows * C + 2 * S * C + 8 * C)) // 16) * 16


@functools.lru_cache(maxsize=None)  # a pure function of its arguments, asked for at every call
def group_norm_plan(HW: int, C: int, groups: int, dtype, vec: bool = True) -> GroupNormPlan:
    """Kernel #1/#5's launch plan for a sample of [HW, C] in ``dtype`` (bf16
    or float32): one CTA a sample up to a 32 KB slab, else a cluster of
    ``min(8, HW, ceil(slab bytes / 32 KB))`` CTAs, each owning
    ``ceil(HW / cluster)`` pixels (a cluster launch costs more than the SMs
    it fills at these sizes); the share in registers where a thread holds at
    most 4 of its 16-byte pieces, else in shared memory where it fits one
    H100 CTA's 232,448 bytes with the reduction arrays, else read twice.
    ``vec`` (16-byte pieces) needs C·itemsize % 16 == 0. Raises
    ``ValueError`` only where even the per-channel arrays do not fit (C
    above ~4,800)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the GroupNorm kernel takes float32 or bf16, got {dtype}")
    if HW < 1 or C < 1 or groups < 1 or C % groups:
        raise ValueError(f"the GroupNorm kernel needs HW, C >= 1 and groups dividing C, got "
                         f"[HW={HW}, C={C}, groups={groups}]")
    esize = 2 if dtype == torch.bfloat16 else 4
    vec = vec and (C * esize) % 16 == 0
    cluster = min(_GN_MAX_CLUSTER, HW, max(1, -(-HW * C * esize // _GN_SHARE_BYTES)))
    pixels = -(-HW // cluster)
    cluster = -(-HW // pixels)
    forms = ["shared", "twice"]
    pieces = C * esize // 16
    if vec and pieces <= _GN_THREADS and -(-pixels // (_GN_THREADS // pieces)) <= _GN_KREG:
        forms.insert(0, "registers")
    for form in forms:
        smem = _group_norm_smem(C, pixels, form, esize, vec)
        if smem <= _SMEM_LIMIT:
            return GroupNormPlan(cluster, pixels, vec, smem, form)
    raise ValueError(
        f"the GroupNorm kernel at [HW={HW}, C={C}] {str(dtype).removeprefix('torch.')} needs {smem} B "
        f"of shared memory a CTA for its per-channel arrays (> {_SMEM_LIMIT})"
    )


def _launch(x: torch.Tensor, gamma, beta, groups: int, eps: float, film) -> torch.Tensor:
    """One launch of kernel #1/#5 on checked NHWC ``x``; ``film`` = (scale,
    shift, scale strides (sample, pixel), shift strides, film dtype code),
    or None."""
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    vec = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = group_norm_plan(H * W, C, groups, x.dtype, vec)
    if film is None:
        film = (None, None, 0, 0, 0, 0, 0)
    _build.launch(
        "group_norm_silu", "dmn_group_norm_silu",
        [_VP] * 5 + [_CL] * 4 + [_VP] + [_CI] * 4 + [_CF] + [_CI] * 7 + [_VP],
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *film[:6], out.data_ptr(),
        B, H * W, C, groups, eps, _DTYPE_CODES[x.dtype], film[6], int(plan.vec), plan.cluster,
        plan.pixels, _GN_FORMS.index(plan.form), plan.smem_bytes, _stream(x),
    )
    return out


def group_norm_silu_cuda(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float = 1e-5
) -> torch.Tensor:
    """Launch kernel #1 (GroupNorm+SiLU) on NHWC ``x`` (bf16 or f32): one
    launch, a sample on one CTA or a thread-block cluster
    (``group_norm_plan``)."""
    _check(x, gamma, beta, groups, "group_norm_silu_cuda")
    out = _launch(x, gamma, beta, groups, eps, None)
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
    """Launch kernel #5 (GroupNorm+FiLM+SiLU), #1's kernel with FiLM, on
    NHWC ``x``; ``scale`` and ``shift`` broadcast to x's shape ([B,1,1,C],
    [B,H,W,C], ...), float32 or x's dtype, read in place where their strides
    allow (a per-sample FiLM is folded into the per-channel coefficients)."""
    _check(x, gamma, beta, groups, "group_norm_silu_film_cuda")
    sc, sh = _film_view(scale, x, "scale"), _film_view(shift, x, "shift")
    if sc.dtype != sh.dtype:
        sh = sh.to(sc.dtype)
    film = (sc.data_ptr(), sh.data_ptr(), sc.stride(0), sc.stride(2), sh.stride(0), sh.stride(2),
            int(sc.dtype == torch.bfloat16))
    out = _launch(x, gamma, beta, groups, eps, film)
    LAUNCHES["group_norm_silu_film"] += 1
    return out


_BM_SLAB_BYTES = _BM_VMEM_BYTES // _BM_LANES  # a sample's [HW, C] slab: kernel #6 holds it in shared memory


def group_norm_silu_bm_cuda(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch kernel #6 (batch-minor GroupNorm(+FiLM)+SiLU) on NHWC ``x``:
    one block per sample holds the sample's [HW, C] slab (at most 96 KiB, the
    gate's bound) in shared memory, so x is read once and y written once,
    with no transpose. FiLM scale/shift hold B·C elements (per sample and
    channel), float32 or x's dtype, read in place through their (sample,
    channel) strides."""
    what = "group_norm_silu_bm_cuda"
    B, H, W, C = _check(x, gamma, beta, groups, what)
    if C > 512 or H * W * C * x.element_size() > _BM_SLAB_BYTES:
        raise ValueError(f"{what} holds a sample in shared memory: C <= 512 and H*W*C*itemsize <= "
                         f"{_BM_SLAB_BYTES} bytes, got {tuple(x.shape)} {x.dtype}")
    film = (None, None, 0, 0, 0, 0)
    film_bf16 = 0
    if scale is not None:
        if scale.numel() != B * C or shift.numel() != B * C:
            raise ValueError(f"FiLM scale/shift must hold B*C = {B * C} elements per sample and channel")
        sc, sh = (_film_per_sample(t, x, name) for t, name in ((scale, "scale"), (shift, "shift")))
        if sc.dtype != sh.dtype:
            sh = sh.to(sc.dtype)
        film = (sc.data_ptr(), sh.data_ptr(), sc.stride(0), sc.stride(1), sh.stride(0), sh.stride(1))
        film_bf16 = int(sc.dtype == torch.bfloat16)
    out = torch.empty_like(x)
    _build.launch(
        "group_norm_bm", "dmn_group_norm_bm",
        [_VP] * 6 + [_CL] * 4 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
        x.data_ptr(), out.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *film,
        B, H * W, C, groups, eps, _DTYPE_CODES[x.dtype], film_bf16, _stream(x),
    )
    LAUNCHES["group_norm_silu_bm"] += 1
    return out


def _film_per_sample(t: torch.Tensor, x: torch.Tensor, name: str) -> torch.Tensor:
    """A B·C-element FiLM tensor as a [B, C] view (a copy only where no
    view has those two strides), in float32 or x's dtype (another dtype is
    cast to float32)."""
    if t.device != x.device:
        raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    v = t.reshape(x.shape[0], x.shape[3])
    return v if v.dtype in (torch.float32, x.dtype) else v.float()
