"""Attention ops of the U-Net and the DiT: plain PyTorch versions, the JAX
package's dispatch rules, and the wrappers of the hand-written Hopper
kernels (``csrc/linear_attention.cu``, ``csrc/attention_block_small.cu``,
``csrc/attention.cu``).

Counterpart of ``diffusion_model_nemo_tpu/ops/attention.py``. The dispatch
rules keep the JAX package's shape and dtype conditions, so each U-Net level
and each DiT block reaches the same kernel as on the TPU; where the JAX
package runs an XLA composition (linear attention at N < 64, softmax
attention at N < 1024), the port runs its plain composition. Under a rule
that holds, a tensor on the CPU takes the plain version and a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from . import _build
from .recompute import kernel_call

__all__ = [
    "attention_reference",
    "linear_attention_reference",
    "linear_attention_qkv_reference",
    "linear_attention_tokens_reference",
    "linear_attention_block_reference",
    "attention_block_reference",
    "use_packed_linattn_block",
    "use_linattn_tokens",
    "use_small_attn_block",
    "use_attention_kernel",
    "use_linattn_block_v1",
    "fused_attention",
    "fused_linear_attention_qkv",
    "fused_linear_attention_tokens",
    "fused_linear_attention_block_packed",
    "fused_linear_attention_block",
    "fused_attention_block_small",
    "linear_attention_block_cuda",
    "linear_attention_block_v1_cuda",
    "linear_attention_tokens_cuda",
    "attention_block_small_cuda",
    "linear_attention_qkv_cuda",
    "attention_cuda",
    "LAUNCHES",
]

# Launches of each kernel, counted where its wrapper launches it.
LAUNCHES = {
    "linear_attention_block": 0,
    "linear_attention_block_v1": 0,
    "linear_attention_tokens": 0,
    "attention_block_small": 0,
    "linear_attention_qkv": 0,
    "attention": 0,
}

_MAX_KERNEL_TOKENS = 4096
_MIN_KERNEL_TOKENS = 64
_MIN_ATTN_KERNEL_TOKENS = 1024


# ------------------------------------------------------------ plain versions --
def _gn1(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """flax ``GroupNorm(num_groups=1)`` on [B, N, C]: float32 one-pass stats
    over (N, C) clipped at zero, float32 normalize + affine, cast back."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, N, h, d] (q pre-scaled) → [B, N, h, d]: max-subtracted softmax
    attention with float32 scores and accumulation."""
    sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float())
    sim = sim - sim.amax(dim=-1, keepdim=True)
    attn = torch.softmax(sim, dim=-1).to(q.dtype)
    out = torch.einsum("bhij,bjhd->bihd", attn.float(), v.float())
    return out.to(q.dtype)


def linear_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, N, h, d] (q softmaxed over d and scaled, k softmaxed over N) →
    [B, N, h, d]: per-head context kᵀv, rounded to the input dtype, then q·context."""
    context = torch.einsum("bnhd,bnhe->bhde", k.float(), v.float()).to(q.dtype)
    out = torch.einsum("bhde,bnhd->bnhe", context.float(), q.float())
    return out.to(q.dtype)


def linear_attention_qkv_reference(
    qkv: torch.Tensor, heads: int, dim_head: int, scale: float
) -> torch.Tensor:
    """Raw qkv [B, N, 3·h·d] → [B, N, h·d]: q softmax over d per head ×scale,
    k softmax over N, then the per-head linear attention."""
    B, N, _ = qkv.shape
    hd = heads * dim_head
    q = qkv[..., :hd].reshape(B, N, heads, dim_head)
    k = qkv[..., hd : 2 * hd].reshape(B, N, heads, dim_head)
    v = qkv[..., 2 * hd :].reshape(B, N, heads, dim_head)
    q = torch.softmax(q.float(), dim=-1) * scale
    k = torch.softmax(k.float(), dim=1)
    out = linear_attention_reference(q.to(qkv.dtype), k.to(qkv.dtype), v)
    return out.reshape(B, N, hd)


def linear_attention_tokens_reference(
    h: torch.Tensor, w_qkv: torch.Tensor, heads: int, dim_head: int, scale: float
) -> torch.Tensor:
    """Pre-normed tokens [B, N, C] · W_qkv [C, 3·h·d] → linear attention →
    [B, N, h·d] (the plain version of the qkv-fused kernel)."""
    qkv = h @ w_qkv.to(h.dtype)
    return linear_attention_qkv_reference(qkv, heads, dim_head, scale)


def linear_attention_block_reference(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Whole ``Residual(PreNorm(LinearAttention))`` on [B, N, C]: GroupNorm(1)
    → qkv → linear attention → out projection + bias → GroupNorm(1) → + x,
    with the module composition's casts at each seam."""
    h = _gn1(x, norm_gamma, norm_beta, eps)
    attn = linear_attention_tokens_reference(h, w_qkv, heads, dim_head, scale)
    out = attn.to(x.dtype) @ w_out.to(x.dtype) + b_out.to(x.dtype)
    out = _gn1(out, out_gamma, out_beta, eps)
    return out + x


def attention_block_reference(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """``Residual(PreNorm(Attention))`` on [B, N, C]: GroupNorm(1) → qkv →
    softmax attention → out projection + bias → + x (no out-norm)."""
    B, N, C = x.shape
    hd = heads * dim_head
    h = _gn1(x, norm_gamma, norm_beta, eps)
    qkv = (h @ w_qkv.to(h.dtype)).reshape(B, N, 3, heads, dim_head)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = attention_reference(q * scale, k, v).to(x.dtype).reshape(B, N, hd)
    out = out @ w_out.to(x.dtype) + b_out.to(x.dtype)
    return out + x


# ----------------------------------------------------------- dispatch rules --
def use_packed_linattn_block(shape, dtype, heads: int, dim_head: int) -> bool:
    """The JAX package's rule for the whole-block linear-attention kernel
    (``use_packed_linattn_block``): bf16, C divides 128, N·C/128 ≥ 64."""
    if dtype != torch.bfloat16:
        return False
    B, N, C = shape
    return (
        (heads * dim_head) % 128 == 0
        and C <= 128
        and 128 % C == 0
        and (N * C) % 128 == 0
        and (N * C) // 128 >= 64
        and _MIN_KERNEL_TOKENS <= N <= _MAX_KERNEL_TOKENS
    )


def use_linattn_tokens(shape, dtype, heads: int, dim_head: int) -> bool:
    """The JAX package's rule for the qkv-fused linear-attention kernel
    (``_use_pallas_linattn_tokens``): bf16 and 64 ≤ N ≤ 4096, N % 8 == 0."""
    return dtype == torch.bfloat16 and _use_linattn_qkv_kernel(shape, heads, dim_head)


def _use_linattn_qkv_kernel(shape, heads: int, dim_head: int) -> bool:
    """The JAX package's rule for TPU kernel #8 (``_use_pallas_linattn``):
    no dtype condition, so it is the float32 route at N ≥ 64."""
    B, N, _ = shape
    return (
        (heads * dim_head) % 128 == 0
        and N % 8 == 0
        and _MIN_KERNEL_TOKENS <= N <= _MAX_KERNEL_TOKENS
    )


def use_small_attn_block(shape, dtype, heads: int, dim_head: int) -> bool:
    """The JAX package's rule for the bottleneck attention-block kernel
    (``use_small_attn_block``): bf16, 8 ≤ N ≤ 64, N % 8 == 0, heads·N ≤ 512."""
    if dtype != torch.bfloat16:
        return False
    B, N, C = shape
    return (heads * dim_head) % 128 == 0 and N % 8 == 0 and 8 <= N <= 64 and heads * N <= 512


def use_linattn_block_v1(shape, dtype, heads: int, dim_head: int) -> bool:
    """The JAX package's rule for the whole-block kernel #9
    (``_use_pallas_linattn_block``) as it reads on a TPU: bf16, 64 ≤ N ≤ 4096,
    N % 8 == 0, h·d % 128 == 0, unless ``DMN_TPU_PALLAS_LINATTN=0``."""
    if os.environ.get("DMN_TPU_PALLAS_LINATTN") == "0" or dtype != torch.bfloat16:
        return False
    return _use_linattn_qkv_kernel(shape, heads, dim_head)


def use_attention_kernel(shape) -> bool:
    """The JAX package's rule for the softmax-attention kernel (``_use_pallas``
    without its ``DMN_TPU_PALLAS_ATTN`` opt-in): 1024 ≤ N ≤ 4096 on
    [B, N, h, d], any dtype."""
    return _MIN_ATTN_KERNEL_TOKENS <= shape[1] <= _MAX_KERNEL_TOKENS


# -------------------------------------------------------------- entry points --
# Each kernel route is differentiable (``recompute.kernel_call``): its
# backward recomputes the plain version, as the JAX package's custom_vjp does.
def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, N, h, d] (q pre-scaled) → [B, N, h, d]; k and v may be strided
    views (the DiT's qkv slices)."""
    if use_attention_kernel(q.shape):
        return kernel_call(attention_cuda, attention_reference, q, k, v)
    return attention_reference(q, k, v)


def fused_linear_attention_qkv(
    qkv: torch.Tensor, heads: int, dim_head: int, scale: float
) -> torch.Tensor:
    """Raw qkv [B, N, 3·h·d] → [B, N, h·d] (the float32 U-Net's route at
    N ≥ 64, and any dtype the caller sends)."""
    if _use_linattn_qkv_kernel(qkv.shape, heads, dim_head):
        return kernel_call(
            linear_attention_qkv_cuda, linear_attention_qkv_reference, qkv, heads, dim_head, scale
        )
    return linear_attention_qkv_reference(qkv, heads, dim_head, scale)


def fused_linear_attention_tokens(
    h: torch.Tensor, w_qkv: torch.Tensor, heads: int, dim_head: int, scale: float
) -> torch.Tensor:
    """Pre-normed tokens [B, N, C] + W_qkv [C, 3·h·d] → [B, N, h·d]."""
    if use_linattn_tokens(h.shape, h.dtype, heads, dim_head):
        return kernel_call(
            linear_attention_tokens_cuda, linear_attention_tokens_reference,
            h, w_qkv, heads, dim_head, scale,
        )
    qkv = h @ w_qkv.to(h.dtype)
    return fused_linear_attention_qkv(qkv, heads, dim_head, scale)


def fused_linear_attention_block_packed(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Whole ``Residual(PreNorm(LinearAttention))`` block on [B, N, C]
    where ``use_packed_linattn_block`` holds (callers check it first)."""
    return kernel_call(
        linear_attention_block_cuda, linear_attention_block_reference,
        x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
        heads, dim_head, scale, eps,
    )


def fused_linear_attention_block(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """The same block through TPU kernel #9 (v1, prenorm affine unfolded)
    where ``use_linattn_block_v1`` holds, else the plain composition, as the
    JAX package's ``fused_linear_attention_block`` (the module's route
    under ``DMN_TPU_PALLAS_LINATTN_BLOCK=1``)."""
    args = (x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
            heads, dim_head, scale, eps)
    if use_linattn_block_v1(x.shape, x.dtype, heads, dim_head):
        return kernel_call(linear_attention_block_v1_cuda, linear_attention_block_reference, *args)
    return linear_attention_block_reference(*args)


def fused_attention_block_small(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Whole bottleneck ``Residual(PreNorm(Attention))`` block on [B, N, C]
    where ``use_small_attn_block`` holds (callers check it first)."""
    return kernel_call(
        attention_block_small_cuda, attention_block_reference,
        x, norm_gamma, norm_beta, w_qkv, w_out, b_out, heads, dim_head, scale, eps,
    )


# ------------------------------------------------------------ kernel wrappers --
_VP, _CI, _CF, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_tokens(x: torch.Tensor, heads: int, dim_head: int, what: str) -> Tuple[int, int, int]:
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bf16 tokens, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous [B, N, C] tokens, got {tuple(x.shape)}")
    if (heads, dim_head) != (4, 32):
        raise ValueError(f"{what} is built for 4 heads x 32, got {heads} x {dim_head}")
    return tuple(x.shape)


def _fold_prenorm(norm_gamma, norm_beta, w_qkv) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold GroupNorm(1)'s affine into the qkv projection, as the TPU kernels
    do: h·W = ((x−μ)·rstd)·(γ∘W) + β·W. Weights only."""
    w = w_qkv.float()
    return (
        (norm_gamma.float()[:, None] * w).to(torch.bfloat16).contiguous(),
        (norm_beta.float() @ w).contiguous(),
    )


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _linattn_scratch(B: int, N: int, C: int, block: bool, device) -> torch.Tensor:
    lib = _build.library("linear_attention")
    fn = lib.dmn_linattn_scratch_floats
    fn.argtypes = [_CI, _CI, _CI, _CI]
    fn.restype = ctypes.c_long
    return torch.empty(fn(B, N, C, int(block)), dtype=torch.float32, device=device)


def linear_attention_block_cuda(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Launch the whole-block linear-attention kernel on bf16 [B, N, C]."""
    B, N, C = _check_tokens(x, heads, dim_head, "linear_attention_block_cuda")
    hd = heads * dim_head
    if w_qkv.shape != (C, 3 * hd) or w_out.shape != (hd, C):
        raise ValueError(f"weights {tuple(w_qkv.shape)}, {tuple(w_out.shape)} do not fit C={C}")
    wq, bq = _fold_prenorm(norm_gamma, norm_beta, w_qkv)
    wo = w_out.to(torch.bfloat16).contiguous()
    bo, og, ob = _f32(b_out), _f32(out_gamma), _f32(out_beta)
    out = torch.empty_like(x)
    scratch = _linattn_scratch(B, N, C, True, x.device)
    _build.launch(
        "linear_attention", "dmn_linattn_block",
        [_VP] * 9 + [_CI, _CI, _CI, _CF, _CF, _VP],
        x.data_ptr(), wq.data_ptr(), bq.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        og.data_ptr(), ob.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, N, C, scale, eps, _stream(x),
    )
    LAUNCHES["linear_attention_block"] += 1
    return out


def linear_attention_block_v1_cuda(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Launch the whole-block kernel v1 (TPU kernel #9) on bf16 [B, N, C]:
    the prenorm affine is applied in f32 before the bf16 qkv product, not
    folded into W_qkv."""
    B, N, C = _check_tokens(x, heads, dim_head, "linear_attention_block_v1_cuda")
    hd = heads * dim_head
    if w_qkv.shape != (C, 3 * hd) or w_out.shape != (hd, C):
        raise ValueError(f"weights {tuple(w_qkv.shape)}, {tuple(w_out.shape)} do not fit C={C}")
    smem = 4 * (32 * C + 2 * 32 * hd + 4 * 32 * 32)  # the apply stage's tiles
    if smem > _SMEM_LIMIT:
        raise ValueError(f"C={C} needs {smem} B of shared memory (> {_SMEM_LIMIT})")
    wq = w_qkv.to(torch.bfloat16).contiguous()
    wo = w_out.to(torch.bfloat16).contiguous()
    ng, nb, bo, og, ob = (_f32(t) for t in (norm_gamma, norm_beta, b_out, out_gamma, out_beta))
    out = torch.empty_like(x)
    scratch = _linattn_scratch(B, N, C, True, x.device)
    _build.launch(
        "linear_attention", "dmn_linattn_block_v1",
        [_VP] * 10 + [_CI, _CI, _CI, _CF, _CF, _VP],
        x.data_ptr(), ng.data_ptr(), nb.data_ptr(), wq.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        og.data_ptr(), ob.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, N, C, scale, eps, _stream(x),
    )
    LAUNCHES["linear_attention_block_v1"] += 1
    return out


def linear_attention_tokens_cuda(
    h: torch.Tensor, w_qkv: torch.Tensor, heads: int, dim_head: int, scale: float
) -> torch.Tensor:
    """Launch the qkv-fused linear-attention kernel on bf16 [B, N, C]."""
    B, N, C = _check_tokens(h, heads, dim_head, "linear_attention_tokens_cuda")
    hd = heads * dim_head
    if w_qkv.shape != (C, 3 * hd):
        raise ValueError(f"w_qkv {tuple(w_qkv.shape)} does not fit C={C}")
    wq = w_qkv.to(torch.bfloat16).contiguous()
    out = torch.empty((B, N, hd), dtype=torch.bfloat16, device=h.device)
    scratch = _linattn_scratch(B, N, C, False, h.device)
    _build.launch(
        "linear_attention", "dmn_linattn_tokens",
        [_VP] * 4 + [_CI, _CI, _CI, _CF, _VP],
        h.data_ptr(), wq.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, N, C, scale, _stream(h),
    )
    LAUNCHES["linear_attention_tokens"] += 1
    return out


_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def attention_block_small_cuda(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Launch the bottleneck attention-block kernel on bf16 [B, N, C]."""
    B, N, C = _check_tokens(x, heads, dim_head, "attention_block_small_cuda")
    hd = heads * dim_head
    if w_qkv.shape != (C, 3 * hd) or w_out.shape != (hd, C):
        raise ValueError(f"weights {tuple(w_qkv.shape)}, {tuple(w_out.shape)} do not fit C={C}")
    smem = 4 * (max(N * C, heads * N * N) + 4 + N * (3 * hd + 1)) + 256
    if smem > _SMEM_LIMIT:
        raise ValueError(f"[N={N}, C={C}] needs {smem} B of shared memory (> {_SMEM_LIMIT})")
    wq, bq = _fold_prenorm(norm_gamma, norm_beta, w_qkv)
    wo = w_out.to(torch.bfloat16).contiguous()
    bo = _f32(b_out)
    out = torch.empty_like(x)
    _build.launch(
        "attention_block_small", "dmn_attn_block_small",
        [_VP] * 6 + [_CI, _CI, _CI, _CF, _CF, _VP],
        x.data_ptr(), wq.data_ptr(), bq.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        out.data_ptr(), B, N, C, scale, eps, _stream(x),
    )
    LAUNCHES["attention_block_small"] += 1
    return out


def linear_attention_qkv_cuda(
    qkv: torch.Tensor, heads: int, dim_head: int, scale: float
) -> torch.Tensor:
    """Launch the raw-qkv linear-attention kernel (TPU kernel #8) on a
    contiguous float32 or bf16 [B, N, 384] tensor → [B, N, 128]."""
    if not qkv.is_cuda:
        raise ValueError(f"linear_attention_qkv_cuda needs a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"linear_attention_qkv_cuda takes float32 or bf16, got {qkv.dtype}")
    if (heads, dim_head) != (4, 32):
        raise ValueError(f"linear_attention_qkv_cuda is built for 4 heads x 32, got {heads} x {dim_head}")
    hd = heads * dim_head
    if qkv.ndim != 3 or qkv.shape[-1] != 3 * hd or not qkv.is_contiguous():
        raise ValueError(f"linear_attention_qkv_cuda takes contiguous [B, N, {3 * hd}], got {tuple(qkv.shape)}")
    B, N, _ = qkv.shape
    out = torch.empty((B, N, hd), dtype=qkv.dtype, device=qkv.device)
    scratch = _linattn_scratch(B, N, 0, False, qkv.device)
    _build.launch(
        "linear_attention", "dmn_linattn_qkv",
        [_VP] * 3 + [_CI, _CI, _CI, _CF, _VP],
        qkv.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, N, int(qkv.dtype == torch.bfloat16), scale, _stream(qkv),
    )
    LAUNCHES["linear_attention_qkv"] += 1
    return out


_ATTN_HEAD_DIMS = (32, 64, 128)


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the softmax-attention kernel (TPU kernel #7) on float32 or bf16
    [B, N, h, d] tensors (q pre-scaled), read in place with their strides
    (unit stride along d) → contiguous [B, N, h, d]."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"attention_cuda needs a CUDA tensor, got {name} on {t.device}")
        if t.dtype != q.dtype or t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"attention_cuda takes float32 or bf16 q, k, v of one dtype, got {name} {t.dtype}")
        if t.shape != q.shape or t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(
                f"attention_cuda takes [B, N, h, d] q, k, v with unit stride along d, got {name} "
                f"{tuple(t.shape)} strides {t.stride()}"
            )
    B, N, H, D = q.shape
    if D not in _ATTN_HEAD_DIMS:
        raise ValueError(f"attention_cuda is built for head dims {_ATTN_HEAD_DIMS}, got [B, N, h, d] = {list(q.shape)}")
    if B * H > 65535:
        raise ValueError(f"attention_cuda takes at most 65535 (sample, head) pairs, got {B} x {H}")
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    _build.launch(
        "attention", "dmn_attention",
        [_VP] * 4 + [_LL] * 9 + [_CI] * 5 + [_VP],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        B, N, H, D, int(q.dtype == torch.bfloat16), _stream(q),
    )
    LAUNCHES["attention"] += 1
    return out
