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
import dataclasses
import functools
import os
from typing import Tuple

import torch

from . import _build
from .recompute import kernel_call
from .weights import _derived, fragment_order, fragment_order_inverse

__all__ = [
    "attention_reference",
    "linear_attention_reference",
    "linear_attention_qkv_reference",
    "linear_attention_qkv_fused_reference",
    "linear_attention_tokens_reference",
    "linear_attention_tokens_fused_reference",
    "linear_attention_block_reference",
    "attention_block_reference",
    "use_packed_linattn_block",
    "use_linattn_tokens",
    "use_small_attn_block",
    "use_attention_kernel",
    "use_linattn_block_v1",
    "linear_attention_v4_reference",
    "linear_attention_v4_fused_reference",
    "linear_attention_block_v2_reference",
    "linear_attention_block_packed_reference",
    "linattn_block_plan",
    "LinattnBlockPlan",
    "fused_attention",
    "fused_linear_attention_qkv",
    "fused_linear_attention_tokens",
    "fused_linear_attention_block_packed",
    "fused_linear_attention_block",
    "fused_attention_block_small",
    "linear_attention_block_v2",
    "linear_attention_v4",
    "linear_attention_block_cuda",
    "linear_attention_block_v1_cuda",
    "linear_attention_block_v2_cuda",
    "linear_attention_v4_cuda",
    "linear_attention_tokens_cuda",
    "attention_block_small_cuda",
    "linear_attention_qkv_cuda",
    "attention_cuda",
    "check_attention_alignment",
    "small_block_smem_bytes",
    "fragment_order",
    "fragment_order_inverse",
    "LAUNCHES",
]

# Launches of each kernel, counted where its wrapper launches it.
LAUNCHES = {
    "linear_attention_block": 0,
    "linear_attention_block_v1": 0,
    "linear_attention_block_v2": 0,
    "linear_attention_v4": 0,
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


def linear_attention_qkv_fused_reference(
    qkv: torch.Tensor, heads: int, dim_head: int, scale: float, acc=torch.float32
) -> torch.Tensor:
    """The raw-qkv core with TPU kernel #8's seams (``_linattn_kernel``): q, k
    and v taken in f32; q softmax over each head with one max over the
    token's h·d columns, ×scale; k softmax over N; the per-head gram kᵀ_sm·v
    and q_sm·gram in f32, cast to qkv's dtype once. What kernel #8 is held
    against on the card. The module composition
    (``linear_attention_qkv_reference``) rounds q_sm, k_sm and the context to
    bf16: at outputs under 0.1 about a third of its elements sit one bf16
    step from the kernel's function. In float32 the two are the same math.
    ``acc=torch.float64`` keeps every sum in float64 between the same
    roundings (the seam check's yardstick, free of float32 summation
    order)."""
    return _attend(qkv.to(acc), torch.float32, heads, dim_head, scale).to(qkv.dtype)


def linear_attention_tokens_reference(
    h: torch.Tensor, w_qkv: torch.Tensor, heads: int, dim_head: int, scale: float
) -> torch.Tensor:
    """Pre-normed tokens [B, N, C] · W_qkv [C, 3·h·d] → linear attention →
    [B, N, h·d] (the plain version of the qkv-fused kernel)."""
    qkv = h @ w_qkv.to(h.dtype)
    return linear_attention_qkv_reference(qkv, heads, dim_head, scale)


def linear_attention_tokens_fused_reference(
    h: torch.Tensor, w_qkv: torch.Tensor, heads: int, dim_head: int, scale: float, acc=torch.float32
) -> torch.Tensor:
    """The qkv-fused core with TPU kernel #3's seams (``_linattn_qkv_fused_kernel``):
    qkv = h·W_qkv in f32 from operands in h's dtype, then ``_attend`` (q_sm,
    k_sm after the softmax over all N, v and the per-head gram rounded to
    h's dtype), q_sm·gram in f32 cast once. What kernel #3 is held against
    on the card. The module composition (``linear_attention_tokens_reference``)
    rounds qkv to bf16 before both softmaxes instead: at outputs under 0.1
    about half its elements sit one bf16 step from the kernel's function.
    ``acc=torch.float64`` keeps every sum in float64 between the same
    roundings (the seam check's yardstick, free of float32 summation
    order)."""
    dt = h.dtype
    qkv = h.to(acc) @ w_qkv.to(dt).to(acc)
    return _attend(qkv, dt, heads, dim_head, scale).to(dt)


def linear_attention_v4_reference(
    x_packed: torch.Tensor, w_qkv: torch.Tensor, n_tokens: int, heads: int, dim_head: int,
    scale: float,
) -> torch.Tensor:
    """Tokens [B, N, C] viewed lane-packed as [B, N·C/128, 128] → [B, N, h·d]:
    the view back to token rows, then ``linear_attention_tokens_reference``."""
    h = x_packed.reshape(x_packed.shape[0], n_tokens, -1)
    return linear_attention_tokens_reference(h, w_qkv, heads, dim_head, scale)


def linear_attention_v4_fused_reference(
    x_packed: torch.Tensor, w_qkv: torch.Tensor, n_tokens: int, heads: int, dim_head: int,
    scale: float, acc=torch.float32,
) -> torch.Tensor:
    """#12 with the TPU kernel's seams (``_v4_kernel``: #3's math on the
    packed view): the view back to token rows, then
    ``linear_attention_tokens_fused_reference``."""
    h = x_packed.reshape(x_packed.shape[0], n_tokens, -1)
    return linear_attention_tokens_fused_reference(h, w_qkv, heads, dim_head, scale, acc)


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


def linear_attention_block_v2_reference(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """The whole block with TPU kernel #10's seams (``_linattn_block_kernel_v2``):
    every product takes operands in x's dtype with f32 sums (h, q_sm, k_sm,
    v, the per-head gram and attn rounded to it; q's softmax with one row max
    over all h·d columns), while the norms, the out projection's sum, the
    out-norm and the residual stay f32 and are cast to x's dtype once. In
    float32 it is ``linear_attention_block_reference``'s math. In bf16 that
    composition also rounds the out projection and the out-norm's output
    before a bf16 residual add, and so lands up to ~2 bf16 steps from the
    exact block where the out-norm's output cancels x; v2 does not."""
    dt = x.dtype
    h = _gn1(x.float(), norm_gamma, norm_beta, eps).to(dt).float()
    qkv = h @ w_qkv.to(dt).float()
    return _block_from_qkv(x, qkv, w_out, b_out, out_gamma, out_beta, heads, dim_head, scale, eps)


def linear_attention_block_packed_reference(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """The whole block with TPU kernel #2's seams (``_linattn_block_packed_kernel``):
    the prenorm's (x − μ)·rstd rounded to x's dtype, then the folded affine
    h·(γ∘W_qkv) + β·W_qkv (γ∘W_qkv rounded, β·W_qkv and the sum f32); from
    qkv on, #10's seams (``_block_from_qkv``): a row-max q softmax, k_sm, v,
    the masked gram and att rounded, f32 y, out-norm and residual, cast
    once. The module composition (``linear_attention_block_reference``)
    instead rounds after the affine and rounds y, the out-norm and the
    residual sum: up to two bf16 steps from this kernel's function."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 2), keepdim=True) - mean * mean, min=0.0)
    h = ((xf - mean) * torch.rsqrt(var + eps)).to(dt).float()
    w = w_qkv.float()
    qkv = h @ (norm_gamma.float()[:, None] * w).to(dt).float() + norm_beta.float() @ w
    return _block_from_qkv(x, qkv, w_out, b_out, out_gamma, out_beta, heads, dim_head, scale, eps)


def _block_from_qkv(x, qkv, w_out, b_out, out_gamma, out_beta, heads, dim_head, scale, eps):
    """The block after its f32 qkv [B, N, 3·h·d], as the whole-block kernels
    compute it: q softmax with one max over the token's h·d columns and
    per-head sums, ×scale; k softmax over N; q_sm, k_sm, v, the per-head gram
    and att rounded to x's dtype; y = att·W_out + b_out, the out-norm and the
    residual in f32, cast to x's dtype once."""
    dt = x.dtype
    attn = _attend(qkv, dt, heads, dim_head, scale).to(dt).float()
    y = attn @ w_out.to(dt).float() + b_out.float()
    return (_gn1(y, out_gamma, out_beta, eps) + x.float()).to(dt)


def _attend(qkv: torch.Tensor, dt, heads: int, dim_head: int, scale: float) -> torch.Tensor:
    """f32 qkv [B, N, 3·h·d] → f32 q_sm·gram [B, N, h·d], with the TPU
    kernels' seams: q softmax with one max over the token's h·d columns and
    per-head sums, ×scale; k softmax over N; q_sm, k_sm, v and the per-head
    gram rounded to ``dt``; the product in f32, not rounded. A float64 qkv
    keeps every sum in float64 between the same roundings."""
    B, N, _ = qkv.shape
    hd = heads * dim_head
    acc = qkv.dtype
    q, k, v = qkv.split(hd, dim=-1)
    qe = torch.exp(q - q.amax(dim=-1, keepdim=True)).reshape(B, N, heads, dim_head)
    q_sm = (qe / qe.sum(dim=-1, keepdim=True) * scale).to(dt).to(acc)
    k_sm = torch.softmax(k, dim=1).to(dt).to(acc).reshape(B, N, heads, dim_head)
    v = v.to(dt).to(acc).reshape(B, N, heads, dim_head)
    gram = torch.einsum("bnhd,bnhe->bhde", k_sm, v).to(dt).to(acc)
    return torch.einsum("bnhd,bhde->bnhe", q_sm, gram).reshape(B, N, hd)


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
    N ≥ 64, and any dtype the caller sends). The CPU and the backward's
    recompute take the module composition, as the JAX ``_linattn_bwd`` does."""
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


def linear_attention_block_v2(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """The whole block through TPU kernel #10 (v2) on float32 or bf16
    [B, N, C]: the JAX package's ``_pallas_linear_attention_block_v2``,
    reached only by its microbenchmark (``tools/microbench_attn.py``)."""
    return kernel_call(
        linear_attention_block_v2_cuda, linear_attention_block_v2_reference,
        x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
        heads, dim_head, scale, eps,
    )


def linear_attention_v4(
    x_packed: torch.Tensor, w_qkv: torch.Tensor, n_tokens: int, heads: int, dim_head: int,
    scale: float,
) -> torch.Tensor:
    """qkv projection + linear attention on tokens viewed lane-packed as
    [B, N·C/128, 128] → [B, N, h·d], through TPU kernel #12 (``v4_call`` of
    ``tools/microbench_attn_lanes.py``)."""
    return kernel_call(
        linear_attention_v4_cuda, linear_attention_v4_reference,
        x_packed, w_qkv, n_tokens, heads, dim_head, scale,
    )


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


def _check_tokens(
    x: torch.Tensor, heads: int, dim_head: int, what: str, dtypes=(torch.bfloat16,)
) -> Tuple[int, int, int]:
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{what} takes {names} tokens, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous [B, N, C] tokens, got {tuple(x.shape)}")
    if (heads, dim_head) != (4, 32):
        raise ValueError(f"{what} is built for 4 heads x 32, got {heads} x {dim_head}")
    return tuple(x.shape)


def _fold(norm_gamma, norm_beta, w_qkv) -> Tuple[torch.Tensor, torch.Tensor]:
    w = w_qkv.float()
    return (
        (norm_gamma.float()[:, None] * w).to(torch.bfloat16).contiguous(),
        (norm_beta.float() @ w).contiguous(),
    )


def _cast_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` contiguous in ``dtype``, kept per parameter version."""
    return _derived.get(f"cast:{dtype}", (w,), lambda: w.to(dtype).contiguous())


def _small_block_weights(norm_gamma, norm_beta, w_qkv, w_out, b_out):
    """Kernel #4's weight operands: γ∘W_qkv and W_out in bf16 in fragment
    order, β·W_qkv [3·hd] and b_out [C] in f32, kept per parameter version."""

    def make():
        wq, bq = _fold(norm_gamma, norm_beta, w_qkv)
        return fragment_order(wq), bq, fragment_order(w_out.to(torch.bfloat16)), _f32(b_out)

    return _derived.get("attn_block_small", (norm_gamma, norm_beta, w_qkv, w_out, b_out), make)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ------------------------------------------------- the whole-block kernel's plan --
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_BLOCK_TILE = 64  # tokens per tile (csrc/linear_attention.cu: TILE)
_BLOCK_MAX_CLUSTER = 8  # the portable cluster size
_BLOCK_TOKENS_PER_CTA = 128
_RAW_MAX_CLUSTER = 16  # the raw mode's largest cluster (csrc/linear_attention.cu: RAW_MAX_CLUSTER)
# The raw mode's largest N at 128 tokens a CTA. On the H100 at the U-Net's B = 64, half-size CTAs
# spill [64, 256] into a second, partial wave; from [64, 512] on, 64-token slabs at two CTAs an SM are
# the faster plan (``tools/check_linattn.py`` times both plans: ``[sweep]`` lines).
_RAW_WIDE_SLABS = 256


@dataclasses.dataclass(frozen=True)
class LinattnBlockPlan:
    """How the whole-block kernel (#2, #9, #10, in its core mode #3 and #12,
    in its raw mode #8) lays one sample out: a cluster of ``cluster`` CTAs,
    CTA r owning tokens [r·slab, (r+1)·slab); ``smem_bytes`` of shared memory
    a CTA; ``resident``: the slab's h (and, but in the core mode, f32 y; in
    the raw mode its q, k and v) stay in shared memory, else every stage
    reloads its tiles (x, and y is computed twice; the raw mode's k is read
    twice)."""

    cluster: int
    slab: int
    smem_bytes: int
    resident: bool


def _linattn_block_smem(C: int, slab: int, resident: bool, esize: int, core: bool = False) -> int:
    """Shared memory of one CTA of the whole-block kernel: the mirror of
    ``block_layout`` in ``csrc/linear_attention.cu`` (the C entries refuse a
    plan whose bytes differ). Regions, each rounded up to 16 bytes: 512 of
    reduction scratch, the k column statistics (4 × 128 f32), the gram
    [4][32][40], the k_sm|v / q tile [64][264] (which also holds the slab's
    f32 partial gram between stages), the attention-output tile [64][136]
    (all in x's dtype), h ([slab rounded up to 64] or [64] rows of C rounded
    up to 32, + 8) and, resident and not ``core``, f32 y [slab][C rounded up
    to 8]."""
    def take(n: int) -> int:
        return (n + 15) // 16 * 16

    hs = -(-C // 32) * 32 + 8
    c8 = -(-C // 8) * 8
    rows_h = -(-slab // _BLOCK_TILE) * _BLOCK_TILE if resident else _BLOCK_TILE
    rows_y = slab if resident and not core else 0
    return (take(512) + take(4 * 4 * 128) + take(4 * 32 * 40 * esize)
            + take(_BLOCK_TILE * 264 * esize) + take(_BLOCK_TILE * 136 * esize)
            + take(rows_h * hs * esize) + take(4 * rows_y * c8))


_RAW_GRAM_BYTES = 4 * (32 * (32 + 4) + 4) * 4  # the raw mode's f32 gram: 4 heads of 32 rows of 36, +4


def _linattn_raw_smem(slab: int, resident: bool, esize: int) -> int:
    """Shared memory of one CTA of the whole-block kernel's raw mode (#8): the
    mirror of ``raw_layout`` in ``csrc/linear_attention.cu``. Regions, each
    rounded up to 16 bytes: the k column statistics (4 × 128 f32), row group
    1's max and sum (2 × 128 f32), and k, v and q rows of 128 elements + 16
    bytes (the slab rounded up to 64 tokens where resident, else one
    64-token tile); k's and v's regions hold at least the f32 gram (18,496
    bytes), and an f32 region holds k_sm [rows][132] and then q_sm
    transposed [128][rows + 4]: k's own region in float32, one more in bf16."""
    def take(n: int) -> int:
        return (n + 15) // 16 * 16

    rows = -(-slab // _BLOCK_TILE) * _BLOCK_TILE if resident else _BLOCK_TILE
    tokens = rows * (128 + 16 // esize) * esize
    f32 = max(rows * 132 * 4, 128 * (rows + 4) * 4)
    k = max(tokens, _RAW_GRAM_BYTES, f32 if esize == 4 else 0)
    return (take(4 * 4 * 128) + take(2 * 4 * 128) + take(k) + take(max(tokens, _RAW_GRAM_BYTES))
            + take(tokens) + take(0 if esize == 4 else f32))


@functools.lru_cache(maxsize=None)  # a pure function of its arguments, asked for at every call
def linattn_block_plan(N: int, C: int, dtype, core: bool = False, raw: bool = False) -> LinattnBlockPlan:
    """The whole-block kernel's launch plan for [·, N, C] tokens of ``dtype``
    (bf16 or float32), in its core mode (#3, #12: no y kept) where ``core``,
    in its raw mode (#8: q, k and v loaded from [·, N, 384] rows, C = 384)
    where ``raw``: ``min(8, ceil(N / 128))`` CTAs a sample (raw: ``ceil(N /
    128)`` up to N = 256, else ``min(16, ceil(N / 64))``), each owning
    ``ceil(N / cluster)`` tokens; resident where that fits in one H100 CTA's
    232,448 bytes, else the recompute (raw: reload) form. Raises
    ``ValueError`` where even that form does not fit (C above 1280 in bf16,
    384 in float32; never in the raw mode): the wrappers never fall back."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the whole-block linear-attention kernel takes float32 or bf16, got {dtype}")
    if N < 1 or C < 1:
        raise ValueError(f"the whole-block linear-attention kernel needs N, C >= 1, got [N={N}, C={C}]")
    if raw and C != 384:
        raise ValueError(f"the raw-qkv mode takes [N, 384] qkv rows, got C={C}")
    if raw:  # up to N = 256 128 tokens a CTA (a CTA an SM), else 64 (two), on up to 16 CTAs
        per_cta = _BLOCK_TOKENS_PER_CTA if N <= _RAW_WIDE_SLABS else _BLOCK_TILE
        cluster = min(_RAW_MAX_CLUSTER, -(-N // per_cta))
    else:
        cluster = min(_BLOCK_MAX_CLUSTER, -(-N // _BLOCK_TOKENS_PER_CTA))
    slab = -(-N // cluster)
    esize = 2 if dtype == torch.bfloat16 else 4
    for resident in (True, False):
        smem = (_linattn_raw_smem(slab, resident, esize) if raw
                else _linattn_block_smem(C, slab, resident, esize, core))
        if smem <= _SMEM_LIMIT:
            return LinattnBlockPlan(cluster, slab, smem, resident)
    raise ValueError(
        f"the whole-block linear-attention kernel at [N={N}, C={C}] {str(dtype).removeprefix('torch.')} "
        f"needs {smem} B of shared memory a CTA even in its recompute form (> {_SMEM_LIMIT})"
    )


def _linattn_block_weights(folded: bool, dtype, norm_gamma, norm_beta, w_qkv, w_out):
    """The whole-block kernel's weight operands, kept per parameter version:
    W_qkv [C, 384] (γ∘W_qkv where ``folded``) and W_out [128, C] with zero
    columns up to C rounded to 8; in bf16 both in fragment order, in float32
    row major; and β·W_qkv [384] f32 where ``folded`` (else None)."""
    C = w_out.shape[1]
    sources = (norm_gamma, norm_beta, w_qkv, w_out) if folded else (w_qkv, w_out)

    def make():
        if folded:
            wq, bq = _fold(norm_gamma, norm_beta, w_qkv)
        else:
            wq, bq = w_qkv.to(dtype).contiguous(), None
        wo = torch.nn.functional.pad(w_out.to(dtype), (0, -C % 8))
        if dtype == torch.bfloat16:
            return fragment_order(wq), bq, fragment_order(wo)
        return wq.contiguous(), bq, wo.contiguous()

    return _derived.get(f"linattn_block:{int(folded)}:{dtype}", sources, make)


def _block_operands(what, dtypes, folded, x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma,
                    out_beta, heads: int, dim_head: int):
    """Checks, launch plan and operands of the whole-block kernel. The plan
    comes first, so a shape it refuses raises ``ValueError`` on any device.
    Returns (plan, (B, N, C), weights, f32 vectors, output)."""
    if x.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{what} takes {names} tokens, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"{what} takes contiguous [B, N, C] tokens, got {tuple(x.shape)}")
    plan = linattn_block_plan(x.shape[1], x.shape[2], x.dtype)
    B, N, C = _check_tokens(x, heads, dim_head, what, dtypes)
    hd = heads * dim_head
    if w_qkv.shape != (C, 3 * hd) or w_out.shape != (hd, C):
        raise ValueError(f"weights {tuple(w_qkv.shape)}, {tuple(w_out.shape)} do not fit C={C}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what} takes 16-byte aligned tokens, got {tuple(x.shape)} at {x.data_ptr():#x}")
    weights = _linattn_block_weights(folded, x.dtype, norm_gamma, norm_beta, w_qkv, w_out)
    vectors = tuple(_f32(t) for t in (norm_gamma, norm_beta, b_out, out_gamma, out_beta))
    return plan, (B, N, C), weights, vectors, torch.empty_like(x)


def _plan_args(plan: LinattnBlockPlan):
    return plan.cluster, plan.slab, int(plan.resident), plan.smem_bytes


def linear_attention_block_cuda(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Launch the whole-block linear-attention kernel (TPU kernel #2, the
    prenorm affine folded into W_qkv) on bf16 [B, N, C]: one launch, one
    thread-block cluster a sample (``linattn_block_plan``)."""
    plan, (B, N, C), (wq, bq, wo), (_ng, _nb, bo, og, ob), out = _block_operands(
        "linear_attention_block_cuda", (torch.bfloat16,), True,
        x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta, heads, dim_head,
    )
    _build.launch(
        "linear_attention", "dmn_linattn_block",
        [_VP] * 8 + [_CI] * 7 + [_CF, _CF, _VP],
        x.data_ptr(), wq.data_ptr(), bq.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        og.data_ptr(), ob.data_ptr(), out.data_ptr(), B, N, C, *_plan_args(plan), scale, eps, _stream(x),
    )
    LAUNCHES["linear_attention_block"] += 1
    return out


def _launch_unfolded(what, entry, dtypes, x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma,
                     out_beta, heads, dim_head, scale, eps):
    plan, (B, N, C), (wq, _bq, wo), (ng, nb, bo, og, ob), out = _block_operands(
        what, dtypes, False, x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
        heads, dim_head,
    )
    dtype_arg = [int(x.dtype == torch.bfloat16)] if entry == "dmn_linattn_block_v2" else []
    _build.launch(
        "linear_attention", entry,
        [_VP] * 9 + [_CI] * (7 + len(dtype_arg)) + [_CF, _CF, _VP],
        x.data_ptr(), ng.data_ptr(), nb.data_ptr(), wq.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        og.data_ptr(), ob.data_ptr(), out.data_ptr(), B, N, C, *dtype_arg, *_plan_args(plan),
        scale, eps, _stream(x),
    )
    return out


def linear_attention_block_v1_cuda(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Launch the whole-block kernel v1 (TPU kernel #9) on bf16 [B, N, C]:
    the prenorm affine is applied in f32 before the bf16 qkv product, not
    folded into W_qkv; #10's kernel and function in bf16."""
    out = _launch_unfolded(
        "linear_attention_block_v1_cuda", "dmn_linattn_block_v1", (torch.bfloat16,),
        x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta, heads, dim_head, scale, eps,
    )
    LAUNCHES["linear_attention_block_v1"] += 1
    return out


def linear_attention_block_v2_cuda(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Launch the whole-block kernel v2 (TPU kernel #10) on float32 or bf16
    [B, N, C]: every product's operands in x's dtype (the weights rounded to
    it), so float32 stays float32 throughout (its products on f32 FMAs); in
    bf16 it computes v1's function."""
    out = _launch_unfolded(
        "linear_attention_block_v2_cuda", "dmn_linattn_block_v2", _KERNEL_DTYPES,
        x, norm_gamma, norm_beta, w_qkv, w_out, b_out, out_gamma, out_beta, heads, dim_head, scale, eps,
    )
    LAUNCHES["linear_attention_block_v2"] += 1
    return out


def _linattn_core_weights(w_qkv: torch.Tensor, dtype) -> torch.Tensor:
    """The core mode's weight operand, kept per parameter version: W_qkv
    [C, 384] in ``dtype``, in fragment order (zero rows up to C rounded to
    32) in bf16, row major in float32."""

    def make():
        w = w_qkv.to(dtype)
        return fragment_order(w) if dtype == torch.bfloat16 else w.contiguous()

    return _derived.get(f"linattn_core:{dtype}", (w_qkv,), make)


def _launch_core(what, h: torch.Tensor, w_qkv: torch.Tensor, B: int, N: int, C: int, scale: float):
    """The qkv-fused core (#3, #12) on [B, N, C] token rows ``h`` (checked
    by the caller): one launch of the whole-block kernel in its core mode,
    one cluster a sample (``linattn_block_plan(..., core=True)``)."""
    plan = linattn_block_plan(N, C, h.dtype, core=True)
    if w_qkv.shape != (C, 384):
        raise ValueError(f"w_qkv {tuple(w_qkv.shape)} does not fit C={C}")
    if h.data_ptr() % 16:
        raise ValueError(f"{what} takes 16-byte aligned tokens, got {tuple(h.shape)} at {h.data_ptr():#x}")
    wq = _linattn_core_weights(w_qkv, h.dtype)
    out = torch.empty((B, N, 128), dtype=h.dtype, device=h.device)
    _build.launch(
        "linear_attention", "dmn_linattn_tokens",
        [_VP] * 3 + [_CI] * 8 + [_CF, _VP],
        h.data_ptr(), wq.data_ptr(), out.data_ptr(), B, N, C, int(h.dtype == torch.bfloat16),
        *_plan_args(plan), scale, _stream(h),
    )
    return out


def linear_attention_tokens_cuda(
    h: torch.Tensor, w_qkv: torch.Tensor, heads: int, dim_head: int, scale: float
) -> torch.Tensor:
    """Launch the qkv-fused linear-attention kernel (TPU kernel #3) on bf16
    [B, N, C]: one launch, one thread-block cluster a sample (the whole-block
    kernel's core mode)."""
    what = "linear_attention_tokens_cuda"
    B, N, C = _check_tokens(h, heads, dim_head, what)
    out = _launch_core(what, h, w_qkv, B, N, C, scale)
    LAUNCHES["linear_attention_tokens"] += 1
    return out


def linear_attention_v4_cuda(
    x_packed: torch.Tensor, w_qkv: torch.Tensor, n_tokens: int, heads: int, dim_head: int,
    scale: float,
) -> torch.Tensor:
    """Launch the qkv-fused linear attention on the lane-packed view (TPU
    kernel #12): float32 or bf16 x_packed [B, R, 128] holding [B, N, C]
    tokens row-major (R·128 = N·C, C divides 128) → [B, N, 128] in x's
    dtype. The kernel is #3's (the core mode of the whole-block kernel) and
    reads the same bytes as token rows; float32 runs its products on f32
    FMAs."""
    what = "linear_attention_v4_cuda"
    if x_packed.ndim != 3 or x_packed.shape[-1] != 128:
        raise ValueError(f"{what} takes [B, R, 128] packed tokens, got {tuple(x_packed.shape)}")
    B, R, L = x_packed.shape
    if (R * L) % n_tokens or 128 % ((R * L) // n_tokens):
        raise ValueError(f"{what}: [B, {R}, {L}] does not hold {n_tokens} tokens of C | 128 channels")
    C = (R * L) // n_tokens
    _check_tokens(x_packed, heads, dim_head, what, _KERNEL_DTYPES)
    out = _launch_core(what, x_packed, w_qkv, B, n_tokens, C, scale)
    LAUNCHES["linear_attention_v4"] += 1
    return out


def small_block_smem_bytes(N: int, C: int, heads: int = 4, dim_head: int = 32) -> int:
    """Shared memory kernel #4 needs for [N, C] tokens: h [NP, CP + 8], qkv
    [NP, 3·hd + 8] and the attention output [NP, hd + 8] in bf16, NP = N
    rounded up to 16 and CP = C rounded up to 32 (rows padded by 16 bytes),
    and 256 B of reduction scratch. Raises for a shape outside the kernel's range."""
    hd = heads * dim_head
    if not (8 <= N <= 64 and N % 8 == 0 and heads * N <= 512):
        raise ValueError(
            f"attention_block_small_cuda takes 8 <= N <= 64, N % 8 == 0, heads*N <= 512; got [N={N}, C={C}]"
        )
    if C % 8:
        raise ValueError(f"attention_block_small_cuda takes C % 8 == 0 (16-byte rows); got [N={N}, C={C}]")
    smem = 2 * (-(-N // 16) * 16) * ((-(-C // 32) * 32 + 8) + (3 * hd + 8) + (hd + 8)) + 256
    if smem > _SMEM_LIMIT:
        raise ValueError(f"[N={N}, C={C}] needs {smem} B of shared memory (> {_SMEM_LIMIT})")
    return smem


def attention_block_small_cuda(
    x, norm_gamma, norm_beta, w_qkv, w_out, b_out,
    heads: int, dim_head: int, scale: float, eps: float = 1e-5,
) -> torch.Tensor:
    """Launch the bottleneck attention-block kernel on bf16 [B, N, C]."""
    B, N, C = _check_tokens(x, heads, dim_head, "attention_block_small_cuda")
    hd = heads * dim_head
    if w_qkv.shape != (C, 3 * hd) or w_out.shape != (hd, C):
        raise ValueError(f"weights {tuple(w_qkv.shape)}, {tuple(w_out.shape)} do not fit C={C}")
    small_block_smem_bytes(N, C, heads, dim_head)
    if x.data_ptr() % 16:
        raise ValueError(f"attention_block_small_cuda takes 16-byte aligned tokens, got {tuple(x.shape)} at {x.data_ptr():#x}")
    wq, bq, wo, bo = _small_block_weights(norm_gamma, norm_beta, w_qkv, w_out, b_out)
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
    contiguous, 16-byte aligned float32 or bf16 [B, N, 384] tensor → [B, N,
    128]: one launch, one thread-block cluster a sample (the whole-block
    kernel's raw mode, ``linattn_block_plan(..., raw=True)``), f32 arithmetic
    in both dtypes, the output cast once."""
    what = "linear_attention_qkv_cuda"
    if not qkv.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} takes float32 or bf16, got {qkv.dtype}")
    if (heads, dim_head) != (4, 32):
        raise ValueError(f"{what} is built for 4 heads x 32, got {heads} x {dim_head}")
    hd = heads * dim_head
    if qkv.ndim != 3 or qkv.shape[-1] != 3 * hd or not qkv.is_contiguous():
        raise ValueError(f"{what} takes contiguous [B, N, {3 * hd}], got {tuple(qkv.shape)}")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{what} takes a 16-byte aligned qkv, got {tuple(qkv.shape)} at {qkv.data_ptr():#x}")
    out = _launch_qkv(qkv, linattn_block_plan(qkv.shape[1], 3 * hd, qkv.dtype, raw=True), scale)
    LAUNCHES["linear_attention_qkv"] += 1
    return out


def _launch_qkv(qkv: torch.Tensor, plan: LinattnBlockPlan, scale: float) -> torch.Tensor:
    """#8's one launch on checked [B, N, 384] ``qkv`` with a raw-mode plan
    (the wrapper's, or another one that ``tools/check_linattn.py`` times)."""
    B, N, _ = qkv.shape
    out = torch.empty((B, N, 128), dtype=qkv.dtype, device=qkv.device)
    _build.launch(
        "linear_attention", "dmn_linattn_qkv",
        [_VP] * 2 + [_CI] * 7 + [_CF, _VP],
        qkv.data_ptr(), out.data_ptr(), B, N, int(qkv.dtype == torch.bfloat16), *_plan_args(plan),
        scale, _stream(qkv),
    )
    return out


_ATTN_HEAD_DIMS = (32, 64, 128)


def check_attention_alignment(name: str, t: torch.Tensor) -> None:
    """Kernel #7 reads bf16 q, k and v in place, in 16-byte pieces (TMA
    tensor maps at d = 64, cp.async otherwise): the base address and the byte
    strides over (B, N, h) must be multiples of 16, as they are for the DiT's
    slices of its [B, N, 3, h, d] qkv tensor."""
    if t.data_ptr() % 16 or any((s * t.element_size()) % 16 for s in t.stride()[:3]):
        raise ValueError(
            f"attention_cuda takes bf16 {name} with a 16-byte aligned base and strides over (B, N, h), got "
            f"{tuple(t.shape)} strides {t.stride()} at offset {t.storage_offset()} (address {t.data_ptr():#x})"
        )


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the softmax-attention kernel (TPU kernel #7) on float32 or bf16
    [B, N, h, d] tensors (q pre-scaled), read in place with their strides
    (unit stride along d) → contiguous [B, N, h, d]. bf16 runs on the tensor
    cores, float32 on the CUDA cores."""
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
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_attention_alignment(name, t)
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
