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
``block_<i>/Dropout_1``; with cross-attention ``Dropout_1`` is its output and
the MLP's is ``Dropout_2``, as flax numbers the sites in call order),
through injected keep masks (``dropout_shapes``); with no masks the forward
is the deterministic one.

``aug_dim = D`` adds ``aug_embed``, a zero-initialised no-bias Dense [D →
dim] on the augmentation descriptor ``aug_cond`` [B, D] (None = zeros),
added to c after the class embedding, as in the JAX DiT.

``context_dim = D`` adds a cross-attention branch to every block, after the
self-attention and before the MLP: a parameter-free LayerNorm ``norm_ca``,
queries ``ca_q`` from the image tokens, keys and values ``ca_kv`` from the
context sequence, and a zero-initialised ``ca_out`` added to x with no
gate. The context is integer tokens [B, L] (``context_vocab`` > 0: embedded
by ``context_embed`` [vocab, D] plus a fixed 1-D sin-cos table; id 0 is PAD
and masked, position 0 always attended, so an all-PAD row attends to the
PAD embedding alone) or a float [B, L, D] sequence from an outside encoder
(no mask); None is the null context, one PAD token. As in the JAX block,
both products of the branch are float32 from operands in the compute
dtype, its softmax float32 with masked logits at the finite −1e9; it stays
plain torch ops (the JAX package computes it outside any Pallas kernel).
In bf16 the products are exact whatever TF32 says (a bf16 value fits
TF32); in float32 they rely on PyTorch's default, TF32 off for matmuls.

``moe_experts = E`` swaps the MLP of every ``moe_every``-th block (block
``i`` with ``i % max(moe_every, 1) == 0``) for ``ExpertChoiceMoE``
(``block_<i>.moe``): expert-choice routing over all B·N tokens of the
batch, so a sample's output depends on the other rows of its batch (in
both packages). Sequence parallelism raises ``NotImplementedError``.
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

__all__ = ["DiT", "DiTBlock", "ExpertChoiceMoE", "sincos_position_embedding_1d", "sincos_position_embedding_2d",
           "depth_to_space"]


def sincos_position_embedding_1d(n: int, dim: int) -> np.ndarray:
    """Fixed 1-D sin‖cos table ``[n, dim]`` (base 10000) for the context
    token sequence."""
    if dim % 2:
        raise ValueError(f"1-D position embedding needs dim % 2 == 0, got {dim}")
    half = dim // 2
    freq = np.exp(-math.log(10000.0) * np.arange(half) / half)
    ang = np.arange(n, dtype=np.float64)[:, None] * freq[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


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


class ExpertChoiceMoE(nn.Module):
    """The JAX package's expert-choice MoE MLP over [B, N, D] tokens.

    A float32 ``router`` (Dense D → E) scores every token, softmax over the
    experts; each expert then takes its top-C tokens of the whole batch
    (``topk`` of the scores' transpose, C = max(1, int(capacity_factor ·
    B·N / E))), runs its own GELU MLP on them (``experts_w1`` [E, D, H],
    ``experts_b1`` [E, H], ``experts_w2`` [E, H, D], ``experts_b2`` [E, D],
    stacked, flax's own layout: the carrier takes them as they are) and
    adds its gate-weighted outputs back into their rows; a token no expert
    took gives zero. The two products are batched matmuls in the compute
    dtype with float32 accumulation, rounded once, as ``preferred_element_
    type`` then ``astype`` in JAX. The combine is deterministic: one
    ``index_add_`` an expert, in expert order, each with distinct rows (an
    expert's top-C indices are distinct), so no two additions of one launch
    meet and the sums are those of JAX's scatter-add in its update order,
    whatever the device. ``torch.topk`` returns tied scores in no fixed
    order; the combine does not depend on the order within an expert. No
    kernel: the JAX package computes the layer with XLA outside Pallas."""

    def __init__(self, dim: int, hidden: int, num_experts: int, capacity_factor: float = 1.0,
                 dtype=torch.float32):
        super().__init__()
        E = int(num_experts)
        self.num_experts, self.capacity_factor, self.dtype = E, float(capacity_factor), resolve_dtype(dtype)
        self.router = Dense(dim, E, dtype=torch.float32)
        self.experts_w1 = nn.Parameter(torch.empty(E, dim, hidden))
        self.experts_b1 = nn.Parameter(torch.zeros(E, hidden))
        self.experts_w2 = nn.Parameter(torch.empty(E, hidden, dim))
        self.experts_b2 = nn.Parameter(torch.zeros(E, dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The stacked expert kernels: flax's ``lecun_normal(batch_axis=(0,))``
        (fan-in D, then H); the router is reset as a Dense of its own."""
        for w in (self.experts_w1, self.experts_w2):
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[1]))

    def route(self, xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gates [E, C] float32, token indices [E, C]) of tokens [T, D]."""
        scores = torch.softmax(self.router(xt.float()), dim=-1)  # [T, E]
        capacity = max(1, int(self.capacity_factor * xt.shape[0] / self.num_experts))
        return torch.topk(scores.t(), capacity, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        dt = self.dtype
        xt = x.reshape(B * N, D)
        gates, idx = self.route(xt)
        xe = xt[idx].to(dt)  # [E, C, D] dispatch
        h = F.gelu(torch.bmm(xe, self.experts_w1.to(dt)) + self.experts_b1[:, None, :].to(dt), approximate="tanh")
        ye = torch.bmm(h, self.experts_w2.to(dt)) + self.experts_b2[:, None, :].to(dt)
        contrib = gates[..., None].to(dt) * ye
        out = torch.zeros((B * N, D), dtype=dt, device=x.device)
        for e in range(self.num_experts):
            out.index_add_(0, idx[e], contrib[e])
        return out.reshape(B, N, D)


class DiTBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero conditioning, and with
    ``context_dim`` a cross-attention branch between the self-attention and
    the MLP; ``moe_experts`` > 0 puts ``ExpertChoiceMoE`` (``moe``) in the
    MLP's place."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, dtype=torch.float32,
                 dropout: Optional[float] = None, context_dim: int = 0, moe_experts: int = 0,
                 moe_capacity_factor: float = 1.0):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.dim, self.heads, self.head_dim = dim, heads, dim // heads
        self.dropout = float(dropout or 0.0)
        self.dtype = dt = resolve_dtype(dtype)
        hidden = int(dim * mlp_ratio)
        self.adaln_mod = Dense(dim, 6 * dim, dtype=dt)
        self.qkv = Dense(dim, 3 * dim, dtype=dt)
        self.attn_out = Dense(dim, dim, dtype=dt)
        self.cross_attention = bool(context_dim)
        if self.cross_attention:
            self.ca_q = Dense(dim, dim, dtype=dt)
            self.ca_kv = Dense(context_dim, 2 * dim, dtype=dt)
            self.ca_out = Dense(dim, dim, dtype=dt)
        if moe_experts:
            self.moe = ExpertChoiceMoE(dim, hidden, moe_experts, moe_capacity_factor, dtype=dt)
        else:
            self.mlp_in = Dense(dim, hidden, dtype=dt)
            self.mlp_out = Dense(hidden, dim, dtype=dt)

    def _cross_attention(self, x: torch.Tensor, ctx: torch.Tensor, ctx_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """``ca_out`` of the attention from x's tokens to ``ctx`` [B, L,
        context_dim] (``ctx_mask`` [B, L] bool, None = every position)."""
        B, N, D = x.shape
        L = ctx.shape[1]
        q = self.ca_q(_layer_norm(x)).reshape(B, N, self.heads, self.head_dim)
        kv = self.ca_kv(ctx.to(self.dtype)).reshape(B, L, 2, self.heads, self.head_dim)
        k, v = kv[:, :, 0], kv[:, :, 1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * self.head_dim**-0.5
        if ctx_mask is not None:
            logits = logits.masked_fill(~ctx_mask[:, None, None, :], -1e9)
        w = torch.softmax(logits, dim=-1).to(self.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())
        return self.ca_out(o.to(self.dtype).reshape(B, N, D))

    def forward(self, x: torch.Tensor, c: torch.Tensor, ctx: Optional[torch.Tensor] = None,
                ctx_mask: Optional[torch.Tensor] = None, attn_mask: Optional[torch.Tensor] = None,
                ca_mask: Optional[torch.Tensor] = None, mlp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``ctx`` / ``ctx_mask``: the embedded context and its mask (a
        block with cross-attention); ``attn_mask`` / ``ca_mask`` /
        ``mlp_mask``: training's keep masks of the dropout sites (the
        self-attention, cross-attention and MLP outputs, before their
        gates)."""
        sh1, sc1, g1, sh2, sc2, g2 = self.adaln_mod(F.silu(c)).chunk(6, dim=-1)
        h = _modulate(_layer_norm(x), sh1, sc1)
        B, N, D = h.shape
        qkv = self.qkv(h).reshape(B, N, 3, self.heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = A.fused_attention(q * self.head_dim**-0.5, k, v)
        attn = dropout(self.attn_out(attn.to(h.dtype).reshape(B, N, D)), attn_mask, self.dropout)
        x = x + g1[:, None, :] * attn
        if self.cross_attention and ctx is not None:
            x = x + dropout(self._cross_attention(x, ctx, ctx_mask), ca_mask, self.dropout)
        h = _modulate(_layer_norm(x), sh2, sc2)
        if hasattr(self, "moe"):
            h = self.moe(h)
        else:
            h = self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))  # flax nn.gelu: tanh form
        return x + g2[:, None, :] * dropout(h, mlp_mask, self.dropout)


@register_target("diffusion_model_nemo.modules.DiT", "diffusion_model_nemo_tpu.modules.DiT")
class DiT(nn.Module):
    """Diffusion Transformer; drop-in for ``Unet`` in the DDPM family.
    ``input_dim`` is accepted for config compatibility; ``moe_experts``,
    ``moe_every`` and ``moe_capacity_factor`` give every ``moe_every``-th
    block an expert-choice MoE MLP, ``context_dim`` / ``context_vocab`` add
    the cross-attention branch (the module docstring); ``dropout``
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
        self.context_dim, self.context_vocab = int(context_dim or 0), int(context_vocab or 0)
        if self.context_dim and self.context_vocab:
            self.context_embed = Embed(self.context_vocab, self.context_dim)
        self.dropout = float(dropout or 0.0)
        for i in range(depth):
            moe = int(moe_experts or 0) if i % max(int(moe_every), 1) == 0 else 0
            self.add_module(f"block_{i}", DiTBlock(dim, heads, mlp_ratio, dt, dropout=self.dropout,
                                                   context_dim=self.context_dim, moe_experts=moe,
                                                   moe_capacity_factor=moe_capacity_factor))
        self.depth = depth
        self.final_mod = Dense(dim, 2 * dim, dtype=dt)
        self.final_linear = Dense(dim, p * p * self.out_dim, dtype=dt)
        self._pos: Dict[Tuple, torch.Tensor] = {}

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers, drawn from ``generator`` in module order:
        lecun-normal kernels (biases are zero from construction), and the
        adaLN-Zero layers (``adaln_mod``, ``final_mod``, ``final_linear``)
        and the cross-attention's ``ca_out`` zero."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        zero = [self.final_mod, self.final_linear] + ([self.aug_embed] if self.aug_dim else [])
        for i in range(self.depth):
            blk = getattr(self, f"block_{i}")
            zero += [blk.adaln_mod] + ([blk.ca_out] if blk.cross_attention else [])
        with torch.no_grad():
            for m in zero:
                m.weight.zero_()

    def dropout_shapes(self, shape) -> Dict[str, Tuple[int, ...]]:
        """{site: the keep mask's shape} for an input of ``shape`` [B, H, W,
        C]: two sites a block (three with cross-attention), [B, N, dim] each
        (none without dropout)."""
        if not self.dropout:
            return {}
        n = (shape[1] // self.patch_size) * (shape[2] // self.patch_size)
        sites = 3 if self.context_dim else 2
        return {f"block_{i}/Dropout_{j}": (shape[0], n, self.dim) for i in range(self.depth) for j in range(sites)}

    def _position_embedding(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._pos:
            table = sincos_position_embedding_2d(h, w, self.dim)
            self._pos[key] = torch.from_numpy(table).to(device=device, dtype=self.dtype)
        return self._pos[key]

    def _context(self, context: Optional[torch.Tensor], B: int, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the context sequence in the compute dtype, its mask or None =
        every position) from tokens [B, L], a float [B, L, context_dim] or
        None (the null context: one PAD token), with the JAX DiT's errors."""
        if context is None:
            if not self.context_vocab:
                raise ValueError("DiT(context_dim>0, context_vocab=0) needs an explicit float context "
                                 "[B, L, context_dim]")
            context = torch.zeros((B, 1), dtype=torch.int32, device=device)
        if context.is_floating_point():
            return context.to(self.dtype), None
        if not self.context_vocab:
            raise ValueError("integer token context needs context_vocab > 0")
        mask = context != 0
        mask[:, 0] = True  # an all-PAD row attends to the PAD embedding: the null context
        L = context.shape[1]
        key = ("ctx", L, str(device))
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(sincos_position_embedding_1d(L, self.context_dim)).to(device)
        return (self.context_embed(context) + self._pos[key][None]).to(self.dtype), mask

    def forward(self, x: torch.Tensor, time: torch.Tensor, classes: Optional[torch.Tensor] = None,
                dropout_masks: Optional[Dict[str, torch.Tensor]] = None,
                aug_cond: Optional[torch.Tensor] = None, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, H, W, C] float; time: [B] (int or float); classes: [B] int
        (a network with ``num_classes``; None = the null class);
        ``dropout_masks``: training's keep mask of each site; ``aug_cond``:
        the augmentation descriptor [B, aug_dim] (None = zeros); ``context``
        (a network with ``context_dim``): tokens [B, L] int, a float [B, L,
        context_dim] or None (the null context) → [B, H, W, out] float32."""
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
        ctx = ctx_mask = None
        if self.context_dim:
            ctx, ctx_mask = self._context(context, B, x.device)
        for i in range(self.depth):
            blk = getattr(self, f"block_{i}")
            site = lambda j: masks.get(f"block_{i}/Dropout_{j}")  # noqa: E731
            m = (site(0), site(1), site(2)) if self.context_dim else (site(0), None, site(1))
            args = (tok, c, ctx, ctx_mask, *m)
            tok = remat_call(blk, *args) if self.remat else blk(*args)
        sh, sc = self.final_mod(F.silu(c)).chunk(2, dim=-1)
        out = self.final_linear(_modulate(_layer_norm(tok), sh, sc))
        return depth_to_space(out.reshape(B, h, w, p * p * self.out_dim), p).float()
