"""2-D U-Net on the ResNet-block path (PyTorch, NHWC in and out).

Counterpart of ``diffusion_model_nemo_tpu/modules/unet.py:Unet``: 7×7 stem;
per down level [block, block, Residual(PreNorm(LinearAttention)),
Downsample]; mid [block, Residual(PreNorm(Attention)), block]; up levels
with skip-concat and transposed-conv upsample; final block + GroupNorm/SiLU
and a 1×1 conv; output float32. Submodules carry the flax names
(``down_0_block1``, ``mid_attn``, ``up_1_upsample``, ...).

``num_classes = K`` adds ``class_embed`` [K + 1, dim]; ``classes=None`` is
the null class K, whose row is forced to zero (torch's ``padding_idx``
behaviour, whatever the table holds), and the embedding, cast to the compute
dtype after that, is added to the stem's output before the time MLP.

``dropout`` acts in training only, on ``block2`` of each of the ResNet
blocks, through injected keep masks keyed by the flax path of each site
(``down_0_block2/block2``, ``mid_block1/block2``, ``final_block/block2``;
``dropout_shapes`` gives their shapes for an input shape); with no masks, as
at inference, the forward is the deterministic one.

``use_convnext`` (the JAX default) builds every block as a
``ConvNextBlock`` (``convnext_mult``), whose GroupNorm(1)s are plain torch
ops: the U-Net then launches kernel #1 once a forward (``final_norm``) and
the attention kernels as before; its dropout sites are
``<block>/Dropout_0``. ``aug_dim = D`` adds ``aug_embed``, a no-bias Dense
[D → 4·dim] initialised to zero, whose output on the augmentation
descriptor ``aug_cond`` [B, D] is added to the time embedding (a missing
descriptor is zeros: exactly the network without it). The TPU-geometry
variants raise ``NotImplementedError`` naming their slice.

``WaveGradUNet`` is the JAX package's FiLM U-Net: its ``time`` input is the
continuous noise level √ᾱ, which conditions the network through one
``FeatureWiseLinearModulation`` per level (``film_0`` on the stem, then
``film_{i+1}`` on level i's pre-downsample map) instead of a time MLP.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config.registry import register_target
from .parts import (
    Conv2d,
    ConvNextBlock,
    Dense,
    Downsample,
    Embed,
    FeatureWiseLinearModulation,
    FusedGroupNormSiLU,
    ResnetBlock,
    SelfAttentionBlock,
    SinusoidalPositionEmbeddings,
    Upsample,
    not_ported,
    remat_call,
    resolve_dtype,
)

__all__ = ["Unet", "WaveGradUNet"]


@register_target("diffusion_model_nemo.modules.Unet")
class Unet(nn.Module):
    """Reference-parity U-Net. Arguments mirror the JAX package's
    (``input_dim`` is accepted for config compatibility). ``in_channels``
    (default ``channels``) is the stem's input width, which flax infers
    from the input: SR3's [x_t, up(LR)] is 2C. ``remat`` recomputes each ResNet block's activations in
    the backward (``parts.remat_call``), as the JAX package's ``nn.remat``
    does."""

    def __init__(
        self,
        dim: int,
        input_dim: Optional[int] = None,
        out_dim: Optional[int] = None,
        dim_mults: Optional[Sequence[int]] = None,
        channels: int = 3,
        with_time_emb: bool = True,
        resnet_block_groups: int = 8,
        use_convnext: bool = True,
        convnext_mult: int = 2,
        resnet_block_order: str = "bn_act_conv",
        dropout: Optional[float] = None,
        learned_variance: bool = False,
        num_classes: Optional[int] = None,
        aug_dim: int = 0,
        dtype: str = "float32",
        remat: bool = False,
        tpu_geometry: str = "off",
        in_channels: Optional[int] = None,
    ):
        super().__init__()
        if (tpu_geometry or "off").lower() not in ("off", "none", ""):
            raise not_ported("Unet", f"tpu_geometry={tpu_geometry!r}", "U-Net geometry options")
        dt = resolve_dtype(dtype)
        self.dtype = dt
        self.channels = channels
        self.with_time_emb = with_time_emb
        self.resnet_block_order = resnet_block_order
        self.remat = bool(remat)
        dim_mults = tuple(dim_mults) if dim_mults is not None else (1, 2, 4, 8)
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.num_resolutions = len(in_out)
        groups = resnet_block_groups
        self.dropout = float(dropout or 0.0)
        self.use_convnext = bool(use_convnext)
        self._dropout_site = "Dropout_0" if self.use_convnext else "block2"  # the flax path below the block

        def block(c_in, c_out, time_dim):
            if self.use_convnext:
                return ConvNextBlock(c_in, c_out, time_dim, int(convnext_mult), dt, dropout=self.dropout)
            return ResnetBlock(c_in, c_out, time_dim, groups, resnet_block_order, dt, dropout=self.dropout)

        self.init_conv = Conv2d(in_channels or channels, dim, 7, padding=3, dtype=dt)
        self.num_classes = None if num_classes is None else int(num_classes)
        if self.num_classes is not None:
            self.class_embed = Embed(self.num_classes + 1, dim)
        time_dim = dim * 4 if with_time_emb else None
        if with_time_emb:
            self.time_sinusoid = SinusoidalPositionEmbeddings(dim)
            self.time_dense0 = Dense(dim, time_dim, dtype=dt)
            self.time_dense1 = Dense(time_dim, time_dim, dtype=dt)
        self.aug_dim = int(aug_dim or 0)
        if self.aug_dim and with_time_emb:  # the JAX U-Net reads it in its time MLP only
            self.aug_embed = Dense(self.aug_dim, time_dim, bias=False, dtype=dt)

        for ind, (dim_in, dim_out) in enumerate(in_out):
            self.add_module(f"down_{ind}_block1", block(dim_in, dim_out, time_dim))
            self.add_module(f"down_{ind}_block2", block(dim_out, dim_out, time_dim))
            self.add_module(f"down_{ind}_attn", SelfAttentionBlock(dim_out, True, dtype=dt))
            if ind < self.num_resolutions - 1:
                self.add_module(f"down_{ind}_downsample", Downsample(dim_out, dt))

        mid_dim = dims[-1]
        self.mid_block1 = block(mid_dim, mid_dim, time_dim)
        self.mid_attn = SelfAttentionBlock(mid_dim, False, dtype=dt)
        self.mid_block2 = block(mid_dim, mid_dim, time_dim)

        ch = mid_dim
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out[1:])):
            self.add_module(f"up_{ind}_block1", block(ch + dim_out, dim_in, time_dim))
            self.add_module(f"up_{ind}_block2", block(dim_in, dim_in, time_dim))
            self.add_module(f"up_{ind}_attn", SelfAttentionBlock(dim_in, True, dtype=dt))
            if ind < self.num_resolutions - 1:
                self.add_module(f"up_{ind}_upsample", Upsample(dim_in, dt))
            ch = dim_in

        out_dim = out_dim if out_dim is not None else channels * (2 if learned_variance else 1)
        self.final_block = block(ch, dim, None)
        if resnet_block_order == "bn_act_conv":
            self.final_norm = FusedGroupNormSiLU(dim, groups, 1e-5, dt)
        self.final_conv = Conv2d(dim, out_dim, 1, dtype=dt)
        self.n_up = len(in_out) - 1
        self.in_out = in_out

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """lecun-normal kernels, zero biases, unit norm scales (flax's
        initialisers), drawn from ``generator`` in module order; then
        ``aug_embed`` zero (its flax initialiser)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        if hasattr(self, "aug_embed"):
            with torch.no_grad():
                self.aug_embed.weight.zero_()

    def dropout_shapes(self, shape: Sequence[int]) -> Dict[str, Tuple[int, ...]]:
        """{site: the keep mask's shape} for an input of ``shape`` [B, H, W,
        C] (no site without dropout): each block's output (a ResNet block's
        ``block2``, a ConvNeXt block's ``Dropout_0``), at its level's
        resolution."""
        if not self.dropout:
            return {}
        B, H, W = shape[0], shape[1], shape[2]
        last = self.num_resolutions - 1
        site = self._dropout_site
        out = {}
        for ind, (_dim_in, dim_out) in enumerate(self.in_out):
            for b in (1, 2):
                out[f"down_{ind}_block{b}/{site}"] = (B, H >> ind, W >> ind, dim_out)
        mid = self.in_out[-1][1]
        for b in (1, 2):
            out[f"mid_block{b}/{site}"] = (B, H >> last, W >> last, mid)
        for ind, (dim_in, _dim_out) in enumerate(reversed(self.in_out[1:])):
            for b in (1, 2):
                out[f"up_{ind}_block{b}/{site}"] = (B, H >> (last - ind), W >> (last - ind), dim_in)
        out[f"final_block/{site}"] = (B, H, W, self.in_out[0][0])
        return out

    def _add_class(self, x: torch.Tensor, classes: Optional[torch.Tensor]) -> torch.Tensor:
        """The stem's output plus the class embedding (a network with
        ``num_classes``; None = the null class, whose row is zero)."""
        if self.num_classes is None:
            return x
        if classes is None:
            classes = torch.full((x.shape[0],), self.num_classes, dtype=torch.int32, device=x.device)
        null = (classes == self.num_classes)[:, None]
        emb = torch.where(null, 0.0, self.class_embed(classes)).to(self.dtype)
        return x + emb[:, None, None, :]

    def _blocks(self, dropout_masks: Optional[Dict[str, torch.Tensor]]):
        """``block(name, x, t)``: the named block (remat'd under
        ``remat``) with its site's keep mask, if any."""
        masks = dropout_masks or {}
        call = remat_call if self.remat else (lambda m, *a: m(*a))

        def block(name: str, x, t):
            return call(getattr(self, name), x, t, masks.get(f"{name}/{self._dropout_site}"))

        return block

    def forward(self, x: torch.Tensor, time: torch.Tensor, classes: Optional[torch.Tensor] = None,
                dropout_masks: Optional[Dict[str, torch.Tensor]] = None,
                aug_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, H, W, C] float; time: [B] (int or float); classes: [B] int
        (a network with ``num_classes``; None = the null class);
        ``dropout_masks``: training's keep mask of each site; ``aug_cond``:
        the augmentation descriptor [B, aug_dim] (None = zeros) → [B, H, W,
        out] float32."""
        x = self._add_class(self.init_conv(x.to(self.dtype)), classes)
        t = None
        if self.with_time_emb:
            t = self.time_sinusoid(time)
            t = self.time_dense0(t.to(self.dtype))
            t = F.gelu(t, approximate="tanh")  # flax nn.gelu is the tanh form
            t = self.time_dense1(t)
            if hasattr(self, "aug_embed"):
                a = aug_cond if aug_cond is not None else torch.zeros((t.shape[0], self.aug_dim), device=t.device)
                t = t + self.aug_embed(a.to(self.dtype))

        block = self._blocks(dropout_masks)
        skips = []
        for ind in range(self.num_resolutions):
            x = block(f"down_{ind}_block1", x, t)
            x = block(f"down_{ind}_block2", x, t)
            x = getattr(self, f"down_{ind}_attn")(x)
            skips.append(x)
            if ind < self.num_resolutions - 1:
                x = getattr(self, f"down_{ind}_downsample")(x)

        x = block("mid_block1", x, t)
        x = self.mid_attn(x)
        x = block("mid_block2", x, t)

        for ind in range(self.n_up):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = block(f"up_{ind}_block1", x, t)
            x = block(f"up_{ind}_block2", x, t)
            x = getattr(self, f"up_{ind}_attn")(x)
            if ind < self.num_resolutions - 1:
                x = getattr(self, f"up_{ind}_upsample")(x)

        x = block("final_block", x, None)
        if self.resnet_block_order == "bn_act_conv":
            x = self.final_norm(x)
        return self.final_conv(x).float()


@register_target("diffusion_model_nemo.modules.WaveGradUNet")
class WaveGradUNet(Unet):
    """FiLM-conditioned U-Net (JAX ``modules/unet.py:WaveGradUNet``): the
    ``time`` input is the continuous noise level ([B, 1, 1, 1] or [B]). The
    ResNet blocks take no time embedding and no time MLP is built, whatever
    ``with_time_emb`` says (the JAX module passes ``None`` to every block);
    the blocks' GroupNorm+SiLU kernels run at every site all the same.
    Statistics are collected on the way down and applied ``x·scale +
    shift`` after each up level, the stem's ``scale·x + shift`` before the
    final block. The deepest level's FiLM is computed and discarded in the
    JAX package (XLA drops it); here it is not called, but its parameters
    exist, so archives carry over. Like the JAX module, no FiLM is built
    for the up path."""

    def __init__(self, dim: int, *args, with_time_emb: bool = False, **kwargs):
        super().__init__(dim, *args, with_time_emb=False, **kwargs)
        dt = self.dtype
        self.film_0 = FeatureWiseLinearModulation(dim, dim, dt)
        for ind, (_dim_in, dim_out) in enumerate(self.in_out):
            self.add_module(f"film_{ind + 1}", FeatureWiseLinearModulation(dim_out, dim_out, dt))
        deepest = f"film_{len(self.in_out)}"
        # The parameters no output reads: a training step gives them a zero gradient.
        self.unused_params = frozenset(f"{deepest}.{n}" for n, _p in getattr(self, deepest).named_parameters())

    def forward(self, x: torch.Tensor, time: torch.Tensor, classes: Optional[torch.Tensor] = None,
                dropout_masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """x: [B, H, W, C]; time: the noise level √ᾱ, [B, 1, 1, 1] or [B]
        (an integer t is taken as a level, as the JAX network takes it);
        ``dropout_masks`` as ``Unet``'s → [B, H, W, out] float32."""
        level = time
        x = self.init_conv(x.to(self.dtype))
        statistics = [self.film_0(x, level)]
        x = self._add_class(x, classes)

        block = self._blocks(dropout_masks)
        skips = []
        for ind in range(self.num_resolutions):
            x = block(f"down_{ind}_block1", x, None)
            x = block(f"down_{ind}_block2", x, None)
            x = getattr(self, f"down_{ind}_attn")(x)
            skips.append(x)
            if ind < self.num_resolutions - 1:  # the deepest level's statistics are never read
                statistics.append(getattr(self, f"film_{ind + 1}")(x, level))
                x = getattr(self, f"down_{ind}_downsample")(x)

        x = block("mid_block1", x, None)
        x = self.mid_attn(x)
        x = block("mid_block2", x, None)

        for ind in range(self.n_up):
            scale, shift = statistics.pop()
            x = torch.cat([x, skips.pop()], dim=-1)
            x = block(f"up_{ind}_block1", x, None)
            x = block(f"up_{ind}_block2", x, None)
            x = getattr(self, f"up_{ind}_attn")(x)
            if ind < self.num_resolutions - 1:
                x = getattr(self, f"up_{ind}_upsample")(x)
            x = x * scale + shift

        scale, shift = statistics.pop()  # the stem's
        x = scale * x + shift
        x = block("final_block", x, None)
        if self.resnet_block_order == "bn_act_conv":
            x = self.final_norm(x)
        return self.final_conv(x).float()
