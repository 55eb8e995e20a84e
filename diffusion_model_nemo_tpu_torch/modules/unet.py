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

Options of the JAX U-Net that later slices bring raise
``NotImplementedError`` naming the slice: ConvNeXt blocks, augmentation
conditioning and the TPU-geometry variants.

``WaveGradUNet`` is the JAX package's FiLM U-Net: its ``time`` input is the
continuous noise level √ᾱ, which conditions the network through one
``FeatureWiseLinearModulation`` per level (``film_0`` on the stem, then
``film_{i+1}`` on level i's pre-downsample map) instead of a time MLP.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config.registry import register_target
from .parts import (
    Conv2d,
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
    (``input_dim``, ``convnext_mult`` and ``dropout`` are accepted for
    config compatibility; dropout is inactive at inference). ``remat``
    recomputes each ResNet block's activations in the backward
    (``parts.remat_call``), as the JAX package's ``nn.remat`` does."""

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
    ):
        super().__init__()
        if use_convnext:
            raise not_ported("Unet", "use_convnext=True", "ConvNeXt U-Net")
        if aug_dim:
            raise not_ported("Unet", f"aug_dim={aug_dim}", "EDM augmentation")
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

        def block(c_in, c_out, time_dim):
            return ResnetBlock(c_in, c_out, time_dim, groups, resnet_block_order, dt)

        self.init_conv = Conv2d(channels, dim, 7, padding=3, dtype=dt)
        self.num_classes = None if num_classes is None else int(num_classes)
        if self.num_classes is not None:
            self.class_embed = Embed(self.num_classes + 1, dim)
        time_dim = dim * 4 if with_time_emb else None
        if with_time_emb:
            self.time_sinusoid = SinusoidalPositionEmbeddings(dim)
            self.time_dense0 = Dense(dim, time_dim, dtype=dt)
            self.time_dense1 = Dense(time_dim, time_dim, dtype=dt)

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
        initialisers), drawn from ``generator`` in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

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

    def forward(self, x: torch.Tensor, time: torch.Tensor, classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, H, W, C] float; time: [B] (int or float); classes: [B] int
        (a network with ``num_classes``; None = the null class) → [B, H, W,
        out] float32."""
        x = self._add_class(self.init_conv(x.to(self.dtype)), classes)
        t = None
        if self.with_time_emb:
            t = self.time_sinusoid(time)
            t = self.time_dense0(t.to(self.dtype))
            t = F.gelu(t, approximate="tanh")  # flax nn.gelu is the tanh form
            t = self.time_dense1(t)

        block = remat_call if self.remat else (lambda m, *a: m(*a))
        skips = []
        for ind in range(self.num_resolutions):
            x = block(getattr(self, f"down_{ind}_block1"), x, t)
            x = block(getattr(self, f"down_{ind}_block2"), x, t)
            x = getattr(self, f"down_{ind}_attn")(x)
            skips.append(x)
            if ind < self.num_resolutions - 1:
                x = getattr(self, f"down_{ind}_downsample")(x)

        x = block(self.mid_block1, x, t)
        x = self.mid_attn(x)
        x = block(self.mid_block2, x, t)

        for ind in range(self.n_up):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = block(getattr(self, f"up_{ind}_block1"), x, t)
            x = block(getattr(self, f"up_{ind}_block2"), x, t)
            x = getattr(self, f"up_{ind}_attn")(x)
            if ind < self.num_resolutions - 1:
                x = getattr(self, f"up_{ind}_upsample")(x)

        x = block(self.final_block, x, None)
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

    def forward(self, x: torch.Tensor, time: torch.Tensor, classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, H, W, C]; time: the noise level √ᾱ, [B, 1, 1, 1] or [B]
        (an integer t is taken as a level, as the JAX network takes it) →
        [B, H, W, out] float32."""
        level = time
        x = self.init_conv(x.to(self.dtype))
        statistics = [self.film_0(x, level)]
        x = self._add_class(x, classes)

        block = remat_call if self.remat else (lambda m, *a: m(*a))
        skips = []
        for ind in range(self.num_resolutions):
            x = block(getattr(self, f"down_{ind}_block1"), x, None)
            x = block(getattr(self, f"down_{ind}_block2"), x, None)
            x = getattr(self, f"down_{ind}_attn")(x)
            skips.append(x)
            if ind < self.num_resolutions - 1:  # the deepest level's statistics are never read
                statistics.append(getattr(self, f"film_{ind + 1}")(x, level))
                x = getattr(self, f"down_{ind}_downsample")(x)

        x = block(self.mid_block1, x, None)
        x = self.mid_attn(x)
        x = block(self.mid_block2, x, None)

        for ind in range(self.n_up):
            scale, shift = statistics.pop()
            x = torch.cat([x, skips.pop()], dim=-1)
            x = block(getattr(self, f"up_{ind}_block1"), x, None)
            x = block(getattr(self, f"up_{ind}_block2"), x, None)
            x = getattr(self, f"up_{ind}_attn")(x)
            if ind < self.num_resolutions - 1:
                x = getattr(self, f"up_{ind}_upsample")(x)
            x = x * scale + shift

        scale, shift = statistics.pop()  # the stem's
        x = scale * x + shift
        x = block(self.final_block, x, None)
        if self.resnet_block_order == "bn_act_conv":
            x = self.final_norm(x)
        return self.final_conv(x).float()
