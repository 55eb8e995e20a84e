"""Non-leaky augmentation (EDM, Karras et al. 2022 §5), in torch.

Counterpart of ``diffusion_model_nemo_tpu/data/augment.py``: geometric
transforms, each applied to an image with probability p, and the network
conditioned on a [B, 9] descriptor of what was applied (all zeros at
sampling: "nothing applied"). Gated-off parameters are exactly zero, so the
zero descriptor is the identity by construction.

Descriptor layout (``AUGMENT_DIM = 9``), zero == identity:
  [0] x-flip applied (0/1)       [1] y-flip applied (0/1)
  [2] x-translation / width      [3] y-translation / height
  [4] log2 isotropic scale       [5] cos(rotation) − 1
  [6] sin(rotation)              [7] log2 anisotropic scale
  [8] reserved (always 0)

``sample_augment_labels`` draws a descriptor batch from a
``torch.Generator`` (the JAX package splits a key; the two streams differ,
so a test injects the JAX descriptor). ``apply_augment`` resamples each
image at the descriptor's inverse map with one bilinear gather written out
as ``jax.scipy.ndimage.map_coordinates(order=1, mode="constant",
cval=0)`` computes it: floor-based weights, the four neighbours in
(y, x) product order, each zero outside the image, summed in that order.
Everything is device tensor math, so it runs inside a captured training
step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["AUGMENT_DIM", "sample_augment_labels", "apply_augment", "augment_pipe"]

AUGMENT_DIM = 9


def sample_augment_labels(
    generator: Optional[torch.Generator],
    batch: int,
    p: float,
    *,
    xflip: bool = True,
    yflip: bool = False,
    translate: float = 0.125,
    scale_std: float = 0.2,
    rotate: bool = True,
    aniso_std: float = 0.2,
    device="cpu",
) -> torch.Tensor:
    """A [B, 9] float32 descriptor batch on ``device``: each enabled
    transform gates independently on Bernoulli(p) per image (a disabled one
    stays zero)."""
    def gate():
        return (torch.rand((batch,), generator=generator, device=device) < p).float()

    def normal():
        return torch.randn((batch,), generator=generator, device=device)

    zero = torch.zeros((batch,), device=device)
    fx = gate() * (torch.rand((batch,), generator=generator, device=device) < 0.5).float() if xflip else zero
    fy = gate() * (torch.rand((batch,), generator=generator, device=device) < 0.5).float() if yflip else zero
    tx = gate() * normal() * translate if translate else zero
    ty = gate() * normal() * translate if translate else zero
    ls = gate() * normal() * scale_std if scale_std else zero
    if rotate:
        u = torch.rand((batch,), generator=generator, device=device)
        theta = gate() * (u * (2.0 * math.pi) - math.pi)
    else:
        theta = zero
    la = gate() * normal() * aniso_std if aniso_std else zero
    return torch.stack([fx, fy, tx, ty, ls, torch.cos(theta) - 1.0, torch.sin(theta), la, zero], dim=-1)


def apply_augment(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The transforms a [B, 9] descriptor describes, on NHWC float images.

    Forward model in centred pixel coordinates (x right, y down):
    p_out = R(θ)·diag(s·a·(1 − 2fx), (s/a)·(1 − 2fy))·p_in + t, so the
    output pixel samples the input at D⁻¹·R(−θ)·(p_out − t), bilinearly,
    zero outside. A zero descriptor gives the input bit for bit."""
    B, H, W, C = images.shape
    dev = images.device
    labels = labels.to(device=dev, dtype=torch.float32)
    fx, fy, tx, ty = (labels[:, i, None, None] for i in range(4))
    s = torch.exp2(labels[:, 4, None, None])
    cos_t = labels[:, 5, None, None] + 1.0
    sin_t = labels[:, 6, None, None]
    a = torch.exp2(labels[:, 7, None, None])
    dx = s * a * (1.0 - 2.0 * fx)
    dy = (s / a) * (1.0 - 2.0 * fy)

    yy = (torch.arange(H, dtype=torch.float32, device=dev) - (H - 1) / 2.0)[None, :, None]
    xx = (torch.arange(W, dtype=torch.float32, device=dev) - (W - 1) / 2.0)[None, None, :]
    xo = xx - tx * W
    yo = yy - ty * H
    xr = cos_t * xo + sin_t * yo
    yr = -sin_t * xo + cos_t * yo
    xi = xr / dx + (W - 1) / 2.0  # [B, H, W]
    yi = yr / dy + (H - 1) / 2.0

    flat = images.reshape(B, H * W, C)
    y0, x0 = torch.floor(yi), torch.floor(xi)
    wy1, wx1 = yi - y0, xi - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    iy0, ix0 = y0.to(torch.int32), x0.to(torch.int32)
    out = None
    for iy, wy in ((iy0, wy0), (iy0 + 1, wy1)):
        for ix, wx in ((ix0, wx0), (ix0 + 1, wx1)):
            valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).long().reshape(B, H * W, 1)
            value = torch.gather(flat, 1, idx.expand(B, H * W, C)).reshape(B, H, W, C)
            term = (wy * wx)[..., None] * torch.where(valid[..., None], value, 0.0)
            out = term if out is None else out + term
    return out.to(images.dtype)


def augment_pipe(
    images: torch.Tensor,
    labels: Optional[torch.Tensor],
    p: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(augmented images, [B, 9] descriptor) for the descriptor ``labels``
    (drawn by ``sample_augment_labels``); ``p == 0`` returns the input
    itself and a zero descriptor, with no resampling."""
    B = images.shape[0]
    if p <= 0.0:
        return images, torch.zeros((B, AUGMENT_DIM), dtype=torch.float32, device=images.device)
    return apply_augment(images, labels), labels
