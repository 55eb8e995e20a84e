"""InceptionV3 pool3 features for FID (PyTorch, NHWC in and out).

Counterpart of ``diffusion_model_nemo_tpu/metrics/inception.py``: the
torchvision ``inception_v3`` trunk with the pytorch-fid switches, up to the
2048-wide pool3 mean, and the optional ``fc`` classifier head
(``num_logits``) for the Inception Score.

- ``BasicConv2d``: a bias-free convolution, a frozen BatchNorm in the flax
  formula, (x − mean) · (scale · rsqrt(var + 1e-3)) + bias, in float32, and
  a ReLU.
- ``fid_variant=True`` (default): the A / C / E blocks' 3×3 average pools
  exclude the padding from the divisor (``count_include_pad=False``) and
  the last E block (Mixed_7c) pools with a max (padded with −inf, as flax's
  ``max_pool``): the TF ``pt_inception-2015-12-05`` graph of published FID.
  The 3×3 stride-2 VALID max pools are plain.
- ``InceptionV3.preprocess``: uint8 → /255, a float input /255 when its
  max exceeds 1.5, grey repeated to three channels, resized to 299 by
  ``ops/resize.py:resize`` (JAX's bilinear with antialias, which
  ``F.interpolate`` is not), then ×2 − 1.

Submodules carry the torchvision names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch5x5_1.bn.running_var``, ``fc.weight``), so a torchvision or
pytorch-fid ``state_dict`` loads as it is (``load_inception_state_dict``
drops ``AuxLogits.*`` and ``num_batches_tracked``, and ``fc`` without
``keep_fc``); ``utils/weights.py:inception_from_flax`` carries the JAX
package's flax variables over. The network runs NCHW inside, on
channels-last memory, in float32.

``inception_feature_fn`` builds the extractor for ``FIDScorer``: with a
weights file, standard Inception FID; without, seeded random weights (a
``torch.Generator`` seeded 0, flax's truncated lecun-normal, every conv
kernel ×√2 as the JAX package scales them) under the JAX package's
warning: a relative metric only. The port cannot draw JAX's PRNG stream, so
its random-weight features differ from the JAX package's unless the
weights are carried across. Each batch shape's forward is one captured call
on CUDA (``ops/graphs.py:captured_call``), with TF32 off
(``ops/conv.py:no_tf32``). No kernel: the JAX package computes the network
with XLA outside any Pallas kernel.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import graphs as graphs_lib
from ..ops.conv import no_tf32
from ..ops.resize import resize

__all__ = ["InceptionV3", "BasicConv2d", "InceptionA", "InceptionB", "InceptionC", "InceptionD", "InceptionE",
           "INCEPTION_FEATURE_DIM", "inception_feature_fn", "load_inception_state_dict"]

log = logging.getLogger(__name__)

INCEPTION_FEATURE_DIM = 2048
_BN_EPS = 1e-3
_TRUNC = 0.87962566103423978  # the std of a unit normal truncated to [-2, 2] (flax's variance_scaling)

Pair = Union[int, Tuple[int, int]]


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _trunc_lecun_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated to ±2 σ, σ = 1/√fan_in / 0.8796."""
    with torch.no_grad():
        draw = torch.empty(w.shape, dtype=torch.float32)
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.copy_(draw * (1.0 / math.sqrt(fan_in) / _TRUNC))


class _FrozenBatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True, epsilon=1e-3)`` over the
    channel axis of an NCHW tensor, in float32."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + _BN_EPS) * self.weight
        return (x - self.running_mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class _Conv(nn.Module):
    """A bias-free float32 conv, weight OIHW (flax's HWIO carried over)."""

    def __init__(self, c_in: int, c_out: int, kernel: Pair, stride: Pair, padding: Pair):
        super().__init__()
        kh, kw = _pair(kernel)
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kh, kw))
        self.stride, self.padding = _pair(stride), _pair(padding)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        o, i, kh, kw = self.weight.shape
        _trunc_lecun_(self.weight, i * kh * kw, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, None, self.stride, self.padding)


class BasicConv2d(nn.Module):
    """Conv (no bias) → BatchNorm (eps 1e-3, frozen statistics) → ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel: Pair = 1, stride: Pair = 1, padding: Pair = 0):
        super().__init__()
        self.conv = _Conv(c_in, c_out, kernel, stride, padding)
        self.bn = _FrozenBatchNorm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor, fid_variant: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not fid_variant)


def _max_pool_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int, fid_variant: bool = True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(c_in, 64)
        self.branch5x5_1 = BasicConv2d(c_in, 48)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, self.fid_variant))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, channels_7x7: int, fid_variant: bool = True):
        super().__init__()
        c7 = channels_7x7
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(c_in, 192)
        self.branch7x7_1 = BasicConv2d(c_in, c7)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for name in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"):
            bd = getattr(self, name)(bd)
        bp = self.branch_pool(_avg_pool(x, self.fid_variant))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool_s2(x)], 1)


class InceptionE(nn.Module):
    """``pool_type``: "avg" (Mixed_7b; Mixed_7c outside the FID variant) or
    "max" (the FID variant's Mixed_7c, a 3×3 stride-1 max padded with −inf)."""

    def __init__(self, c_in: int, pool_type: str = "avg", fid_variant: bool = True):
        super().__init__()
        self.pool_type, self.fid_variant = pool_type, fid_variant
        self.branch1x1 = BasicConv2d(c_in, 320)
        self.branch3x3_1 = BasicConv2d(c_in, 384)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_type == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool(x, self.fid_variant)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """The Inception v3 trunk → pool3 features [B, 2048] (no aux head).
    Input: float NHWC in [-1, 1] at 299×299 (``preprocess``); the trunk
    takes any size from 75 px. ``num_logits > 0`` adds ``fc`` (1000 classes
    for torchvision checkpoints, 1008 for the TF one) and returns
    ``(pool3, logits)``."""

    def __init__(self, fid_variant: bool = True, num_logits: int = 0):
        super().__init__()
        fv = fid_variant
        self.fid_variant, self.num_logits = fv, int(num_logits)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fv)
        self.Mixed_5c = InceptionA(256, 64, fv)
        self.Mixed_5d = InceptionA(288, 64, fv)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fv)
        self.Mixed_6c = InceptionC(768, 160, fv)
        self.Mixed_6d = InceptionC(768, 160, fv)
        self.Mixed_6e = InceptionC(768, 192, fv)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", fv)
        self.Mixed_7c = InceptionE(2048, "max" if fv else "avg", fv)
        if self.num_logits:
            self.fc = nn.Linear(INCEPTION_FEATURE_DIM, self.num_logits)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisation, drawn from ``generator`` in module order:
        truncated lecun-normal conv kernels and ``fc`` kernel, BatchNorm at
        scale 1, bias 0, mean 0, var 1, a zero ``fc`` bias."""
        for m in self.modules():
            if isinstance(m, _Conv):
                m.reset_parameters(generator)
            elif isinstance(m, _FrozenBatchNorm):
                with torch.no_grad():
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
        if self.num_logits:
            _trunc_lecun_(self.fc.weight, INCEPTION_FEATURE_DIM, generator)
            with torch.no_grad():
                self.fc.bias.zero_()

    def forward(self, x: torch.Tensor):
        """x: [B, H, W, 3] float → pool3 [B, 2048] float32 (and the logits
        [B, num_logits] with ``num_logits``)."""
        x = x.float().permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool_s2(x)))
        x = _max_pool_s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                     "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3))
        if self.num_logits:
            return feats, F.linear(feats, self.fc.weight, self.fc.bias)  # torchvision's dropout: eval, identity
        return feats

    @staticmethod
    def preprocess(images, size: int = 299) -> torch.Tensor:
        """uint8 (or [0, 1] / [0, 255] float) NHWC → float32 [B, size, size,
        3] in [-1, 1], the pytorch-fid input convention (the JAX package's
        ``preprocess``, its bilinear resize with antialias)."""
        images = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
        x = images.float()
        if images.dtype == torch.uint8:
            x = x / 255.0
        else:  # [0, 255] or [0, 1], decided on the device
            x = torch.where(x.max() > 1.5, x / 255.0, x)
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        B, H, W, C = x.shape
        if (H, W) != (size, size):
            x = resize(x, (B, size, size, C), "bilinear")
        return x * 2.0 - 1.0


# ------------------------------------------------------------------ weights --
def _entry_kept(key: str, keep_fc: bool) -> bool:
    """The JAX ``_torch_entry_to_flax`` rule: which entries of a torchvision
    / pytorch-fid ``state_dict`` the extractor takes; an entry of no known
    kind raises ``KeyError``."""
    parts = key.split(".")
    if parts[0] == "fc":
        return keep_fc
    if parts[0] == "AuxLogits" or parts[-1] == "num_batches_tracked":
        return False
    if len(parts) >= 2 and parts[-2] == "conv" and parts[-1] == "weight":
        return True
    if len(parts) >= 2 and parts[-2] == "bn":
        if parts[-1] not in ("weight", "bias", "running_mean", "running_var"):
            raise KeyError(f"Unrecognized BN entry: {key}")
        return True
    raise KeyError(f"Unrecognized state_dict entry: {key}")


def load_inception_state_dict(weights_path: str, keep_fc: bool = False) -> Dict[str, torch.Tensor]:
    """The extractor's ``state_dict`` from a local file (the JAX
    ``load_inception_variables``): a torch checkpoint (``.pt/.pth/.bin``: a
    ``state_dict``, or a dict holding one under ``'state_dict'``, loaded
    with ``weights_only=True``) or a flat ``.npz`` with torch-style keys.
    ``AuxLogits.*`` and ``num_batches_tracked`` are dropped, ``fc`` kept
    only with ``keep_fc``; float32 CPU tensors."""
    p = Path(weights_path)
    if not p.exists():
        raise FileNotFoundError(f"Inception weights not found: {weights_path}")
    if p.suffix == ".npz":
        with np.load(p) as z:
            sd = {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    else:
        obj = torch.load(str(p), map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        sd = dict(obj)
    return {k: torch.as_tensor(v).float().contiguous() for k, v in sd.items() if _entry_kept(k, keep_fc)}


# ------------------------------------------------------------ feature_fn --
def _extract(net: InceptionV3, images: torch.Tensor, with_logits: bool):
    """preprocess → trunk (→ softmax of the logits), TF32 off."""
    with no_tf32():
        out = net(InceptionV3.preprocess(images))
    if with_logits:
        feats, logits = out
        return feats, torch.softmax(logits, dim=-1)
    return out


def inception_feature_fn(weights_path: Optional[str] = None, batch_size: int = 64, fid_variant: bool = True,
                         with_logits: bool = False, device: Union[str, torch.device] = "cuda") -> Callable:
    """``feature_fn(images) -> [N, 2048]`` float32 numpy for ``FIDScorer``
    (images uint8 or float NHWC, numpy or a tensor), in chunks of
    ``batch_size``. ``with_logits``: the classifier head too, returning
    ``(features, probabilities [N, K])`` (a weights file needs an ``fc``:
    ``ValueError`` without one). Without ``weights_path``: seeded random
    weights, ``using_random_weights`` = True. The function carries
    ``using_random_weights``, ``feature_dim`` and ``num_logits``, its
    network as ``net`` and its captured calls as ``graphs`` (one a batch
    shape, on CUDA)."""
    device = torch.device(device)
    num_logits = 1000 if with_logits else 0  # torchvision's head; a checkpoint's shape wins
    if weights_path:
        sd = load_inception_state_dict(weights_path, keep_fc=with_logits)
        if with_logits:
            if "fc.weight" not in sd:
                raise ValueError(f"with_logits=True but {weights_path} has no fc head "
                                 "(Inception Score needs a classifier checkpoint)")
            num_logits = int(sd["fc.weight"].shape[0])
        net = InceptionV3(fid_variant=fid_variant, num_logits=num_logits)
        net.load_state_dict(sd)
        random_weights = False
    else:
        net = InceptionV3(fid_variant=fid_variant, num_logits=num_logits)
        log.warning(
            "No Inception weights provided (feature_weights_path unset): using SEEDED RANDOM weights. The "
            "resulting Fréchet distance is a valid relative metric but NOT comparable to published Inception FID."
        )
        net.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():  # He-scale the conv kernels (x√2), as the JAX package does
            for m in net.modules():
                if isinstance(m, _Conv):
                    m.weight.mul_(math.sqrt(2.0))
        random_weights = True
    net.to(device).eval().requires_grad_(False)
    store: dict = {}
    sources = list(net.state_dict().values())

    def run(images: torch.Tensor):
        with torch.inference_mode():
            return graphs_lib.captured_call(store, "inception", lambda x: _extract(net, x, with_logits),
                                            {"x": images}, sources)

    def feature_fn(images):
        images = images if torch.is_tensor(images) else torch.from_numpy(np.ascontiguousarray(images))
        feats, probs = [], []
        for i in range(0, images.shape[0], batch_size):
            out = run(images[i:i + batch_size].to(device))
            if with_logits:
                feats.append(out[0].cpu().numpy())
                probs.append(out[1].cpu().numpy())
            else:
                feats.append(out.cpu().numpy())
        feats = np.concatenate(feats, axis=0)
        return (feats, np.concatenate(probs, axis=0)) if with_logits else feats

    feature_fn.using_random_weights = random_weights
    feature_fn.feature_dim = INCEPTION_FEATURE_DIM
    feature_fn.num_logits = num_logits
    feature_fn.net = net
    feature_fn.graphs = store
    return feature_fn
