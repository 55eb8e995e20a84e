"""Weight carrier: the JAX package's flax parameter tree ↔ the port's
``state_dict``.

The port's modules carry the flax module names, so each flax leaf maps to
one ``state_dict`` entry (``down_0_block1/block1/proj/kernel`` →
``down_0_block1.block1.proj.weight``), at any depth: the autoencoder's
``setup()`` submodules nest it one level further
(``encoder/down_0_block1/...``, ``decoder/up_1_upsample/...``). The
transforms, chosen by the type of the owning port module:

- ``Conv2d``: HWIO → OIHW;
- ``Conv1d`` (the vocoder's): [K, I, O] → [O, I, K];
- ``ConvTranspose2d``: HWIO with a spatial flip → IOHW (flax's 'SAME'
  k4 s2 transposed conv is torch's ConvTranspose2d(k=4, s=2, p=1) on the
  flipped kernel);
- ``Dense``: [in, out] → [out, in];
- ``Conv1x1``: [1, 1, C, F] → [F, C];
- GroupNorm parameters: ``scale``/``bias`` → ``weight``/``bias``;
- ``Embed`` (the class and context embeddings): ``embedding`` → ``weight``
  as it is;
- a leaf a module declares itself, under its own name (the MoE's stacked
  ``experts_w1`` [E, D, H] ... ``experts_b2``): as it is.

``inception_from_flax`` / ``inception_to_flax`` carry a flax InceptionV3's
two collections (``params`` and ``batch_stats``) into the port's
``metrics/inception.py`` module and back: conv HWIO → OIHW, BatchNorm
``scale``/``bias`` → ``weight``/``bias`` and ``mean``/``var`` →
``running_mean``/``running_var``, the ``fc`` head's Dense [in, out] → [out,
in].
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..modules.parts import Conv1d, Conv1x1, Conv2d, ConvTranspose2d, Dense, Embed, GNParams

__all__ = ["from_flax_params", "to_flax_params", "inception_from_flax", "inception_to_flax", "kernel_to_flax",
           "kernel_to_torch"]

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def kernel_to_torch(owner: nn.Module, w: torch.Tensor) -> torch.Tensor:
    """A flax kernel (or a leaf of flax's kernel layout, as a LoRA update
    ΔW) → ``owner``'s weight layout: a view where no flip is needed."""
    if isinstance(owner, Conv2d):
        return w.permute(3, 2, 0, 1)
    if isinstance(owner, Conv1d):
        return w.permute(2, 1, 0)
    if isinstance(owner, ConvTranspose2d):
        return w.flip((0, 1)).permute(2, 3, 0, 1)
    if isinstance(owner, Conv1x1):  # before Dense: Conv1x1 is a Dense
        return w[0, 0].t()
    if isinstance(owner, Dense):
        return w.t()
    if isinstance(owner, (GNParams, Embed)):
        return w
    raise TypeError(f"no weight transform for {type(owner).__name__}")


def kernel_to_flax(owner: nn.Module, w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`kernel_to_torch`."""
    if isinstance(owner, Conv2d):
        return w.permute(2, 3, 1, 0)
    if isinstance(owner, Conv1d):
        return w.permute(2, 1, 0)
    if isinstance(owner, ConvTranspose2d):
        return w.permute(2, 3, 0, 1).flip((0, 1))
    if isinstance(owner, Conv1x1):
        return w.t()[None, None]
    if isinstance(owner, Dense):
        return w.t()
    if isinstance(owner, (GNParams, Embed)):
        return w
    raise TypeError(f"no weight transform for {type(owner).__name__}")


def from_flax_params(params: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of arrays) → float32 CPU
    ``state_dict`` for ``module``; raises on a missing or extra leaf."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        owner = module.get_submodule(".".join(path[:-1]))
        key = ".".join(path[:-1] + (_LEAF_TO_TORCH.get(path[-1], path[-1]),))
        w = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if path[-1] in _LEAF_TO_TORCH and path[-1] != "bias":
            w = kernel_to_torch(owner, w)
        out[key] = w.contiguous()
    expected = set(module.state_dict())
    if set(out) != expected:
        raise KeyError(
            f"flax tree does not match the module: missing {sorted(expected - set(out))}, "
            f"unexpected {sorted(set(out) - expected)}"
        )
    return out


def to_flax_params(state_dict: Mapping[str, torch.Tensor], module: nn.Module) -> Dict[str, Any]:
    """Inverse of :func:`from_flax_params`: ``state_dict`` → nested dicts of
    float32 numpy arrays in flax layout."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *mod_path, leaf = key.split(".")
        owner = module.get_submodule(".".join(mod_path))
        w = t.detach().float().cpu()
        if leaf != "weight":  # a bias, or a leaf its module declares under its own name
            flax_leaf = leaf
        else:
            flax_leaf = "scale" if isinstance(owner, GNParams) else "embedding" if isinstance(owner, Embed) else "kernel"
            w = kernel_to_flax(owner, w)
        w = w.numpy()
        node = tree
        for p in mod_path:
            node = node.setdefault(p, {})
        node[flax_leaf] = np.ascontiguousarray(w)
    return tree


_BN_TO_TORCH = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_BN_TO_FLAX = {v: ("batch_stats" if k in ("mean", "var") else "params", k) for k, v in _BN_TO_TORCH.items()}


def inception_from_flax(variables: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """A flax InceptionV3's ``{'params', 'batch_stats'}`` → float32 CPU
    ``state_dict`` for the port's ``InceptionV3``; raises on a missing or
    extra entry."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            w = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                key = ".".join(path[:-1] + ("weight",))
                w = w.T if w.ndim == 2 else w.transpose(3, 2, 0, 1)
            else:
                key = ".".join(path[:-1] + (_BN_TO_TORCH[path[-1]] if path[-2] == "bn" else path[-1],))
            out[key] = torch.from_numpy(np.array(w, dtype=np.float32, order="C"))
    expected = set(module.state_dict())
    if set(out) != expected:
        raise KeyError(
            f"flax variables do not match the module: missing {sorted(expected - set(out))}, "
            f"unexpected {sorted(set(out) - expected)}"
        )
    return out


def inception_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`inception_from_flax`: ``{'params': ...,
    'batch_stats': ...}`` of float32 numpy arrays in flax layout."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *mod_path, leaf = key.split(".")
        w = t.detach().float().cpu().numpy()
        if leaf == "weight" and mod_path[-1] != "bn":
            coll, flax_leaf = "params", "kernel"
            w = w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)
        elif mod_path[-1] == "bn":
            coll, flax_leaf = _BN_TO_FLAX[leaf]
        else:
            coll, flax_leaf = "params", leaf
        node = tree[coll]
        for p in mod_path:
            node = node.setdefault(p, {})
        node[flax_leaf] = np.ascontiguousarray(w)
    return tree
