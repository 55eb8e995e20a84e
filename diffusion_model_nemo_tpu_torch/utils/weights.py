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
  as it is.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..modules.parts import Conv1d, Conv1x1, Conv2d, ConvTranspose2d, Dense, Embed, GNParams

__all__ = ["from_flax_params", "to_flax_params"]

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _to_torch(owner: nn.Module, w: np.ndarray) -> np.ndarray:
    if isinstance(owner, Conv2d):
        return w.transpose(3, 2, 0, 1)
    if isinstance(owner, Conv1d):
        return w.transpose(2, 1, 0)
    if isinstance(owner, ConvTranspose2d):
        return w[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(owner, Conv1x1):  # before Dense: Conv1x1 is a Dense
        return w[0, 0].T
    if isinstance(owner, Dense):
        return w.T
    if isinstance(owner, (GNParams, Embed)):
        return w
    raise TypeError(f"no weight transform for {type(owner).__name__}")


def _to_flax(owner: nn.Module, w: np.ndarray) -> np.ndarray:
    if isinstance(owner, Conv2d):
        return w.transpose(2, 3, 1, 0)
    if isinstance(owner, Conv1d):
        return w.transpose(2, 1, 0)
    if isinstance(owner, ConvTranspose2d):
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]
    if isinstance(owner, Conv1x1):
        return w.T[None, None]
    if isinstance(owner, Dense):
        return w.T
    if isinstance(owner, (GNParams, Embed)):
        return w
    raise TypeError(f"no weight transform for {type(owner).__name__}")


def from_flax_params(params: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of arrays) → float32 CPU
    ``state_dict`` for ``module``; raises on a missing or extra leaf."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        owner = module.get_submodule(".".join(path[:-1]))
        key = ".".join(path[:-1] + (_LEAF_TO_TORCH[path[-1]],))
        w = np.asarray(leaf, dtype=np.float32)
        if path[-1] != "bias":
            w = _to_torch(owner, w)
        out[key] = torch.from_numpy(np.array(w, dtype=np.float32, order="C"))
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
        w = t.detach().float().cpu().numpy()
        if leaf == "bias":
            flax_leaf = "bias"
        else:
            flax_leaf = "scale" if isinstance(owner, GNParams) else "embedding" if isinstance(owner, Embed) else "kernel"
            w = _to_flax(owner, w)
        node = tree
        for p in mod_path:
            node = node.setdefault(p, {})
        node[flax_leaf] = np.ascontiguousarray(w)
    return tree
