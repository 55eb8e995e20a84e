"""Image resize: the port's copy of ``jax.image.resize``.

The JAX package resizes with ``jax.image.resize`` (SR3's degradation and
its conditioning upsample, ``models/sr3.py``): for each axis whose size
changes, a float32 [in, out] weight matrix from the method's kernel
(``jax/_src/image/scale.py:compute_weight_mat``), contracted with the image
by XLA dots at ``precision=HIGHEST``. ``torch.nn.functional.interpolate``
is another function: its bicubic is Keys' cubic with a = -0.75 (JAX's a =
-0.5), it does not widen the kernel by the shrink factor under
``antialias`` as JAX does, and it clamps edge taps where JAX drops the
out-of-range taps and renormalises the rest. So the weight matrices are
built here on the host, in numpy float32, from a copy of that algorithm,
cached per (in, out, method, antialias, device) as float64 device
tensors, and applied as float64 products rounded back to the image's dtype
(at least the JAX dots' float32 precision, and out of TF32's reach without
touching the process-wide switch). ``nearest`` takes JAX's separate gather
route. The methods are SR3's four (``lowres_method``). No kernel: the JAX
package runs no Pallas here.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = ["resize", "weight_matrix", "nearest_indices"]

_F32 = np.float32
_CACHE: Dict[tuple, torch.Tensor] = {}


def _check(method: str) -> str:
    if method != "nearest" and method not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    return method


def _lanczos(radius: float, x: np.ndarray) -> np.ndarray:
    y = _F32(radius) * np.sin(_F32(np.pi) * x) * np.sin(_F32(np.pi) * x / _F32(radius))
    denom = np.where(x != 0, _F32(np.pi ** 2) * x * x, _F32(1.0))
    out = np.where(x > _F32(1e-3), y / denom, _F32(1.0))
    return np.where(x > _F32(radius), _F32(0.0), out).astype(_F32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (JAX's)."""
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= _F32(1.0), ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0)) * x + _F32(2.0), out)
    return np.where(x >= _F32(2.0), _F32(0.0), out).astype(_F32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(_F32(0.0), _F32(1.0) - np.abs(x)).astype(_F32)


_KERNELS = {
    "bilinear": _triangle,
    "bicubic": _keys_cubic,
    "lanczos3": lambda x: _lanczos(3.0, x),
}


def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool = True) -> np.ndarray:
    """The float32 [in, out] matrix that resizes one axis from ``in_size``
    to ``out_size`` (JAX ``compute_weight_mat`` at scale out/in and no
    translation): the kernel at each output sample's distance to each
    input pixel, widened by the shrink factor under ``antialias``, each
    column divided by its sum (0 where the sum is ~0), and zero where the
    sample lies outside the input."""
    if _check(method) == "nearest":
        raise ValueError("nearest resizes by a gather (nearest_indices), not a weight matrix")
    scale = _F32(out_size / in_size)
    inv_scale = _F32(1.0) / scale
    kernel_scale = max(inv_scale, _F32(1.0)) if antialias else _F32(1.0)
    sample_f = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * inv_scale - _F32(0.0) * inv_scale - _F32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=_F32)[:, None]) / _F32(kernel_scale)
    weights = _KERNELS[method](x.astype(_F32))
    total = np.sum(weights, axis=0, keepdims=True, dtype=_F32)
    safe = np.where(total != 0, total, _F32(1.0))
    weights = np.where(np.abs(total) > _F32(1000.0 * float(np.finfo(np.float32).eps)), weights / safe, _F32(0.0))
    inside = np.logical_and(sample_f >= _F32(-0.5), sample_f <= _F32(in_size - 0.5))[None, :]
    return np.where(inside, weights, _F32(0.0)).astype(_F32)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """JAX's nearest-neighbour source index of each output position:
    floor((i + 0.5)·in / out) in float32."""
    offsets = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * _F32(in_size) / _F32(out_size)
    return np.floor(offsets.astype(_F32)).astype(np.int64)


def _cached(key: tuple, make) -> torch.Tensor:
    """A device tensor built on the host once per key (made outside
    inference mode, so that autograd-recorded steps may read it)."""
    t = _CACHE.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CACHE[key] = make()
    return t


def _axis_weights(in_size: int, out_size: int, method: str, antialias: bool, device) -> torch.Tensor:
    key = ("w", in_size, out_size, method, bool(antialias), torch.device(device))
    return _cached(key, lambda: torch.from_numpy(weight_matrix(in_size, out_size, method, antialias)).to(
        device=device, dtype=torch.float64))


def _axis_indices(in_size: int, out_size: int, device) -> torch.Tensor:
    key = ("nearest", in_size, out_size, torch.device(device))
    return _cached(key, lambda: torch.from_numpy(nearest_indices(in_size, out_size)).to(device))


def resize(image: torch.Tensor, shape: Sequence[int], method: str, antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(image, shape, method, antialias)``: every axis
    whose size differs is resized (an equal axis is left as it is, as in
    JAX, all kernels being interpolating). Floating images keep their
    dtype; integer ones are computed in float32 (JAX's inexact promotion)."""
    shape: Tuple[int, ...] = tuple(int(s) for s in shape)
    if len(shape) != image.ndim:
        raise ValueError(f"shape must have length equal to the number of dimensions of x;  {shape} vs "
                         f"{tuple(image.shape)}")
    method = _check(method)
    dims = [d for d in range(image.ndim) if image.shape[d] != shape[d]]
    if method == "nearest":
        for d in dims:
            image = image.index_select(d, _axis_indices(image.shape[d], shape[d], image.device))
        return image
    dtype = image.dtype if image.is_floating_point() else torch.float32
    image = image.double()
    for d in dims:
        w = _axis_weights(image.shape[d], shape[d], method, antialias, image.device)
        image = torch.matmul(image.movedim(d, -1), w).movedim(-1, d)
    return image.to(dtype)
