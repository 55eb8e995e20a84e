"""Inception Score and Kernel Inception Distance, the companions of FID.

Counterpart of ``diffusion_model_nemo_tpu/metrics/scores.py``, host-side
numpy in float64 (feature sets are small, [N, 2048]):

- Inception Score (Salimans et al. 2016): exp(E_x KL(p(y|x) ‖ p(y))) over a
  classifier's posteriors, the mean and spread over contiguous splits;
- KID (Bińkowski et al. 2018): the unbiased MMD² with the cubic polynomial
  kernel k(x, y) = (x·y/d + 1)³, over random subsets. Unbiased in the
  sample count, so the score to use when only a few hundred samples are
  affordable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["inception_score", "kernel_inception_distance", "polynomial_kernel"]


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS over posteriors ``probs`` [N, K] (rows sum to 1): (mean, std) over
    ``splits`` contiguous chunks, each with its own marginal."""
    p = np.asarray(probs, dtype=np.float64)
    if p.ndim != 2 or p.shape[0] < splits:
        raise ValueError(f"probs must be [N>=splits, K], got {p.shape}")
    eps = 1e-16
    scores = []
    for chunk in np.array_split(p, splits, axis=0):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + eps) - np.log(marginal + eps))).sum(axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))


def polynomial_kernel(x: np.ndarray, y: np.ndarray, degree: int = 3,
                      gamma: Optional[float] = None, coef0: float = 1.0) -> np.ndarray:
    """k(x, y) = (gamma·x·y + coef0)^degree, gamma 1/D by default: x [N, D],
    y [M, D] → [N, M]."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def _mmd2_unbiased(kxx: np.ndarray, kyy: np.ndarray, kxy: np.ndarray) -> float:
    """The unbiased MMD² from kernel matrices (diagonals excluded)."""
    n, m = kxx.shape[0], kyy.shape[0]
    sum_xx = (kxx.sum() - np.trace(kxx)) / (n * (n - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
    return float(sum_xx + sum_yy - 2.0 * kxy.mean())


def kernel_inception_distance(real_features: np.ndarray, fake_features: np.ndarray,
                              subset_size: Optional[int] = None, n_subsets: int = 100, degree: int = 3,
                              seed: int = 0) -> Tuple[float, float]:
    """KID between feature sets [N, D] and [M, D]: (mean, std) of the
    unbiased MMD² over ``n_subsets`` random subsets of ``subset_size`` rows
    (default min(N, M, 1000)), each drawn without replacement from
    ``numpy.random.default_rng(seed)``."""
    x = np.asarray(real_features, dtype=np.float64)
    y = np.asarray(fake_features, dtype=np.float64)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"feature shapes mismatch: {x.shape} vs {y.shape}")
    m = min(x.shape[0], y.shape[0], subset_size or 1000)
    if m < 2:
        raise ValueError("KID needs at least 2 samples per set")
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(n_subsets):
        xi = x[rng.choice(x.shape[0], m, replace=False)]
        yi = y[rng.choice(y.shape[0], m, replace=False)]
        vals.append(_mmd2_unbiased(polynomial_kernel(xi, xi, degree=degree), polynomial_kernel(yi, yi, degree=degree),
                                   polynomial_kernel(xi, yi, degree=degree)))
    return float(np.mean(vals)), float(np.std(vals))
