"""Fréchet distance (FID) machinery, whatever the feature extractor.

Counterpart of ``diffusion_model_nemo_tpu/metrics/fid.py``, host-side numpy
in float64: ``compute_statistics`` (mean and covariance of features
[N, D]), ``frechet_distance`` (the 2-Wasserstein distance between the two
fitted Gaussians, tr√(Σ1Σ2) through symmetric eigendecompositions),
``default_feature_fn`` (weight-free features: strided pixels and
channel moments; for regression tracking, not comparable to Inception
FID) and ``FIDScorer``, which accumulates real and generated features from
any ``feature_fn(images) -> [B, D]`` and scores FID and KID. The InceptionV3
extractor of standard FID is ``inception.py:inception_feature_fn``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from .scores import kernel_inception_distance

__all__ = ["FIDScorer", "compute_statistics", "default_feature_fn", "frechet_distance"]


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean [D] and covariance [D, D] of features [N, D] (float64)."""
    feats = np.asarray(features, dtype=np.float64)
    return feats.mean(axis=0), np.atleast_2d(np.cov(feats, rowvar=False))


def _sqrtm_product_trace(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """tr√(Σ1Σ2) as tr√(A Σ2 A) with A = Σ1^{1/2} (A Σ2 A is symmetric PSD)."""
    vals1, vecs1 = np.linalg.eigh(sigma1)
    sqrt1 = (vecs1 * np.sqrt(np.clip(vals1, 0.0, None))) @ vecs1.T
    inner = sqrt1 @ sigma2 @ sqrt1
    vals = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    return float(np.sqrt(np.clip(vals, 0.0, None)).sum())


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """FID = ‖μ1 − μ2‖² + tr(Σ1 + Σ2 − 2√(Σ1Σ2))."""
    diff = np.asarray(mu1, np.float64) - np.asarray(mu2, np.float64)
    covmean_trace = _sqrtm_product_trace(np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * covmean_trace)


def default_feature_fn(images: np.ndarray) -> np.ndarray:
    """Weight-free features of [B, H, W, C] images (uint8, or floats in [0,
    1]): the pixels on a stride-H/8 grid, then each channel's mean and std."""
    x = np.asarray(images, dtype=np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    B, H, W, C = x.shape
    stride = max(H // 8, 1)
    pooled = x[:, ::stride, ::stride, :].reshape(B, -1)
    mean = x.reshape(B, -1, C).mean(axis=1)
    std = x.reshape(B, -1, C).std(axis=1)
    return np.concatenate([pooled, mean, std], axis=1)


class FIDScorer:
    """Accumulates real and generated features (from images through
    ``feature_fn``, default ``default_feature_fn``, or given directly) and
    scores FID (``compute``) and KID (``compute_kid``)."""

    def __init__(self, feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.feature_fn = feature_fn or default_feature_fn
        self._real, self._fake = [], []

    def update_real(self, images: np.ndarray) -> None:
        self._real.append(np.asarray(self.feature_fn(images)))

    def update_generated(self, images: np.ndarray) -> None:
        self._fake.append(np.asarray(self.feature_fn(images)))

    def update_real_features(self, features: np.ndarray) -> None:
        self._real.append(np.asarray(features))

    def update_generated_features(self, features: np.ndarray) -> None:
        self._fake.append(np.asarray(features))

    def _features(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._real or not self._fake:
            raise ValueError("Need both real and generated features")
        return np.concatenate(self._real), np.concatenate(self._fake)

    def compute(self) -> float:
        real, fake = self._features()
        return frechet_distance(*compute_statistics(real), *compute_statistics(fake))

    def compute_kid(self, subset_size: Optional[int] = None, n_subsets: int = 100, seed: int = 0):
        """KID (mean, std) over the accumulated feature sets (``scores.py``)."""
        real, fake = self._features()
        return kernel_inception_distance(real, fake, subset_size=subset_size, n_subsets=n_subsets, seed=seed)

    def reset(self) -> None:
        self._real.clear()
        self._fake.clear()
