"""The port's sample-quality metrics against the JAX package's, on the CPU:
Inception Score, the polynomial kernel, KID, the feature statistics, the
Fréchet distance, ``FIDScorer`` (FID and KID over the weight-free
features), PSNR and SSIM.

Inputs are made with numpy from a seed. The host-side scores are the same
float64 numpy arithmetic in both packages: 1e-12 relative. PSNR and SSIM
are float32 convolutions and reductions in another library: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.metrics import fid as jfid
from diffusion_model_nemo_tpu.metrics import image_quality as jiq
from diffusion_model_nemo_tpu.metrics import scores as jscores
from diffusion_model_nemo_tpu_torch import metrics
from diffusion_model_nemo_tpu_torch.metrics import fid

HOST_TOL = 1e-12
IMAGE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _features(seed, n=64, d=12, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.5 + shift).astype(np.float32)


@pytest.mark.parametrize("splits", [1, 4, 10])
def test_inception_score_matches_jax(splits):
    logits = np.random.default_rng(splits).standard_normal((40, 7)) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    np.testing.assert_allclose(metrics.inception_score(probs, splits), jscores.inception_score(probs, splits),
                               rtol=HOST_TOL, atol=0)
    with pytest.raises(ValueError, match="N>=splits"):
        metrics.inception_score(probs[:3], splits=4)


@pytest.mark.parametrize("kw", [{}, {"degree": 2, "gamma": 0.3, "coef0": 0.5}])
def test_polynomial_kernel_matches_jax(kw):
    x, y = _features(0, 9), _features(1, 5)
    np.testing.assert_allclose(metrics.polynomial_kernel(x, y, **kw), jscores.polynomial_kernel(x, y, **kw),
                               rtol=HOST_TOL, atol=0)


@pytest.mark.parametrize("subset_size,n_subsets", [(None, 10), (16, 25)])
def test_kid_matches_jax(subset_size, n_subsets):
    real, fake = _features(2), _features(3, n=48, shift=0.3)
    ours = metrics.kernel_inception_distance(real, fake, subset_size=subset_size, n_subsets=n_subsets, seed=5)
    ref = jscores.kernel_inception_distance(real, fake, subset_size=subset_size, n_subsets=n_subsets, seed=5)
    np.testing.assert_allclose(ours, ref, rtol=HOST_TOL, atol=HOST_TOL)
    with pytest.raises(ValueError, match="mismatch"):
        metrics.kernel_inception_distance(real, fake[:, :3])


def test_statistics_and_frechet_distance_match_jax():
    a, b = _features(4), _features(5, shift=0.2)
    (mu_a, sig_a), (mu_b, sig_b) = fid.compute_statistics(a), fid.compute_statistics(b)
    for ours, ref in zip((mu_a, sig_a), jfid.compute_statistics(a)):
        np.testing.assert_allclose(ours, ref, rtol=HOST_TOL, atol=0)
    d = fid.frechet_distance(mu_a, sig_a, mu_b, sig_b)
    np.testing.assert_allclose(d, jfid.frechet_distance(mu_a, sig_a, mu_b, sig_b), rtol=HOST_TOL)
    assert d > 0 and abs(fid.frechet_distance(mu_a, sig_a, mu_a, sig_a)) < 1e-9


def test_fid_scorer_matches_jax():
    """``FIDScorer`` on the weight-free ``default_feature_fn`` (uint8
    images, and pre-extracted features): FID and KID equal the JAX
    scorer's."""
    rng = np.random.default_rng(6)
    real = rng.integers(0, 256, (24, 16, 16, 3), dtype=np.uint8)
    fake = np.clip(real.astype(np.int32) + rng.integers(-40, 40, real.shape), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(fid.default_feature_fn(real), jfid.default_feature_fn(real))
    ours, ref = metrics.FIDScorer(), jfid.FIDScorer()
    for scorer in (ours, ref):
        scorer.update_real(real[:12])
        scorer.update_real(real[12:])
        scorer.update_generated(fake)
        scorer.update_generated_features(fid.default_feature_fn(real[:4]))
    np.testing.assert_allclose(ours.compute(), ref.compute(), rtol=HOST_TOL)
    np.testing.assert_allclose(ours.compute_kid(n_subsets=5), ref.compute_kid(n_subsets=5), rtol=HOST_TOL,
                               atol=HOST_TOL)
    ours.reset()
    with pytest.raises(ValueError, match="both real and generated"):
        ours.compute()


@pytest.mark.parametrize("shape,max_val", [((3, 16, 16, 3), 1.0), ((2, 24, 20, 1), 255.0)])
def test_psnr_and_ssim_match_jax(shape, max_val):
    rng = np.random.default_rng(7)
    a = (rng.uniform(0, 1, shape) * max_val).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1 * max_val, shape), 0, max_val).astype(np.float32)
    p_ours, p_ref = metrics.psnr(torch.from_numpy(a), torch.from_numpy(b), max_val), jiq.psnr(a, b, max_val)
    s_ours, s_ref = metrics.ssim(a, b, max_val), jiq.ssim(jnp.asarray(a), jnp.asarray(b), max_val)
    assert p_ours.shape == s_ours.shape == (shape[0],)
    np.testing.assert_allclose(p_ours.numpy(), np.asarray(p_ref), rtol=IMAGE_TOL)
    np.testing.assert_allclose(s_ours.numpy(), np.asarray(s_ref), rtol=IMAGE_TOL, atol=IMAGE_TOL)
    np.testing.assert_allclose(metrics.ssim(a, a, max_val).numpy(), 1.0, rtol=IMAGE_TOL)


def test_ssim_refuses_what_the_jax_ssim_refuses():
    with pytest.raises(ValueError, match="matching"):
        metrics.ssim(np.zeros((1, 16, 16, 3)), np.zeros((1, 16, 16, 1)))
    with pytest.raises(ValueError, match="11-tap window"):
        metrics.ssim(np.zeros((1, 8, 8, 3)), np.zeros((1, 8, 8, 3)))
