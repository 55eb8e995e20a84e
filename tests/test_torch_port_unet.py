"""The PyTorch port's U-Net, samplers, weight carrier and config against the
JAX package, on the CPU.

Weights come from a JAX ``Unet.init`` and are carried over with
``utils/weights.py:from_flax_params``; inputs and injected noise are made
with numpy from a seed and fed to both packages. The small config (dim 32,
dim_mults [1, 2], 16×16) reaches every dispatch level of the slice: the
whole-block linear-attention route at 16×16 C32 (N·C/128 = 64), the
qkv-fused route at 8×8, and the bottleneck attention block at 8×8.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.modules.generalized_gaussian_diffusion import (
    GeneralizedGaussianDiffusion as JGeneralized,
)
from diffusion_model_nemo_tpu.modules.gaussian_diffusion import GaussianDiffusion as JGaussian
from diffusion_model_nemo_tpu.modules.unet import Unet as JUnet
from diffusion_model_nemo_tpu_torch.modules.gaussian_diffusion import GaussianDiffusion
from diffusion_model_nemo_tpu_torch.modules.generalized_gaussian_diffusion import (
    GeneralizedGaussianDiffusion,
)
from diffusion_model_nemo_tpu_torch.modules.unet import Unet
from diffusion_model_nemo_tpu_torch.ops import attention as TA
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

REPO = Path(__file__).resolve().parents[1]
IMG = 16
NET = dict(dim=32, dim_mults=(1, 2), channels=3, use_convnext=False, resnet_block_groups=8)
# Whole U-Net in float32: the 2e-4 of tests/test_torch_export.py.
F32_TOL = 2e-4
# Whole U-Net in bf16: both packages round ~40 intermediates to bf16 (8 bits
# of mantissa, 4e-3 relative) at slightly different points (torch's bf16
# conv/matmul accumulate and round per call, XLA may fuse); the relative L2
# error of the output is held to 2e-2 and each element to 0.1 + 5e-2·|ref|.
BF16_REL_L2 = 2e-2
BF16_ELEM = 1e-1


def _nets(dtype: str, params):
    """The JAX U-Net's jitted apply and the port's U-Net with the same weights."""
    jnet = JUnet(**NET, dtype=dtype)
    tnet = Unet(**NET, dtype=dtype).eval()
    tnet.load_state_dict(from_flax_params(params, tnet))
    return jax.jit(lambda p, x, t: jnet.apply({"params": p}, x, t)), tnet


@pytest.fixture(scope="module")
def f32_pair():
    """(jitted JAX apply, flax params as numpy, port U-Net) in float32."""
    x0 = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    init = jax.jit(JUnet(**NET).init)
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.float32)))
    params = params["params"]
    japply, tnet = _nets("float32", params)
    return japply, params, tnet


def _inputs(B=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    t = np.asarray([3, 17][:B], np.int32)
    return x, t


def test_small_config_reaches_every_dispatch_level():
    levels = [(2, 256, 32), (2, 64, 64), (2, 64, 32)]  # down 0, down 1, up 0
    bf16 = torch.bfloat16
    assert TA.use_packed_linattn_block(levels[0], bf16, 4, 32)
    assert not TA.use_packed_linattn_block(levels[1], bf16, 4, 32)
    assert TA.use_linattn_tokens(levels[1], bf16, 4, 32)
    assert TA.use_small_attn_block((2, 64, 64), bf16, 4, 32)  # mid 8x8 C64


def test_unet_forward_f32_matches_jax(f32_pair):
    japply, params, tnet = f32_pair
    x, t = _inputs()
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    ref = np.asarray(japply(params, jnp.asarray(x), jnp.asarray(t)))
    assert ours.shape == ref.shape == (2, IMG, IMG, 3) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=F32_TOL)


def test_unet_forward_bf16_matches_jax(f32_pair):
    """The same float32 weights, bf16 compute in both packages."""
    _japply, params, _tnet = f32_pair
    japply, tnet = _nets("bfloat16", params)
    x, t = _inputs(seed=3)
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    ref = np.asarray(japply(params, jnp.asarray(x), jnp.asarray(t)))
    rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    assert rel < BF16_REL_L2, rel
    np.testing.assert_allclose(ours, ref, atol=BF16_ELEM, rtol=5e-2)


def test_carrier_round_trips_every_leaf(f32_pair):
    _japply, params, tnet = f32_pair
    back = to_flax_params(tnet.state_dict(), tnet)
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out) == len(tnet.state_dict())
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf, err_msg=str(path))


def test_carrier_rejects_a_tree_that_does_not_fit(f32_pair):
    _japply, params, tnet = f32_pair
    broken = dict(params)
    broken.pop("final_conv")
    with pytest.raises(KeyError, match="final_conv"):
        from_flax_params(broken, tnet)


def _model_fns(japply, params, tnet):
    def tfn(p, x, t):
        with torch.no_grad():
            return tnet(x, t)

    return japply, tfn


def test_ddim_eta0_chain_matches_jax(f32_pair):
    """DDIM (eta = 0, T = 20, 5 strided steps) from one injected latent
    through both packages. Tolerance 1e-3: five network calls at the 2e-4
    forward tolerance, each divided by √ᾱ (≥ 0.16 on this grid) in x̂₀."""
    japply, params, tnet = f32_pair
    jfn, tfn = _model_fns(japply, params, tnet)
    kw = dict(timesteps=20, schedule_name="cosine", eta=0.0, ddim_timesteps=5)
    img = np.random.default_rng(4).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    ref = JGeneralized(**kw).p_sample_loop(
        jfn, params, img.shape, jax.random.PRNGKey(0), img=jnp.asarray(img)
    )
    ours = GeneralizedGaussianDiffusion(**kw, device="cpu").p_sample_loop(
        tfn, None, img.shape, img=torch.from_numpy(img)
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def test_ancestral_p_mean_variance_matches_jax(f32_pair):
    japply, params, tnet = f32_pair
    jfn, tfn = _model_fns(japply, params, tnet)
    x, t = _inputs(seed=5)
    t = np.asarray([0, 19], np.int32)  # t = 0 uses the clipped log-variance
    ref = JGaussian(20, "cosine").p_mean_variance(jfn, params, jnp.asarray(x), jnp.asarray(t))
    out = GaussianDiffusion(20, "cosine", device="cpu").p_mean_variance(
        tfn, None, torch.from_numpy(x), torch.from_numpy(t)
    )
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(ref.mean), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(
        np.broadcast_to(out.log_variance.numpy(), (2, 1, 1, 1)),
        np.asarray(ref.log_variance), rtol=1e-6,
    )
    np.testing.assert_allclose(
        out.pred_x_start.numpy(), np.asarray(ref.pred_x_start), atol=1e-3, rtol=1e-3
    )


def test_ancestral_chain_with_injected_noise_matches_jax_step(f32_pair):
    """One p_sample step with the same noise through both packages."""
    japply, params, tnet = f32_pair
    jfn, tfn = _model_fns(japply, params, tnet)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    jproc = JGaussian(20, "cosine")
    out = jproc.p_mean_variance(jfn, params, jnp.asarray(x), jnp.int32(7))
    ref = out.mean + jnp.exp(0.5 * out.log_variance) * noise
    ours = GaussianDiffusion(20, "cosine", device="cpu").p_sample(
        tfn, None, torch.from_numpy(x), 7, noise=torch.from_numpy(noise)
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)


def test_unported_unet_options_raise():
    for kw, slice_ in [
        (dict(use_convnext=True), "ConvNeXt"),
        (dict(use_convnext=False, num_classes=10), "class-conditional"),
        (dict(use_convnext=False, tpu_geometry="s2d"), "geometry"),
        (dict(use_convnext=False, aug_dim=9), "augmentation"),
    ]:
        with pytest.raises(NotImplementedError, match=slice_):
            Unet(dim=16, dim_mults=(1, 2), **kw)


def test_unet_small_dict_equals_the_yaml_model_section():
    from diffusion_model_nemo_tpu.config.yaml_config import load_config, to_dict
    from diffusion_model_nemo_tpu_torch.config import UNET_SMALL_MODEL, flagship_model_config

    cfg = load_config(
        REPO / "examples/configs/ddpm/unet_small.yaml", overrides=["model.image_size=32"]
    )
    assert to_dict(cfg["model"]) == UNET_SMALL_MODEL
    assert flagship_model_config()["diffusion_model"]["dim_mults"] == [1, 2, 2, 2]


def test_ddpm_model_samples_with_ddim_on_cpu():
    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config
    from diffusion_model_nemo_tpu_torch.models import DDPM

    cfg = unet_small_model_config(image_size=8, timesteps=10)
    cfg["diffusion_model"].update(dim=16, dim_mults=[1, 2])
    cfg["sampler"]["timesteps"] = 10
    model = DDPM(cfg, device="cpu", seed=0)
    model.change_sampler(
        dict(cfg["sampler"], _target_="diffusion_model_nemo.modules.GeneralizedGaussianDiffusion",
             ddim_timesteps=2)
    )
    assert isinstance(model.sampler, GeneralizedGaussianDiffusion)
    assert model.cfg.sampler.ddim_timesteps == 2
    g = torch.Generator().manual_seed(0)
    a = model.sample(2, 8, generator=g)
    b = model.sample(2, 8, generator=torch.Generator().manual_seed(0), use_ema=True)
    assert a.shape == (2, 8, 8, 3) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # ema starts as a copy


def test_port_import_loads_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this one has JAX loaded by conftest)."""
    code = (
        "import sys, diffusion_model_nemo_tpu_torch, diffusion_model_nemo_tpu_torch.serving\n"
        "import diffusion_model_nemo_tpu_torch.modules.dit, diffusion_model_nemo_tpu_torch.config.dit_small\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
        "'diffusion_model_nemo_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'diffusion_model_nemo_tpu_torch' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
