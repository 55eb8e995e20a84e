"""The PyTorch port's DiT against the JAX package's, on the CPU.

A narrow DiT (dim 64, depth 2, 4 heads of 16, patch 2) at 64×64×3, so its
attention core sees N = 1024 tokens and takes the kernel route of
``fused_attention`` (on the CPU: the plain version the Hopper kernel is
held against). adaLN-Zero makes a freshly initialised DiT output exactly
zero, which would make every comparison vacuous, so every all-zero leaf of
the JAX init is redrawn from a seeded N(0, 0.02²) before the tree is
carried over with ``utils/weights.py:from_flax_params``. Inputs are made
with numpy from a seed and fed to both packages.

Tolerances: float32 at 2e-4 (the whole-network bar of
tests/test_torch_export.py); bf16 at relative L2 2e-2 and 0.1 + 5e-2·|ref|
per element, the U-Net's bf16 bar (tests/test_torch_port_unet.py): both
packages round every Dense output and each modulate step to bf16, at
slightly different points.
"""

from unittest.mock import patch

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.modules.dit import DiT as JDiT
from diffusion_model_nemo_tpu.modules.dit import sincos_position_embedding_2d as j_sincos
from diffusion_model_nemo_tpu.modules.generalized_gaussian_diffusion import (
    GeneralizedGaussianDiffusion as JGeneralized,
)
from diffusion_model_nemo_tpu.modules.unet import depth_to_space as j_depth_to_space
from diffusion_model_nemo_tpu_torch.modules import parts
from diffusion_model_nemo_tpu_torch.modules.dit import DiT, depth_to_space, sincos_position_embedding_2d
from diffusion_model_nemo_tpu_torch.modules.generalized_gaussian_diffusion import (
    GeneralizedGaussianDiffusion,
)
from diffusion_model_nemo_tpu_torch.ops import attention as TA
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

IMG = 64
NET = dict(dim=64, depth=2, heads=4, patch_size=2, channels=3)
F32_TOL = 2e-4
BF16_REL_L2 = 2e-2
BF16_ELEM = 1e-1


def _perturb_zero_leaves(params, seed=0, std=0.02):
    """Redraw every all-zero leaf (adaLN-Zero kernels, every bias) from a
    seeded N(0, std²)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out = [
        rng.normal(0.0, std, leaf.shape).astype(np.float32) if not np.any(leaf) else leaf
        for leaf in leaves
    ]
    return jax.tree_util.tree_unflatten(treedef, out)


def _nets(dtype: str, params):
    jnet = JDiT(**NET, dtype=dtype)
    tnet = DiT(**NET, dtype=dtype).eval()
    tnet.load_state_dict(from_flax_params(params, tnet))
    return jax.jit(lambda p, x, t: jnet.apply({"params": p}, x, t)), tnet


@pytest.fixture(scope="module")
def f32_pair():
    """(jitted JAX apply, perturbed flax params as numpy, port DiT) in float32."""
    init = jax.jit(JDiT(**NET).init)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)))
    params = _perturb_zero_leaves(jax.tree.map(np.asarray, params["params"]))
    japply, tnet = _nets("float32", params)
    return japply, params, tnet


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    return x, np.asarray([3, 517], np.int32)


def test_narrow_dit_takes_the_attention_kernel_route():
    assert TA.use_attention_kernel((2, (IMG // 2) ** 2, 4, 16))


def test_dit_forward_f32_matches_jax(f32_pair):
    japply, params, tnet = f32_pair
    x, t = _inputs()
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    ref = np.asarray(japply(params, jnp.asarray(x), jnp.asarray(t)))
    assert ours.shape == ref.shape == (2, IMG, IMG, 3) and ours.dtype == np.float32
    assert ours.std() > 0
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=F32_TOL)


def test_dit_forward_bf16_matches_jax(f32_pair):
    """The same float32 weights, bf16 compute in both packages."""
    _japply, params, _tnet = f32_pair
    japply, tnet = _nets("bfloat16", params)
    x, t = _inputs(seed=2)
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    ref = np.asarray(japply(params, jnp.asarray(x), jnp.asarray(t)))
    rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    assert rel < BF16_REL_L2, rel
    np.testing.assert_allclose(ours, ref, atol=BF16_ELEM, rtol=5e-2)


def test_dit_ddim_chain_matches_jax(f32_pair):
    """DDIM (eta = 0, T = 30, 3 strided steps) from one injected latent
    through both packages. Tolerance 1e-3: three network calls at the 2e-4
    forward tolerance, each divided by √ᾱ in x̂₀."""
    japply, params, tnet = f32_pair

    def tfn(p, x, t):
        with torch.no_grad():
            return tnet(x, t)

    kw = dict(timesteps=30, schedule_name="cosine", eta=0.0, ddim_timesteps=3)
    img = np.random.default_rng(4).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    ref = JGeneralized(**kw).p_sample_loop(
        japply, params, img.shape, jax.random.PRNGKey(0), img=jnp.asarray(img)
    )
    ours = GeneralizedGaussianDiffusion(**kw, device="cpu").p_sample_loop(
        tfn, None, img.shape, img=torch.from_numpy(img)
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def test_dit_carrier_round_trips_every_leaf(f32_pair):
    _japply, params, tnet = f32_pair
    back = to_flax_params(tnet.state_dict(), tnet)
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out) == len(tnet.state_dict())
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf, err_msg=str(path))


def test_reset_parameters_is_adaln_zero():
    """flax's init: the adaLN-Zero layers and every bias are zero, so the
    output is exactly zero; the kernels are drawn from the generator."""
    net = DiT(**NET)
    net.reset_parameters(torch.Generator().manual_seed(0))
    for name, p in net.state_dict().items():
        zero = name.endswith("bias") or name.split(".")[-2] in ("adaln_mod", "final_mod", "final_linear")
        assert bool((p == 0).all()) == zero, name
    x, t = _inputs()
    with torch.no_grad():
        out = net(torch.from_numpy(x[:1]), torch.from_numpy(t[:1]))
    assert out.shape == (1, IMG, IMG, 3) and not out.any()


@pytest.mark.parametrize("h,w,dim", [(4, 4, 32), (32, 32, 384), (2, 6, 8)])
def test_sincos_position_embedding_matches_jax(h, w, dim):
    np.testing.assert_array_equal(sincos_position_embedding_2d(h, w, dim), j_sincos(h, w, dim))


def test_depth_to_space_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 3, 4, 2 * 2 * 5)).astype(np.float32)
    np.testing.assert_array_equal(
        depth_to_space(torch.from_numpy(x), 2).numpy(), np.asarray(j_depth_to_space(jnp.asarray(x), 2))
    )


@pytest.mark.parametrize(
    "kw,slice_",
    [
        (dict(moe_experts=4), "mixture-of-experts"),
        (dict(context_dim=32), "text-conditional"),
        (dict(aug_dim=9), None),  # ported: the augmentation input builds (tests/test_torch_port_convnext.py)
        (dict(seq_axis_name="seq"), "ring attention"),
    ],
    ids=["moe_experts", "context_dim", "aug_dim", "seq_axis_name"],
)
def test_unported_dit_options_raise(kw, slice_):
    if slice_ is None:
        assert DiT(dim=32, depth=1, heads=2, **kw).aug_embed.weight.shape == (32, 9)
        return
    with pytest.raises(NotImplementedError, match=slice_):
        DiT(dim=32, depth=1, heads=2, **kw)


def test_learned_variance_and_out_dim_set_the_output_width():
    x, t = torch.zeros(1, 8, 8, 3), torch.zeros(1)
    assert DiT(dim=32, depth=1, heads=2, learned_variance=True)(x, t).shape == (1, 8, 8, 6)
    assert DiT(dim=32, depth=1, heads=2, out_dim=5)(x, t).shape == (1, 8, 8, 5)


def test_dit_small_dict_equals_the_yaml_model_section():
    from pathlib import Path

    from diffusion_model_nemo_tpu.config.yaml_config import load_config, to_dict
    from diffusion_model_nemo_tpu_torch.config import DIT_SMALL_MODEL

    repo = Path(__file__).resolve().parents[1]
    cfg = load_config(repo / "examples/configs/dit/dit_small.yaml", overrides=["model.image_size=64"])
    assert to_dict(cfg["model"]) == DIT_SMALL_MODEL


def test_dit_ddpm_samples_through_the_server_on_cpu():
    """A DiT DDPM from its config serves through ``BatchingSampler``
    unchanged (the server reads image_size from the config)."""
    from diffusion_model_nemo_tpu_torch.config import dit_small_model_config, get_target
    from diffusion_model_nemo_tpu_torch.models import DDPM
    from diffusion_model_nemo_tpu_torch.serving.server import BatchingSampler

    assert get_target("diffusion_model_nemo_tpu.modules.DiT") is DiT
    cfg = dit_small_model_config(image_size=8, timesteps=10)
    cfg["diffusion_model"].update(dim=32, depth=1, heads=2, dtype="float32")
    cfg["sampler"]["timesteps"] = 10
    model = DDPM(cfg, device="cpu", seed=0)
    assert isinstance(model.diffusion_model, DiT)
    model.change_sampler(
        dict(cfg["sampler"], _target_="diffusion_model_nemo.modules.GeneralizedGaussianDiffusion",
             ddim_timesteps=2)
    )
    batcher = BatchingSampler(model, image_size=int(model.cfg.image_size), max_batch=2).start(warmup=False)
    try:
        a = batcher.submit(2, seed=7, timeout=120)
        b = batcher.submit(2, seed=7, timeout=120)
    finally:
        batcher.stop()
    assert a.shape == (2, 8, 8, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dit_remat_gives_bit_equal_outputs_and_gradients(dtype):
    """``remat=True`` (each DiT block checkpointed, as the JAX ``nn.remat``)
    changes neither the forward nor any parameter's gradient, bit for bit,
    through ``functional_call`` with a parameter dict as training runs it
    (every leaf drawn non-zero, so no adaLN-Zero gradient is vacuous)."""
    kw = dict(dim=32, depth=2, heads=2, patch_size=2, channels=3, time_freq_dim=32, dtype=dtype)
    nets = [DiT(**kw, remat=r) for r in (False, True)]
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in nets[0].parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
    nets[1].load_state_dict(nets[0].state_dict())
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 3)).astype(np.float32))
    t = torch.tensor([3, 517], dtype=torch.int32)
    results = []
    with patch.object(parts, "checkpoint", wraps=parts.checkpoint) as spy:
        for net in nets:
            params = {k: v.detach().clone().requires_grad_(True) for k, v in net.state_dict().items()}
            out = torch.func.functional_call(net, params, (x, t))
            grads = torch.autograd.grad(out.square().mean(), list(params.values()))
            results.append((out.detach(), dict(zip(params, grads))))
    assert spy.call_count == kw["depth"]  # the remat net's blocks, once each
    (o0, g0), (o1, g1) = results
    assert torch.equal(o0, o1) and float(o0.abs().max()) > 0
    assert set(g0) == set(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
