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
from collections import Counter
from pathlib import Path
from unittest.mock import patch

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
from diffusion_model_nemo_tpu_torch.modules.gaussian_diffusion import GaussianDiffusion, batched_t
from diffusion_model_nemo_tpu_torch.modules.generalized_gaussian_diffusion import (
    GeneralizedGaussianDiffusion,
)
from diffusion_model_nemo_tpu_torch.modules.unet import Unet
from diffusion_model_nemo_tpu.modules.parts import Block as JBlock
from diffusion_model_nemo_tpu_torch.modules import parts
from diffusion_model_nemo_tpu_torch.modules.parts import Block, SelfAttentionBlock
from diffusion_model_nemo_tpu_torch.ops import attention as TA
from diffusion_model_nemo_tpu_torch.ops import norm as TN
from diffusion_model_nemo_tpu_torch.ops import schedules as TS
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.mark.parametrize("t", [[0, 5], [5, 0], 0, 5], ids=["batch-0-5", "batch-5-0", "scalar-0", "scalar-5"])
def test_p_sample_masks_the_noise_per_sample_like_jax(f32_pair, t):
    """``p_sample`` at a [B] or 0-d tensor ``t`` against the JAX ``p_sample``
    (its mask ``1 - (t == 0)``), the JAX draw ``jax.random.normal(key, ...)``
    passed to the port as ``noise=``: a sample at t = 0 gets the mean, one at
    t > 0 the mean plus noise."""
    japply, params, tnet = f32_pair
    jfn, tfn = _model_fns(japply, params, tnet)
    x = np.random.default_rng(8).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    t = np.asarray(t, np.int32)
    key = jax.random.PRNGKey(9)
    ref = JGaussian(20, "cosine").p_sample(jfn, params, jnp.asarray(x), jnp.asarray(t), key)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    proc = GaussianDiffusion(20, "cosine", device="cpu")
    tt = torch.from_numpy(t)
    ours = proc.p_sample(tfn, None, torch.from_numpy(x), tt, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)
    mean = proc.p_mean_variance(tfn, None, torch.from_numpy(x), tt).mean
    for i, ti in enumerate(np.broadcast_to(t, (2,))):
        assert torch.equal(ours[i], mean[i]) == (ti == 0), (t, i)


def test_extract_takes_a_0d_tensor_without_a_host_int():
    table = torch.arange(10, dtype=torch.float32) * 0.5
    for t in range(10):
        out = TS.extract(table, torch.tensor(t), 4)
        assert out.shape == (1, 1, 1, 1) and torch.equal(out, TS.extract(table, t, 4))
    with patch.object(torch.Tensor, "__int__", side_effect=AssertionError("int() of a tensor")):
        TS.extract(table, torch.tensor(3), 4)
        batched_t(torch.tensor(3, dtype=torch.int32), torch.zeros(2, 1))


def _remat_pair(net_cls, kwargs):
    nets = [net_cls(**kwargs, remat=r) for r in (False, True)]
    nets[0].reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # every leaf non-zero (the DiT's adaLN-Zero layers start at 0)
        for p in nets[0].parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    nets[1].load_state_dict(nets[0].state_dict())
    return nets


def _remat_outputs_and_grads(net, x, t):
    """Forward and every parameter's gradient as training computes them:
    ``functional_call`` with a parameter dict (models/abstract_diffusion_model.py)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in net.state_dict().items()}
    out = torch.func.functional_call(net, params, (x, t))
    grads = torch.autograd.grad(out.square().mean(), list(params.values()))
    return out.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_remat_gives_bit_equal_outputs_and_gradients(dtype):
    """``remat=True`` (each ResNet block checkpointed, as the JAX ``nn.remat``)
    changes neither the forward nor any gradient, bit for bit; under
    ``no_grad`` it is a plain call."""
    plain, remat = _remat_pair(Unet, dict(NET, dtype=dtype))
    x, t = (torch.from_numpy(a) for a in _inputs(seed=10))
    out0, g0 = _remat_outputs_and_grads(plain, x, t)
    with patch.object(parts, "checkpoint", wraps=parts.checkpoint) as spy:
        out1, g1 = _remat_outputs_and_grads(remat, x, t)
        assert spy.call_count == 2 * 2 + 2 + 2 + 1  # down 0-1, mid, up 0, final block
        with torch.no_grad():
            remat(x, t)
        assert spy.call_count == 9
    assert torch.equal(out0, out1)
    assert set(g0) == set(g1) and len(g0) == len(plain.state_dict())
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_unported_unet_options_raise():
    """The TPU-geometry variants still raise naming their slice; ConvNeXt
    blocks and the augmentation input are ported (held against the JAX
    U-Net in tests/test_torch_port_convnext.py) and build."""
    with pytest.raises(NotImplementedError, match="geometry"):
        Unet(dim=16, dim_mults=(1, 2), use_convnext=False, tpu_geometry="s2d")
    assert isinstance(Unet(dim=16, dim_mults=(1, 2), use_convnext=True).down_0_block1, parts.ConvNextBlock)
    assert Unet(dim=16, dim_mults=(1, 2), use_convnext=False, aug_dim=9).aug_embed.weight.shape == (64, 9)


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
        "import diffusion_model_nemo_tpu_torch.tools.microbench_attn, diffusion_model_nemo_tpu_torch.tools.microbench_conv\n"
        "import diffusion_model_nemo_tpu_torch.tools.microbench_attn_lanes\n"
        "import diffusion_model_nemo_tpu_torch.config.yaml_config, diffusion_model_nemo_tpu_torch.utils.msgpack\n"
        "import diffusion_model_nemo_tpu_torch.utils.hub, diffusion_model_nemo_tpu_torch.ops.math\n"
        "import diffusion_model_nemo_tpu_torch.training.checkpoints, diffusion_model_nemo_tpu_torch.training.exp_manager\n"
        "import diffusion_model_nemo_tpu_torch.loss.variational_bound_loss\n"
        "import diffusion_model_nemo_tpu_torch.cli.common, diffusion_model_nemo_tpu_torch.cli.train_ddpm\n"
        "import diffusion_model_nemo_tpu_torch.cli.eval_ddpm, diffusion_model_nemo_tpu_torch.cli.test_ddpm\n"
        "import diffusion_model_nemo_tpu_torch.cli.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'orbax', 'yaml', "
        "'msgpack', 'PIL', 'tensorboardX', 'diffusion_model_nemo_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'diffusion_model_nemo_tpu_torch' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


# ---------------------------------------------------- FiLM Block (kernel #5) --
@pytest.mark.parametrize("film", ["per_sample", "full"])
def test_block_with_scale_shift_matches_jax(film):
    """``Block(x, scale_shift)`` (conv → GroupNorm → FiLM → SiLU) against the
    JAX ``Block`` with the same weights through the weight carrier, float32
    (1e-4: a 3×3 conv summed in another order, then the GroupNorm)."""
    B, S, C_in, C = 2, 8, 16, 32
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, S, S, C_in)).astype(np.float32)
    sshape = (B, 1, 1, C) if film == "per_sample" else (B, S, S, C)
    sc = (0.5 * rng.standard_normal(sshape)).astype(np.float32)
    sh = (0.5 * rng.standard_normal(sshape)).astype(np.float32)
    jblock = JBlock(C, groups=8)
    params = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    ref = jblock.apply({"params": params}, jnp.asarray(x), scale_shift=(jnp.asarray(sc), jnp.asarray(sh)))
    block = Block(C_in, C, groups=8)
    block.load_state_dict(from_flax_params(params, block))
    with torch.no_grad():
        ours = block(torch.from_numpy(x), (torch.from_numpy(sc), torch.from_numpy(sh)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


# ------------------------------------------------- routes under the switches --
_SWITCHES = ("DMN_TPU_PALLAS_NORM_BM", "DMN_TPU_PALLAS_LINATTN_BLOCK", "DMN_TPU_PALLAS_LINATTN")


def _route_counts(monkeypatch, dim_mults, B, env):
    """Kernel launches per forward that the dispatch chooses for a tensor off
    the CPU: the bf16 U-Net runs on meta tensors (shapes only) with every
    differentiable kernel call recorded by its wrapper's name."""
    for k in _SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    counts = Counter()

    def record(kernel, plain, *args):
        counts[kernel.__name__.removesuffix("_cuda")] += 1
        return plain(*args)

    monkeypatch.setattr(TN, "kernel_call", record)
    monkeypatch.setattr(TA, "kernel_call", record)
    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config

    cfg = dict(unet_small_model_config()["diffusion_model"], dim_mults=dim_mults)
    cfg.pop("_target_")
    net = Unet(**cfg).to("meta")
    out = net(torch.empty(B, 32, 32, 3, device="meta"), torch.empty(B, dtype=torch.int32, device="meta"))
    assert out.shape == (B, 32, 32, 3)
    return dict(counts)


_BM, _V1 = {"DMN_TPU_PALLAS_NORM_BM": "1"}, {"DMN_TPU_PALLAS_LINATTN_BLOCK": "1"}
_ROUTES = [
    # unet_small [1, 2, 4, 8]: 35 GroupNorm sites, 8 of them at C = 256
    ("unet_small", (1, 2, 4, 8), 128, {}, dict(group_norm_silu=35, linear_attention_block=4,
                                               linear_attention_tokens=1, attention_block_small=1)),
    ("unet_small", (1, 2, 4, 8), 128, _BM, dict(group_norm_silu_bm=27, group_norm_silu=8, linear_attention_block=4,
                                                linear_attention_tokens=1, attention_block_small=1)),
    ("unet_small", (1, 2, 4, 8), 128, _V1, dict(group_norm_silu=35, linear_attention_block=4,
                                                linear_attention_block_v1=1, attention_block_small=1)),
    ("unet_small", (1, 2, 4, 8), 128, {**_BM, **_V1}, dict(
        group_norm_silu_bm=27, group_norm_silu=8, linear_attention_block=4,
        linear_attention_block_v1=1, attention_block_small=1)),
    # B % 128 != 0: no batch-minor site
    ("unet_small", (1, 2, 4, 8), 64, {**_BM, **_V1}, dict(group_norm_silu=35, linear_attention_block=4,
                                                          linear_attention_block_v1=1, attention_block_small=1)),
    # DMN_TPU_PALLAS_LINATTN=0 turns #9 off: its block runs the plain composition
    ("unet_small", (1, 2, 4, 8), 128, {**_V1, "DMN_TPU_PALLAS_LINATTN": "0"}, dict(
        group_norm_silu=35, linear_attention_block=4, attention_block_small=1)),
    # flagship [1, 2, 2, 2]: every site at C <= 128
    ("flagship", (1, 2, 2, 2), 128, {}, dict(group_norm_silu=35, linear_attention_block=3,
                                             linear_attention_tokens=2, attention_block_small=1)),
    ("flagship", (1, 2, 2, 2), 128, {**_BM, **_V1}, dict(group_norm_silu_bm=35, linear_attention_block=3,
                                                         linear_attention_block_v1=2, attention_block_small=1)),
]


@pytest.mark.parametrize("name,dim_mults,B,env,expect", _ROUTES,
                         ids=[f"{r[0]}-B{r[2]}-{'+'.join(sorted(r[3])) or 'default'}" for r in _ROUTES])
def test_kernel_routes_under_the_switches(monkeypatch, name, dim_mults, B, env, expect):
    assert _route_counts(monkeypatch, list(dim_mults), B, env) == expect


def test_linear_block_switch_keeps_the_math_and_the_gradients(monkeypatch):
    """``DMN_TPU_PALLAS_LINATTN_BLOCK=1`` routes a linear SelfAttentionBlock to
    the whole-block call (#9 or its plain block); in float32 on the CPU it
    computes the composed block to 1e-5 and gives every parameter a
    gradient that matches the composed path's."""
    monkeypatch.delenv("DMN_TPU_PALLAS_LINATTN_BLOCK", raising=False)
    blk = SelfAttentionBlock(32, linear=True)
    g = torch.Generator().manual_seed(3)
    for p in blk.parameters():
        with torch.no_grad():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    blk.attn.to_qkv.reset_parameters(g)
    blk.attn.to_out.reset_parameters(g)
    x = torch.randn(2, 8, 8, 32, generator=g)
    grads = []
    for switch in (None, "1"):
        if switch:
            monkeypatch.setenv("DMN_TPU_PALLAS_LINATTN_BLOCK", switch)
        blk.zero_grad()
        out = blk(x)
        out.square().sum().backward()
        grads.append((out.detach(), {n: p.grad.clone() for n, p in blk.named_parameters()}))
    (o0, g0), (o1, g1) = grads
    torch.testing.assert_close(o1, o0, rtol=1e-5, atol=1e-5)
    assert set(g0) == set(g1) and len(g1) == 7
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-4, atol=1e-5, msg=n)
