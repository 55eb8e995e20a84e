"""The port's ConvNeXt U-Net and the augmentation input of the U-Net and the
DiT, against the JAX package on the CPU.

Weights come from a flax ``init`` and are carried with
``utils/weights.py:from_flax_params``; inputs are made with numpy from a
seed. What is held:

- ``ConvNextBlock`` with and without ``res_conv``, and with a dropout mask
  (flax's own, read by intercepting ``flax.linen.Dropout.__call__``: mask =
  output ≠ 0), in float32 at 1e-5; with each, the depthwise kernel's
  layout, flax [7, 7, 1, C] → torch [C, 1, 7, 7], element by element;
- the ConvNeXt ``Unet`` (the JAX default ``use_convnext``) against the JAX
  ``Unet`` in float32 at 2e-4 (ROADMAP's north star, relative L2 and
  elementwise), with ``aug_dim = 9`` at a zero and a drawn descriptor (the
  zero one equals the network without a descriptor, bit for bit), with its
  dropout sites, and in bf16 at tests/test_torch_port_unet.py's 2e-2;
- the DiT's ``aug_embed`` at both descriptors (2e-4);
- the kernels a ConvNeXt forward launches: #1 once (``final_norm``), #2
  four times, #3 and #4 once each at unet_small's width (a shapes-only
  forward on meta tensors).
"""

from collections import Counter

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.modules.dit import DiT as JDiT
from diffusion_model_nemo_tpu.modules.parts import ConvNextBlock as JConvNextBlock
from diffusion_model_nemo_tpu.modules.unet import Unet as JUnet
from diffusion_model_nemo_tpu_torch.modules.dit import DiT
from diffusion_model_nemo_tpu_torch.modules.parts import ConvNextBlock
from diffusion_model_nemo_tpu_torch.modules.unet import Unet
from diffusion_model_nemo_tpu_torch.ops import attention as TA
from diffusion_model_nemo_tpu_torch.ops import norm as TN
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

OP_TOL = 1e-5  # float32 ops
WHOLE_TOL = 2e-4  # whole float32 network (ROADMAP north star)
BF16_REL_L2 = 2e-2  # whole bf16 U-Net (tests/test_torch_port_unet.py)
IMG, B = 8, 2
NET = dict(dim=8, dim_mults=(1, 2), channels=3, use_convnext=True, convnext_mult=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _with_masks(fn):
    """``fn(*args)`` and {flax Dropout path: output ≠ 0}."""

    def run(*args):
        records = {}

        def intercept(next_fun, args_, kwargs, context):
            out = next_fun(*args_, **kwargs)
            if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
                records["/".join(context.module.path)] = out != 0
            return out

        with nn.intercept_methods(intercept):
            out = fn(*args)
        return out, records

    return run


def _randomize(params, seed):
    """Every leaf redrawn N(0, 0.3²) (zero-initialised leaves included) so
    that no term of the forward is vacuous."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32), params)


# ------------------------------------------------------------------ block --
@pytest.mark.parametrize("c_in,c_out,drop", [(8, 8, 0.0), (8, 16, 0.0), (16, 8, 0.3)],
                         ids=["same-width", "res_conv", "dropout-mask"])
def test_convnext_block_matches_flax(c_in, c_out, drop):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, IMG, IMG, c_in)).astype(np.float32)
    temb = rng.standard_normal((B, 32)).astype(np.float32)
    jblock = JConvNextBlock(c_out, mult=2, dropout=drop or None)
    params = jax.jit(jblock.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(temb))["params"]
    params = _randomize(jax.tree.map(np.asarray, params), 1)
    block = ConvNextBlock(c_in, c_out, 32, mult=2, dropout=drop or None)
    state = from_flax_params(params, block)
    block.load_state_dict(state)
    assert (block.res_conv is not None) == (c_in != c_out)
    # the depthwise kernel's layout: flax [7, 7, 1, C] is torch [C, 1, 7, 7], and back
    k, w = params["ds_conv"]["kernel"], state["ds_conv.weight"].numpy()
    assert k.shape == (7, 7, 1, c_in) and w.shape == (c_in, 1, 7, 7)
    assert np.array_equal(w, k.transpose(3, 2, 0, 1)) and w[c_in - 1, 0, 1, 6] == k[1, 6, 0, c_in - 1]
    np.testing.assert_array_equal(to_flax_params(block.state_dict(), block)["ds_conv"]["kernel"], k)
    fwd = _with_masks(lambda p, x, t: jblock.apply({"params": p}, x, t, deterministic=not drop,
                                                   rngs={"dropout": jax.random.PRNGKey(2)}))
    ref, masks = jax.jit(fwd)(params, jnp.asarray(x), jnp.asarray(temb))
    mask = None
    if drop:
        assert list(masks) == ["Dropout_0"]
        mask = torch.from_numpy(np.array(masks["Dropout_0"]))
        assert 0.5 < float(mask.float().mean()) < 0.9
    with torch.no_grad():
        ours = block(torch.from_numpy(x), torch.from_numpy(temb), mask)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=OP_TOL, atol=OP_TOL)


# ----------------------------------------------------------------- U-Net --
@pytest.fixture(scope="module")
def convnext_pair():
    """(jitted JAX apply, flax params, port U-Net) of the aug_dim = 9
    ConvNeXt U-Net in float32, every leaf drawn."""
    kw = dict(NET, aug_dim=9)
    jnet = JUnet(**kw)
    x0 = jnp.zeros((1, IMG, IMG, 3))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), x0, jnp.zeros((1,)), None, jnp.zeros((1, 9)))["params"]
    params = _randomize(jax.tree.map(np.asarray, params), 4)
    net = Unet(**kw).eval()
    net.load_state_dict(from_flax_params(params, net))
    apply = jax.jit(lambda p, x, t, a: jnet.apply({"params": p}, x, t, None, a))
    return apply, params, net


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    t = np.asarray([-120.5, 37.25], np.float32)  # EDM's float times, negative below σ = 1
    aug = rng.standard_normal((B, 9)).astype(np.float32) * 0.3
    return x, t, aug


def test_convnext_unet_matches_jax_at_a_drawn_and_a_zero_descriptor(convnext_pair):
    apply, params, net = convnext_pair
    x, t, aug = _inputs()
    with torch.no_grad():
        for a in (aug, np.zeros_like(aug)):
            ours = net(torch.from_numpy(x), torch.from_numpy(t), aug_cond=torch.from_numpy(a)).numpy()
            ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(a)))
            assert ours.shape == ref.shape == (B, IMG, IMG, 3)
            assert _rel_l2(ours, ref) < WHOLE_TOL
            np.testing.assert_allclose(ours, ref, rtol=WHOLE_TOL, atol=WHOLE_TOL)
        drawn = net(torch.from_numpy(x), torch.from_numpy(t), aug_cond=torch.from_numpy(aug))
        assert _rel_l2(drawn.numpy(), ours) > 1e-3  # the descriptor reaches the network
        # no descriptor is the zero descriptor exactly
        assert torch.equal(net(torch.from_numpy(x), torch.from_numpy(t)), torch.from_numpy(ours))


def test_default_unet_is_convnext_and_matches_jax():
    """``Unet(dim, dim_mults)`` with no ``use_convnext`` key is the ConvNeXt
    U-Net in both packages, and a fresh ``aug_embed`` is zero."""
    jnet = JUnet(dim=8, dim_mults=(1, 2))
    x, t, _ = _inputs(seed=2)
    params = jax.tree.map(np.asarray, jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t)))
    net = Unet(dim=8, dim_mults=(1, 2)).eval()
    net.load_state_dict(from_flax_params(params["params"], net))
    with torch.no_grad():
        ours = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    ref = np.asarray(jax.jit(lambda p, x, t: jnet.apply(p, x, t))(params, jnp.asarray(x), jnp.asarray(t)))
    assert _rel_l2(ours, ref) < WHOLE_TOL
    fresh = Unet(dim=8, dim_mults=(1, 2), aug_dim=9)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    assert not fresh.aug_embed.weight.any() and fresh.down_0_block1.ds_conv.weight.any()


def test_convnext_unet_dropout_sites_match_flax():
    """The ConvNeXt U-Net's dropout sites are flax's ``<block>/Dropout_0``,
    at the shapes ``dropout_shapes`` gives; flax's training forward with
    its masks equals the port's."""
    kw = dict(NET, dropout=0.2)
    jnet = JUnet(**kw)
    x, t, _ = _inputs(seed=3)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    params = _randomize(jax.tree.map(np.asarray, params), 5)
    net = Unet(**kw)
    net.load_state_dict(from_flax_params(params, net))
    fwd = _with_masks(lambda p, x, t: jnet.apply({"params": p}, x, t, deterministic=False,
                                                 rngs={"dropout": jax.random.PRNGKey(6)}))
    ref, masks = jax.jit(fwd)(params, jnp.asarray(x), jnp.asarray(t))
    shapes = net.dropout_shapes(x.shape)
    assert {k: tuple(v.shape) for k, v in masks.items()} == shapes and len(shapes) == 9
    assert all(k.endswith("/Dropout_0") for k in shapes)
    with torch.no_grad():
        ours = net(torch.from_numpy(x), torch.from_numpy(t),
                   dropout_masks={k: torch.from_numpy(np.array(v)) for k, v in masks.items()})
    assert _rel_l2(ours.numpy(), ref) < WHOLE_TOL


def test_convnext_unet_bf16_matches_jax(convnext_pair):
    _apply, params, _net = convnext_pair
    kw = dict(NET, aug_dim=9, dtype="bfloat16")
    jnet = JUnet(**kw)
    net = Unet(**kw).eval()
    net.load_state_dict(from_flax_params(params, net))
    x, t, aug = _inputs(seed=7)
    with torch.no_grad():
        ours = net(torch.from_numpy(x), torch.from_numpy(t), aug_cond=torch.from_numpy(aug)).numpy()
    ref = jax.jit(lambda p, x, t, a: jnet.apply({"params": p}, x, t, None, a))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(aug))
    assert _rel_l2(ours, np.asarray(ref)) < BF16_REL_L2


# ------------------------------------------------------------------- DiT --
def test_dit_aug_embed_matches_jax():
    kw = dict(dim=32, depth=1, heads=2, patch_size=2, channels=3, aug_dim=9)
    jnet = JDiT(**kw)
    x, t, aug = _inputs(seed=8)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), None,
                                jnp.asarray(aug))["params"]
    params = _randomize(jax.tree.map(np.asarray, params), 9)
    net = DiT(**kw).eval()
    net.load_state_dict(from_flax_params(params, net))
    apply = jax.jit(lambda p, x, t, a: jnet.apply({"params": p}, x, t, None, a))
    outs = []
    with torch.no_grad():
        for a in (aug, np.zeros_like(aug)):
            ours = net(torch.from_numpy(x), torch.from_numpy(t), aug_cond=torch.from_numpy(a)).numpy()
            assert _rel_l2(ours, np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(a)))) < WHOLE_TOL
            outs.append(ours)
        assert np.array_equal(net(torch.from_numpy(x), torch.from_numpy(t)).numpy(), outs[1])
    assert _rel_l2(outs[0], outs[1]) > 1e-3


# ----------------------------------------------------------------- routes --
def test_convnext_unet_small_launches_final_norm_and_the_attention_kernels(monkeypatch):
    """unet_small's width with ConvNeXt blocks (bf16, [1, 2, 4, 8], 32 px,
    B = 64): the dispatch chooses #1 once (``final_norm``), #2 four times,
    #3 and #4 once each; the ConvNeXt GroupNorm(1)s are plain ops."""
    for k in ("DMN_TPU_PALLAS_NORM_BM", "DMN_TPU_PALLAS_LINATTN_BLOCK", "DMN_TPU_PALLAS_LINATTN"):
        monkeypatch.delenv(k, raising=False)
    counts = Counter()

    def record(kernel, plain, *args):
        counts[kernel.__name__.removesuffix("_cuda")] += 1
        return plain(*args)

    monkeypatch.setattr(TN, "kernel_call", record)
    monkeypatch.setattr(TA, "kernel_call", record)
    net = Unet(dim=32, dim_mults=(1, 2, 4, 8), use_convnext=True, convnext_mult=2, aug_dim=9,
               dtype="bfloat16").to("meta")
    out = net(torch.empty(64, 32, 32, 3, device="meta"), torch.empty(64, device="meta"),
              aug_cond=torch.empty(64, 9, device="meta"))
    assert out.shape == (64, 32, 32, 3)
    assert dict(counts) == dict(group_norm_silu=1, linear_attention_block=4, linear_attention_tokens=1,
                                attention_block_small=1)
