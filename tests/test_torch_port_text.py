"""The port's byte tokenizer and the DiT's cross-attention branch against the
JAX package, on the CPU.

A tiny context DiT (dim 32, depth 2, 4 heads of 8, patch 2, 16 px,
``context_dim`` 16, byte vocab 257, L = 8). adaLN-Zero and the
zero-initialised ``ca_out`` make a fresh network ignore its context (and
output zero), which would make every comparison vacuous, so every all-zero
leaf of the JAX init is redrawn from a seeded N(0, 0.02²) before the tree is
carried over with ``utils/weights.py:from_flax_params``. Inputs are made
with numpy from a seed and fed to both packages.

Tolerances: float32 at 2e-4 (the whole-network bar of
tests/test_torch_export.py); bf16 at 0.1 + 5e-2·|ref| per element, the DiT's
bf16 bar (tests/test_torch_port_dit.py): both packages round every Dense
output to bf16, at slightly different points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.modules.dit import DiT as JDiT
from diffusion_model_nemo_tpu.modules.dit import sincos_position_embedding_1d as j_sincos_1d
from diffusion_model_nemo_tpu.utils.text import ByteTokenizer as JByteTokenizer
from diffusion_model_nemo_tpu_torch.modules.dit import DiT, sincos_position_embedding_1d
from diffusion_model_nemo_tpu_torch.utils.text import ByteTokenizer
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params
from tests.test_torch_port_training_options import _with_masks

IMG, L, CTX = 16, 8, 16
NET = dict(dim=32, depth=2, heads=4, patch_size=2, channels=3, context_dim=CTX, context_vocab=257)
F32_TOL = 2e-4
BF16_ELEM = 1e-1
PROMPTS = ["a photo of class 3", "héllo wörld", ""]  # a truncated multi-byte character, an all-PAD row


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _redraw_zero_leaves(params, seed=0, std=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(0.0, std, a.shape).astype(np.float32) if not np.any(a)
                        else np.asarray(a), params)


@pytest.fixture(scope="module")
def params():
    """The JAX init of the tiny context DiT, zero leaves redrawn, as numpy."""
    init = jax.jit(JDiT(**NET).init)
    tree = init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)),
                context=jnp.zeros((1, L), jnp.int32))["params"]
    return _redraw_zero_leaves(tree)


def _port(params, dtype="float32", **kw):
    net = DiT(**{**NET, **kw}, dtype=dtype).eval()
    net.load_state_dict(from_flax_params(params, net))
    return net


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, IMG, IMG, 3)).astype(np.float32)
    return x, np.asarray([3, 517, 999], np.int32)


def _contexts(kind):
    if kind == "tokens":
        return JByteTokenizer(L).encode_batch(PROMPTS)
    if kind == "all_pad":
        return np.zeros((3, L), np.int32)
    if kind == "float":
        return np.random.default_rng(2).standard_normal((3, 5, CTX)).astype(np.float32)
    return None


def _both(params, dtype, context, x, t, **kw):
    jnet = JDiT(**{**NET, **kw}, dtype=dtype)
    ref = jax.jit(lambda p, x, t, c: jnet.apply({"params": p}, x, t, context=c))(
        params, x, t, None if context is None else jnp.asarray(context))
    with torch.no_grad():
        ours = _port(params, dtype, **kw)(torch.from_numpy(x), torch.from_numpy(t),
                                          context=None if context is None else torch.from_numpy(context))
    return ours.numpy(), np.asarray(ref)


# ----------------------------------------------------------------- tokenizer --
@pytest.mark.parametrize("max_len", [4, 8, 32])
def test_tokenizer_matches_jax(max_len):
    """encode / encode_batch / decode / null as the JAX tokenizer: a cut at
    max_len bytes may split 'é' (two bytes), and decode then replaces the
    broken tail."""
    ours, ref = ByteTokenizer(max_len), JByteTokenizer(max_len)
    texts = ["héllo", "a photo of class 7", "", "日本語のテキスト"]
    np.testing.assert_array_equal(ours.encode_batch(texts), ref.encode_batch(texts))
    np.testing.assert_array_equal(ours.encode_batch("abc"), ref.encode_batch("abc"))
    for text in texts:
        enc = ours.encode(text)
        assert enc.dtype == np.int32 and enc.shape == (max_len,)
        assert ours.decode(enc) == ref.decode(enc)
    np.testing.assert_array_equal(ours.null(3), ref.null(3))
    assert ours.vocab_size == 257 and ours.PAD == 0
    assert ByteTokenizer(2).decode(ByteTokenizer(2).encode("hé")) == "h�"  # é cut in half


@pytest.mark.parametrize("n,dim", [(8, 16), (32, 256), (1, 2), (5, 10)])
def test_sincos_position_embedding_1d_matches_jax(n, dim):
    np.testing.assert_array_equal(sincos_position_embedding_1d(n, dim), j_sincos_1d(n, dim))


def test_sincos_position_embedding_1d_needs_an_even_dim():
    with pytest.raises(ValueError, match="dim % 2"):
        sincos_position_embedding_1d(4, 7)


# ------------------------------------------------------- the context forward --
@pytest.mark.parametrize("kind", ["tokens", "all_pad", "none", "float"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_context_dit_forward_matches_jax(params, dtype, kind):
    x, t = _inputs()
    ours, ref = _both(params, dtype, _contexts(kind), x, t)
    assert ours.shape == ref.shape == (3, IMG, IMG, 3) and np.isfinite(ours).all() and ours.std() > 0
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(ours, ref, atol=BF16_ELEM, rtol=5e-2)


def test_all_pad_rows_are_the_null_context_and_prompts_move_the_output(params):
    """An all-PAD row attends to the PAD embedding alone: it equals the
    [B, 1] null context of ``context=None``; two prompts give different
    outputs."""
    net = _port(params)
    x, t = _inputs(3)
    with torch.no_grad():
        run = lambda c: net(torch.from_numpy(x), torch.from_numpy(t), context=c).numpy()  # noqa: E731
        null = run(torch.zeros((3, L), dtype=torch.int32))
        none = run(None)
        a = run(torch.from_numpy(ByteTokenizer(L).encode_batch(["class 1"] * 3)))
        b = run(torch.from_numpy(ByteTokenizer(L).encode_batch(["class 2"] * 3)))
    np.testing.assert_allclose(null, none, atol=1e-6, rtol=0)
    assert np.abs(a - b).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_length_changes_nothing(params, dtype):
    """The same captions padded to L = 8 and to L = 16 give one output (the
    padded positions are masked)."""
    net = _port(params, dtype)
    x, t = _inputs(4)
    with torch.no_grad():
        outs = [net(torch.from_numpy(x), torch.from_numpy(t),
                    context=torch.from_numpy(ByteTokenizer(n).encode_batch(["ab", "cde", ""]))).numpy()
                for n in (8, 16)]
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5 if dtype == "float32" else 0, rtol=0)


def test_context_errors_are_the_jax_dits():
    net = DiT(**{**NET, "context_vocab": 0})
    x, t = torch.zeros(1, 8, 8, 3), torch.zeros(1)
    assert not hasattr(net, "context_embed")
    with pytest.raises(ValueError, match="explicit float context"):
        net(x, t)
    with pytest.raises(ValueError, match="context_vocab > 0"):
        net(x, t, context=torch.ones((1, 4), dtype=torch.int32))
    assert net(x, t, context=torch.zeros((1, 4, CTX))).shape == (1, 8, 8, 3)


def test_reset_parameters_zeroes_ca_out():
    """flax's init: ``ca_out``'s kernel is zero as the adaLN-Zero layers'
    are, so a fresh network ignores its context; ``ca_q``, ``ca_kv`` and
    ``context_embed`` are drawn."""
    net = DiT(**NET)
    net.reset_parameters(torch.Generator().manual_seed(0))
    sd = net.state_dict()
    for i in range(NET["depth"]):
        assert not sd[f"block_{i}.ca_out.weight"].any()
        assert sd[f"block_{i}.ca_q.weight"].any() and sd[f"block_{i}.ca_kv.weight"].shape == (64, CTX)
    assert sd["context_embed.weight"].shape == (257, CTX) and sd["context_embed.weight"].any()


# ------------------------------------------------------------ the carrier --
def test_carrier_round_trips_the_context_leaves(params):
    """``context_embed`` (``embedding`` → ``weight``) and each block's
    ``ca_q`` / ``ca_kv`` / ``ca_out`` (``kernel`` [in, out] → ``weight``
    [out, in]) carry both ways, every leaf one to one."""
    net = _port(params)
    sd = net.state_dict()
    np.testing.assert_array_equal(sd["context_embed.weight"].numpy(), params["context_embed"]["embedding"])
    for name in ("ca_q", "ca_kv", "ca_out"):
        np.testing.assert_array_equal(sd[f"block_1.{name}.weight"].numpy(), params["block_1"][name]["kernel"].T)
    back = to_flax_params(sd, net)
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out) == len(sd)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf, err_msg=str(path))


# --------------------------------------------------------------- dropout --
def test_three_dropout_sites_take_the_masks_flax_drew(params):
    """With cross-attention a block has three flax dropout sites, numbered
    in call order: ``Dropout_0`` (self-attention), ``Dropout_1`` (the
    cross-attention's ``ca_out``) and ``Dropout_2`` (the MLP). The port's
    training forward with the masks flax drew equals flax's."""
    kw = dict(dropout=0.2)
    jnet = JDiT(**NET, **kw)
    net = _port(params, **kw)
    x, t = _inputs(5)
    tokens = JByteTokenizer(L).encode_batch(PROMPTS)
    fwd = _with_masks(lambda p, x, t, c: jnet.apply({"params": p}, x, t, context=c, deterministic=False,
                                                    rngs={"dropout": jax.random.PRNGKey(2)}))
    ref, masks = jax.jit(fwd)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(tokens))
    shapes = net.dropout_shapes(x.shape)
    assert sorted(masks) == sorted(shapes) == [f"block_{i}/Dropout_{j}" for i in (0, 1) for j in (0, 1, 2)]
    assert all(tuple(masks[k].shape) == shapes[k] for k in shapes)
    with torch.no_grad():
        ours = net(torch.from_numpy(x), torch.from_numpy(t), context=torch.from_numpy(tokens),
                   dropout_masks={k: torch.from_numpy(np.array(v)) for k, v in masks.items()}).numpy()
        plain = net(torch.from_numpy(x), torch.from_numpy(t), context=torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)
    assert np.abs(ours - plain).max() > 1e-3  # the masks act
