"""The PyTorch port's ops against the JAX package, on the CPU.

For each op that holds a Hopper kernel, the port's plain version (what a CPU
tensor runs, and what the kernel is held against on the card by
chip_smoke.py) is compared with the JAX package's XLA reference in float32
and bf16, and in bf16 (the kernels' working type) also with the JAX
package's Pallas kernel, run in interpret mode as the JAX package's own
tests run it. Inputs are made with numpy from a seed and fed to both packages.

Tolerances: float32 at 1e-4 (same math, different summation order; 1e-5
for the attention cores #7 and #8, which have no projection in front); bf16
at rtol = atol = 2e-2, the JAX package's own kernel-vs-reference tolerance
(tests/test_ops_kernels.py), because the kernels round intermediates to bf16
at other points than the composition does (kernel #7 keeps its
probabilities in f32, the plain version rounds them to the input dtype
before p·v).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.ops import attention as JA
from diffusion_model_nemo_tpu.ops import norm as JN
from diffusion_model_nemo_tpu.ops import schedules as JS
from diffusion_model_nemo_tpu_torch.ops import attention as TA
from diffusion_model_nemo_tpu_torch.ops import norm as TN
from diffusion_model_nemo_tpu_torch.ops import schedules as TS

F32_TOL = 1e-4
BF16_TOL = 2e-2
H, D = 4, 32
HD = H * D
SCALE = D**-0.5


# The JAX references, jitted: one compile per shape instead of one per op.
_JGN = jax.jit(JN.group_norm_silu_reference, static_argnums=(3,))
_JBLOCK = jax.jit(JA.linear_attention_block_reference, static_argnums=(8, 9, 10))
_JSMALL = jax.jit(JA.attention_block_reference, static_argnums=(6, 7, 8))
_JTOKENS = jax.jit(
    lambda h, w: JA.linear_attention_qkv_reference(jnp.dot(h, w.astype(h.dtype)), H, D, SCALE)
)


def _close(a, b, tol):
    np.testing.assert_allclose(
        np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=tol, atol=tol
    )


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(t):
    return t.float().numpy()


def _block_params(seed, C):
    rng = np.random.default_rng(seed)
    return {
        "ng": 1.0 + 0.1 * rng.standard_normal(C),
        "nb": 0.1 * rng.standard_normal(C),
        "wqkv": rng.standard_normal((C, 3 * HD)) * C**-0.5,
        "wout": rng.standard_normal((HD, C)) * HD**-0.5,
        "bout": 0.1 * rng.standard_normal(C),
        "og": 1.0 + 0.1 * rng.standard_normal(C),
        "ob": 0.1 * rng.standard_normal(C),
    }


# ------------------------------------------------------------------ schedules --
@pytest.mark.parametrize("name", ["cosine", "linear", "quadratic", "sigmoid"])
def test_schedule_constants_match_jax_bitwise(name):
    ours = TS.compute_schedule_constants(50, name, device="cpu")
    ref = JS.compute_schedule_constants(50, name)
    for field in dataclasses.fields(ours):
        np.testing.assert_array_equal(
            getattr(ours, field.name).numpy(), np.asarray(getattr(ref, field.name)), err_msg=field.name
        )


def test_extract_scalar_and_batched():
    table = torch.arange(10, dtype=torch.float32)
    assert TS.extract(table, 3, 4).shape == (1, 1, 1, 1)
    out = TS.extract(table, torch.tensor([1, 7]), 4)
    assert out.shape == (2, 1, 1, 1) and out.flatten().tolist() == [1.0, 7.0]


# ------------------------------------------------------- kernel 1: GN + SiLU --
def _jax_gn_kernel(x, gamma, beta, groups, eps=1e-5):
    """The JAX package's Pallas GroupNorm+SiLU kernel (ops/norm.py:_kernel)
    in interpret mode: its launcher takes no interpret flag, so the test
    builds the same pallas_call around it."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    B, Hh, W, C = x.shape
    x2 = x.reshape(B, Hh * W, C)
    spec = pl.BlockSpec((1, Hh * W, C), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    chan = pl.BlockSpec((C,), lambda b: (0,), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(JN._kernel, groups=groups, eps=eps),
        out_shape=jax.ShapeDtypeStruct(x2.shape, x.dtype),
        grid=(B,),
        in_specs=[spec, chan, chan],
        out_specs=spec,
        interpret=True,
    )(x2, gamma, beta)
    return out.reshape(B, Hh, W, C)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8), ((2, 4, 4, 64), 8)])
def test_group_norm_silu_matches_jax(shape, groups, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape) * 2.0 + 0.5
    gamma = 1.0 + 0.1 * rng.standard_normal(shape[-1])
    beta = 0.1 * rng.standard_normal(shape[-1])
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    ours = TN.group_norm_silu(_t(x, tdt), _t(gamma, torch.float32), _t(beta, torch.float32), groups)
    assert ours.dtype == tdt
    jx, jg, jb = _j(x, jdt), _j(gamma, jnp.float32), _j(beta, jnp.float32)
    _close(_np(ours), _JGN(jx, jg, jb, groups), tol)
    if dtype == "bfloat16":  # the kernels' working type
        _close(_np(ours), _jax_gn_kernel(jx, jg, jb, groups), tol)


def test_group_norm_silu_film_plain_matches_jax():
    rng = np.random.default_rng(1)
    x, sc, sh = rng.standard_normal((2, 4, 4, 16)), rng.standard_normal((2, 1, 1, 16)), rng.standard_normal((2, 1, 1, 16))
    g, b = np.ones(16), np.zeros(16)
    f = torch.float32
    ours = TN.group_norm_silu(_t(x, f), _t(g, f), _t(b, f), 4, scale_shift=(_t(sc, f), _t(sh, f)))
    ref = JN.group_norm_silu_reference(
        _j(x, jnp.float32), _j(g, jnp.float32), _j(b, jnp.float32), 4,
        scale=_j(sc, jnp.float32), shift=_j(sh, jnp.float32),
    )
    _close(_np(ours), ref, F32_TOL)


# ------------------------------------------- kernel 5: GN + FiLM + SiLU, NHWC --
def _jax_gn_film_kernel(x, gamma, beta, scale, shift, groups, eps=1e-5):
    """The JAX package's Pallas FiLM kernel (ops/norm.py:_kernel_film) in
    interpret mode, around the same pallas_call as ``_pallas_forward``."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    B, Hh, W, C = x.shape
    x2 = x.reshape(B, Hh * W, C)
    spec = pl.BlockSpec((1, Hh * W, C), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    chan = pl.BlockSpec((C,), lambda b: (0,), memory_space=pltpu.VMEM)
    full = [jnp.broadcast_to(a, x.shape).reshape(B, Hh * W, C) for a in (scale, shift)]
    out = pl.pallas_call(
        functools.partial(JN._kernel_film, groups=groups, eps=eps),
        out_shape=jax.ShapeDtypeStruct(x2.shape, x.dtype),
        grid=(B,),
        in_specs=[spec, chan, chan, spec, spec],
        out_specs=spec,
        interpret=True,
    )(x2, gamma, beta, *full)
    return out.reshape(B, Hh, W, C)


FILM_F32_TOL = 1e-5


@pytest.mark.parametrize("film", ["per_sample", "full", "per_channel"])
def test_group_norm_silu_film_matches_jax(film):
    """The port's plain version of kernel #5 against the JAX reference in
    float32 (1e-5: the same one-pass statistics, summed in another order)
    and against the JAX Pallas FiLM kernel in bf16 (2e-2)."""
    B, Hh, W, C, groups = 2, 8, 8, 32, 8
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, Hh, W, C)) * 2.0 + 0.5
    g, b = 1.0 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C)
    sshape = {"per_sample": (B, 1, 1, C), "full": (B, Hh, W, C), "per_channel": (1, 1, 1, C)}[film]
    sc, sh = rng.standard_normal(sshape) * 0.5, rng.standard_normal(sshape) * 0.5
    f = torch.float32
    ours = TN.group_norm_silu(_t(x, f), _t(g, f), _t(b, f), groups, scale_shift=(_t(sc, f), _t(sh, f)))
    jf = [_j(a, jnp.float32) for a in (x, g, b, sc, sh)]
    ref = _JGN(jf[0], jf[1], jf[2], groups, 1e-5, jf[3], jf[4])
    _close(_np(ours), ref, FILM_F32_TOL)
    bf = torch.bfloat16
    ours_b = TN.group_norm_silu(_t(x, bf), _t(g, f), _t(b, f), groups, scale_shift=(_t(sc, f), _t(sh, f)))
    kernel = _jax_gn_film_kernel(_j(x, jnp.bfloat16), *jf[1:3], *jf[3:], groups)
    _close(_np(ours_b), kernel, BF16_TOL)


# ---------------------------------------- kernel 6: batch-minor GN(+FiLM)+SiLU --
@pytest.mark.parametrize("shape", [(128, 8, 8, 32), (128, 4, 4, 64), (256, 4, 4, 32)])
def test_group_norm_silu_batch_minor_matches_jax_kernel(shape):
    """The port's plain version (what kernel #6 is held against on the card)
    against the JAX Pallas batch-minor kernel in interpret mode, at the
    shapes and tolerances of tests/test_ops_kernels.py (bf16, atol 2e-2
    plain, 5e-2 with FiLM)."""
    B, Hh, W, C = shape
    rng = np.random.default_rng(12)
    x, g, b = rng.standard_normal(shape), rng.standard_normal(C), rng.standard_normal(C)
    sc, sh = rng.standard_normal((B, 1, 1, C)), rng.standard_normal((B, 1, 1, C))
    jx = _j(x, jnp.bfloat16)
    jg, jb, jsc, jsh = (_j(a, jnp.float32) for a in (g, b, sc, sh))
    f = torch.float32
    tx = _t(x, torch.bfloat16)
    ours = TN.group_norm_silu_reference(tx, _t(g, f), _t(b, f), 8)
    kernel = JN._pallas_forward_bm(jx, jg, jb, 8, 1e-5, interpret=True)
    np.testing.assert_allclose(_np(ours), np.asarray(kernel, np.float32), atol=2e-2)
    ours_f = TN.group_norm_silu_reference(tx, _t(g, f), _t(b, f), 8, 1e-5, _t(sc, f), _t(sh, f))
    kernel_f = JN._pallas_forward_bm(jx, jg, jb, 8, 1e-5, jsc, jsh, interpret=True)
    np.testing.assert_allclose(_np(ours_f), np.asarray(kernel_f, np.float32), atol=5e-2)


# ------------------------------------------- kernel 2: packed linattn block --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 32), (2, 128, 64)])
def test_linear_attention_block_matches_jax(shape, dtype):
    B, N, C = shape
    p = _block_params(2, C)
    x = np.random.default_rng(3).standard_normal(shape) * 0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    names = ("ng", "nb", "wqkv", "wout", "bout", "og", "ob")
    assert TA.use_packed_linattn_block(shape, torch.bfloat16, H, D)
    ours = TA.fused_linear_attention_block_packed(
        _t(x, tdt), *[_t(p[k], torch.float32) for k in names], H, D, SCALE, 1e-5
    )
    jargs = (_j(x, jdt), *[_j(p[k], jnp.float32) for k in names])
    _close(_np(ours), _JBLOCK(*jargs, H, D, SCALE), tol)
    if dtype == "bfloat16":
        kernel = JA._pallas_linattn_block_packed(*jargs, H, D, SCALE, 1e-5, interpret=True)
        _close(_np(ours), kernel, tol)


# --------------------------------------- kernel 3: qkv-fused linear attention --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_attention_tokens_matches_jax(dtype):
    B, N, C = 2, 64, 64
    h = np.random.default_rng(4).standard_normal((B, N, C))
    w = _block_params(5, C)["wqkv"]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    ours = TA.linear_attention_tokens_reference(_t(h, tdt), _t(w, torch.float32), H, D, SCALE)
    jh, jw = _j(h, jdt), _j(w, jnp.float32)
    _close(_np(ours), _JTOKENS(jh, jw), tol)
    if dtype == "bfloat16":
        _close(_np(ours), JA._pallas_linattn_qkv_fused(jh, jw, H, D, SCALE, interpret=True), tol)
        # the dispatching entry point reaches the same plain version on the CPU
        assert TA.use_linattn_tokens((B, N, C), torch.bfloat16, H, D)
        entry = TA.fused_linear_attention_tokens(_t(h, tdt), _t(w, torch.float32), H, D, SCALE)
        torch.testing.assert_close(entry, ours, rtol=0, atol=0)


# ---------------------------------------- kernel 4: small attention block --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 16, 32)])
def test_attention_block_small_matches_jax(shape, dtype):
    p = _block_params(6, shape[-1])
    x = np.random.default_rng(7).standard_normal(shape) * 0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    names = ("ng", "nb", "wqkv", "wout", "bout")
    assert TA.use_small_attn_block(shape, torch.bfloat16, H, D)
    ours = TA.fused_attention_block_small(
        _t(x, tdt), *[_t(p[k], torch.float32) for k in names], H, D, SCALE, 1e-5
    )
    jargs = (_j(x, jdt), *[_j(p[k], jnp.float32) for k in names])
    _close(_np(ours), _JSMALL(*jargs, H, D, SCALE), tol)
    if dtype == "bfloat16":
        kernel = JA._pallas_attn_block_small(*jargs, H, D, SCALE, 1e-5, interpret=True)
        _close(_np(ours), kernel, tol)


# ------------------------------------- kernel 9: whole linattn block, v1 --
@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 256, 32)])
def test_linear_attention_block_v1_matches_jax(shape):
    """The port's plain block (what kernel #9 is held against on the card)
    against the JAX Pallas v1 kernel in interpret mode in bf16 (2e-2), and
    against the JAX composition in float32 (1e-5)."""
    B, N, C = shape
    p = _block_params(13, C)
    x = np.random.default_rng(14).standard_normal(shape) * 0.5
    names = ("ng", "nb", "wqkv", "wout", "bout", "og", "ob")
    tw = [_t(p[k], torch.float32) for k in names]
    jw = [_j(p[k], jnp.float32) for k in names]
    ours = TA.linear_attention_block_reference(_t(x, torch.bfloat16), *tw, H, D, SCALE)
    kernel = JA._pallas_linear_attention_block(_j(x, jnp.bfloat16), *jw, H, D, SCALE, 1e-5, interpret=True)
    _close(_np(ours), kernel, BF16_TOL)
    ours32 = TA.linear_attention_block_reference(_t(x, torch.float32), *tw, H, D, SCALE)
    _close(_np(ours32), _JBLOCK(_j(x, jnp.float32), *jw, H, D, SCALE), FILM_F32_TOL)


# ------------------------------------- kernel 8: linear attention on raw qkv --
CORE_F32_TOL = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 3 * HD), (2, 64, 3 * HD)])
def test_linear_attention_qkv_matches_jax_kernel(shape, dtype):
    """The port's plain version (what kernel #8 is held against on the card)
    against the JAX package's Pallas kernel in interpret mode."""
    qkv = np.random.default_rng(8).standard_normal(shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = CORE_F32_TOL if dtype == "float32" else BF16_TOL
    assert TA._use_linattn_qkv_kernel(shape, H, D)
    ours = TA.fused_linear_attention_qkv(_t(qkv, tdt), H, D, SCALE)
    assert ours.dtype == tdt and ours.shape == (shape[0], shape[1], HD)
    kernel = JA._pallas_linear_attention(_j(qkv, jdt), H, D, SCALE, interpret=True)
    _close(_np(ours), kernel, tol)


# --------------------------------------------- kernel 7: softmax attention --
def _jax_attn_kernel(q, k, v):
    """The JAX package's Pallas attention kernel (ops/attention.py:_attn_kernel)
    in interpret mode, around the same pallas_call as its launcher."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    B, N, h, d = q.shape

    def merge(x):
        return x.transpose(0, 2, 1, 3).reshape(B * h, N, d)

    spec = pl.BlockSpec((1, N, d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        JA._attn_kernel,
        out_shape=jax.ShapeDtypeStruct((B * h, N, d), q.dtype),
        grid=(B * h,),
        in_specs=[spec, spec, spec],
        out_specs=spec,
        interpret=True,
    )(merge(q), merge(k), merge(v))
    return out.reshape(B, h, N, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax_kernel(dtype):
    """The port's plain version against the JAX Pallas kernel at N = 1024,
    the first size the dispatch sends to the kernel; k and v are strided
    slices of one qkv tensor, as in the DiT."""
    B, N, h, d = 1, 1024, 2, 64
    rng = np.random.default_rng(9)
    qkv = rng.standard_normal((B, N, 3, h, d))
    q = qkv[:, :, 0] * d**-0.5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = CORE_F32_TOL if dtype == "float32" else BF16_TOL
    tqkv = _t(qkv, tdt)
    assert TA.use_attention_kernel((B, N, h, d))
    ours = TA.fused_attention(_t(q, tdt), tqkv[:, :, 1], tqkv[:, :, 2])
    assert ours.dtype == tdt and ours.shape == (B, N, h, d)
    kernel = _jax_attn_kernel(_j(q, jdt), _j(qkv[:, :, 1], jdt), _j(qkv[:, :, 2], jdt))
    _close(_np(ours), kernel, tol)


# ------------------------------------------------------------ dispatch rules --
_SHAPES = [
    (64, N, C)
    for N in (8, 16, 24, 64, 72, 256, 1024, 4096, 8192)
    for C in (32, 64, 96, 128, 256)
]


@pytest.mark.parametrize(
    "ours,theirs,flag",
    [
        (TA.use_packed_linattn_block, JA.use_packed_linattn_block, None),
        (TA.use_small_attn_block, JA.use_small_attn_block, None),
        (TA.use_linattn_tokens, JA._use_pallas_linattn_tokens, "tokens"),
        (TA._use_linattn_qkv_kernel, JA._use_pallas_linattn, "linattn"),
        (TA.use_attention_kernel, JA._use_pallas, "attn"),
    ],
    ids=["packed_block", "small_block", "tokens", "linattn_qkv", "attention"],
)
def test_dispatch_rules_match_jax_on_tpu(monkeypatch, ours, theirs, flag):
    """The port's rules equal the JAX package's shape/dtype conditions as
    they read on a TPU backend (where they choose the kernels); the
    attention rule with ``DMN_TPU_PALLAS_ATTN`` (an opt-in below 1024
    tokens) unset, the qkv rule with ``DMN_TPU_PALLAS_LINATTN`` unset."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("DMN_TPU_PALLAS_ATTN", raising=False)
    monkeypatch.delenv("DMN_TPU_PALLAS_LINATTN", raising=False)
    for dtype_t, dtype_j in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        for shape in _SHAPES:
            if flag == "tokens":
                expect = theirs(jax.ShapeDtypeStruct(shape, dtype_j), H, D)
            elif flag == "linattn":
                qkv = (shape[0], shape[1], 3 * HD)
                assert ours(qkv, H, D) == theirs(jax.ShapeDtypeStruct(qkv, dtype_j), H, D), qkv
                continue
            elif flag == "attn":
                for heads, d in ((6, 64), (4, 32), (16, 64)):
                    q = (shape[0], shape[1], heads, d)
                    assert ours(q) == theirs(jax.ShapeDtypeStruct(q, dtype_j)), q
                continue
            else:
                expect = theirs(shape, jnp.dtype(dtype_j), H, D)
            assert ours(shape, dtype_t, H, D) == expect, (shape, dtype_t)


def _jax_bm_rule_inputs(shape, dtype_j, scale_shape):
    x = jax.ShapeDtypeStruct(shape, dtype_j)
    return x, (None if scale_shape is None else np.zeros(scale_shape, np.float32))


@pytest.mark.parametrize("flag", ["1", "interpret", "0", None])
def test_norm_bm_rule_matches_jax_on_tpu(monkeypatch, flag):
    """``use_norm_bm`` equals the JAX package's ``_use_pallas_bm`` as it reads
    on a TPU, under each value of ``DMN_TPU_PALLAS_NORM_BM``, with and
    without FiLM (per sample, per channel)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if flag is None:
        monkeypatch.delenv("DMN_TPU_PALLAS_NORM_BM", raising=False)
    else:
        monkeypatch.setenv("DMN_TPU_PALLAS_NORM_BM", flag)
    for B in (64, 128, 256):
        for HW in (4, 8, 16, 32):
            for C in (32, 64, 128, 256):
                for dt_t, dt_j in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
                    for sshape in (None, (B, 1, 1, C), (1, 1, 1, C)):
                        shape = (B, HW, HW, C)
                        x, sc = _jax_bm_rule_inputs(shape, dt_j, sshape)
                        ours = TN.use_norm_bm(shape, dt_t, None if sc is None else sc.size)
                        assert ours == JN._use_pallas_bm(x, sc), (shape, dt_t, sshape)


@pytest.mark.parametrize("flag", [None, "0", "1"])
def test_linattn_block_v1_rule_matches_jax_on_tpu(monkeypatch, flag):
    """``use_linattn_block_v1`` equals ``_use_pallas_linattn_block`` as it
    reads on a TPU (``DMN_TPU_PALLAS_LINATTN=0`` turns it off)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if flag is None:
        monkeypatch.delenv("DMN_TPU_PALLAS_LINATTN", raising=False)
    else:
        monkeypatch.setenv("DMN_TPU_PALLAS_LINATTN", flag)
    for dt_t, dt_j in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        for shape in _SHAPES:
            expect = JA._use_pallas_linattn_block(jax.ShapeDtypeStruct(shape, dt_j), H, D)
            assert TA.use_linattn_block_v1(shape, dt_t, H, D) == expect, (shape, dt_t)


def test_switched_routes_never_reach_a_plain_version(monkeypatch):
    """Under the two switches a tensor off the CPU goes to kernel #6's or #9's
    wrapper, which raises unless it is a CUDA tensor (meta stands in)."""
    monkeypatch.setenv("DMN_TPU_PALLAS_NORM_BM", "1")
    meta = dict(device="meta")
    x = torch.empty(128, 8, 8, 32, dtype=torch.bfloat16, **meta)
    g = torch.ones(32, **meta)
    with pytest.raises(ValueError, match="group_norm_silu_bm_cuda needs a CUDA tensor"):
        TN.group_norm_silu(x, g, g, 8)
    per_sample = torch.empty(128, 1, 1, 32, **meta)
    with pytest.raises(ValueError, match="group_norm_silu_bm_cuda needs a CUDA tensor"):
        TN.group_norm_silu(x, g, g, 8, scale_shift=(per_sample, per_sample))
    full = torch.empty(128, 8, 8, 32, **meta)  # not per (sample, channel): kernel #5
    with pytest.raises(ValueError, match="group_norm_silu_film_cuda needs a CUDA tensor"):
        TN.group_norm_silu(x, g, g, 8, scale_shift=(full, full))
    tok = torch.empty(2, 64, 64, dtype=torch.bfloat16, **meta)
    w = torch.empty(64, 3 * HD, **meta)
    wo, v = torch.empty(HD, 64, **meta), torch.empty(64, **meta)
    with pytest.raises(ValueError, match="linear_attention_block_v1_cuda needs a CUDA tensor"):
        TA.fused_linear_attention_block(tok, v, v, w, wo, v, v, v, H, D, SCALE)


# ------------------------------------------------ no quiet fallback off the CPU --
def test_non_cpu_tensors_never_reach_a_plain_version():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    raises unless it is a CUDA tensor; the FiLM route goes to kernel #5's
    wrapper (meta tensors stand in for CUDA ones here)."""
    meta = dict(device="meta")
    x = torch.empty(2, 8, 8, 32, dtype=torch.bfloat16, **meta)
    g = torch.ones(32, **meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TN.group_norm_silu(x, g, g, 8)
    with pytest.raises(ValueError, match="group_norm_silu_film_cuda needs a CUDA tensor"):
        TN.group_norm_silu(x, g, g, 8, scale_shift=(x, x))
    tok = torch.empty(2, 256, 32, dtype=torch.bfloat16, **meta)
    w = torch.empty(32, 3 * HD, **meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.fused_linear_attention_tokens(tok, w, H, D, SCALE)
    # float32 at N >= 64 is TPU kernel #8's route: its wrapper, no torch substitute
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.fused_linear_attention_tokens(tok.float(), w, H, D, SCALE)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.fused_linear_attention_qkv(torch.empty(2, 64, 3 * HD, **meta), H, D, SCALE)
    # N >= 1024 is TPU kernel #7's route, in any dtype
    for dt in (torch.float32, torch.bfloat16):
        q = torch.empty(1, 1024, H, D, dtype=dt, **meta)
        with pytest.raises(ValueError, match="CUDA tensor"):
            TA.fused_attention(q, q, q)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 4, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TN.group_norm_silu_cuda(x, torch.ones(32), torch.zeros(32), 8)
    tok = torch.zeros(1, 64, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.linear_attention_tokens_cuda(tok, torch.zeros(32, 3 * HD), H, D, SCALE)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.linear_attention_qkv_cuda(torch.zeros(1, 64, 3 * HD), H, D, SCALE)
    q = torch.zeros(1, 1024, 6, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.attention_cuda(q, q, q)
