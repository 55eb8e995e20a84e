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
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.ops import attention as JA
from diffusion_model_nemo_tpu.ops import conv as JC
from diffusion_model_nemo_tpu.ops import norm as JN
from diffusion_model_nemo_tpu.ops import schedules as JS
from diffusion_model_nemo_tpu_torch import ops as TOPS
from diffusion_model_nemo_tpu_torch.ops import attention as TA
from diffusion_model_nemo_tpu_torch.ops import conv as TC
from diffusion_model_nemo_tpu_torch.ops import norm as TN
from diffusion_model_nemo_tpu_torch.ops import schedules as TS
from diffusion_model_nemo_tpu_torch.ops import transpose as TT

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ------------------------------------------ kernels 1 and 5: the cluster plan --
def _gn_shapes():
    """(HW, C, groups, dtype, vec): the U-Net's GroupNorm sites and a grid
    beyond them (odd pixel counts, C that takes element-wise pieces, wide C)."""
    return [(H * W, C, 4 if C % 8 else 8, dt, vec)
            for dt in (torch.bfloat16, torch.float32) for vec in (True, False)
            for H, W in ((1, 1), (1, 3), (4, 4), (7, 5), (8, 8), (16, 16), (32, 32), (64, 64), (128, 128))
            for C in (8, 12, 16, 24, 32, 36, 48, 64, 96, 128, 256, 512, 1024, 2048, 4096)]


def test_group_norm_plan_covers_every_shape():
    """For every shape, #1's plan gives each of a portable cluster's CTAs a
    non-empty contiguous range of pixels, the ranges cover the sample once,
    a CTA's shared memory fits one H100 CTA and equals the mirror of the
    kernel's layout, 16-byte pieces are used only where a pixel's row is
    whole pieces, the share sits in registers only where a thread holds at
    most 4 of them, and it is read twice only where shared memory cannot
    hold it."""
    for HW, C, groups, dt, vec in _gn_shapes():
        plan = TN.group_norm_plan(HW, C, groups, dt, vec)
        esize = 2 if dt == torch.bfloat16 else 4
        assert 1 <= plan.cluster <= min(8, HW), (HW, C, plan)
        assert plan.cluster * plan.pixels >= HW > (plan.cluster - 1) * plan.pixels, (HW, C, plan)
        assert plan.vec == (vec and (C * esize) % 16 == 0), (HW, C, plan)
        assert plan.smem_bytes <= 232448 and plan.smem_bytes % 16 == 0, (HW, C, plan)
        assert plan.smem_bytes == TN._group_norm_smem(C, plan.pixels, plan.form, esize, plan.vec)
        pieces = C * esize // 16
        threads, kreg = TN._GN_THREADS, TN._GN_KREG
        in_regs = plan.vec and pieces <= threads and -(-plan.pixels // (threads // pieces)) <= kreg
        assert (plan.form == "registers") == in_regs, (HW, C, plan)
        fits = TN._group_norm_smem(C, plan.pixels, "shared", esize, plan.vec) <= 232448
        assert (plan.form == "twice") == (not in_regs and not fits), (HW, C, plan)


def test_group_norm_plan_keeps_a_sample_on_one_cta_up_to_32_kb():
    """At unet_small's GroupNorm sites (B = 64) a sample is one CTA up to 32
    KB (a cluster launch costs more than the SMs it fills at these sizes),
    its share in registers where a thread holds at most 4 pieces; the 64 KB
    [32,32,32] site takes a cluster of 2 with its shares in shared memory;
    float32 [32,32,32] (128 KB) a cluster of 4; a 1 MB sample takes 8 CTAs
    with 128 KB shares in shared memory; a 4 MB sample takes 8 CTAs and the
    form that reads it twice."""
    sites = {(32, 32, 32): (2, "shared"), (16, 16, 32): (1, "registers"), (16, 16, 64): (1, "shared"),
             (8, 8, 64): (1, "registers"), (8, 8, 128): (1, "registers"), (4, 4, 128): (1, "registers"),
             (4, 4, 256): (1, "registers")}
    for (H, W, C), (cluster, form) in sites.items():
        plan = TN.group_norm_plan(H * W, C, 8, torch.bfloat16)
        assert (plan.cluster, plan.form) == (cluster, form) and plan.vec, ((H, W, C), plan)
    f32 = TN.group_norm_plan(32 * 32, 32, 8, torch.float32)
    assert f32.cluster == 4 and f32.form == "shared"
    mid = TN.group_norm_plan(64 * 64, 128, 8, torch.bfloat16)
    assert mid.cluster == 8 and mid.form == "shared"
    big = TN.group_norm_plan(128 * 128, 128, 8, torch.bfloat16)
    assert big.cluster == 8 and big.form == "twice" and big.pixels == 2048


def test_group_norm_plan_mirrors_the_kernel_source():
    """The plan's constants are the kernel's (csrc/group_norm_silu.cu):
    threads a CTA, the portable cluster bound, the register form's pieces a
    thread, the forms' codes and the shared-memory limit."""
    import re

    src = (_REPO / "diffusion_model_nemo_tpu_torch" / "csrc" / "group_norm_silu.cu").read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["THREADS"] == TN._GN_THREADS == 256 and const["MAX_CLUSTER"] == TN._GN_MAX_CLUSTER == 8
    assert const["KREG"] == TN._GN_KREG == 4
    assert "constexpr size_t SMEM_LIMIT = 232448;" in src and TN._SMEM_LIMIT == 232448
    forms = dict(re.findall(r"(TWICE|SHARED|REGISTERS) = (\d)", src))
    assert [forms[k] for k in ("TWICE", "SHARED", "REGISTERS")] == ["0", "1", "2"]
    assert TN._GN_FORMS == ("twice", "shared", "registers")


@pytest.mark.parametrize("HW,C,groups,dtype,match", [
    (64, 8192, 8, torch.bfloat16, "shared memory"),
    (64, 6144, 8, torch.float32, "shared memory"),
    (64, 30, 8, torch.bfloat16, "groups dividing C"),
    (0, 32, 8, torch.bfloat16, "HW, C >= 1"),
])
def test_group_norm_plan_refuses_what_does_not_fit(HW, C, groups, dtype, match):
    """The plan raises ValueError only where even the per-channel arrays do
    not fit (C above ~4,800) or the shape is no GroupNorm; C = 4096 fits."""
    with pytest.raises(ValueError, match=match):
        TN.group_norm_plan(HW, C, groups, dtype)
    assert TN.group_norm_plan(HW or 64, 4096, 8, dtype).smem_bytes <= 232448


def _emulate_gn_kernel(x, gamma, beta, groups, eps, cluster, scale=None, shift=None):
    """Pure-torch copy of kernel #1/#5's arithmetic (csrc/group_norm_silu.cu):
    per-channel f32 sums over each CTA's range of pixels, the cluster's
    added in rank order, then the C/G channels of each group (the kernel
    adds those by a shuffle tree: another f32 order); a = rstd·γ,
    b = β − mean·a; a per-sample FiLM folded into (a, b), a per-pixel one
    applied per element; y = silu(x·a + b), cast once."""
    B, H, W, C = x.shape
    HW, cg = H * W, C // groups
    xf = x.float().reshape(B, HW, C)
    pixels = -(-HW // cluster)
    s = ss = 0.0
    for r in range(0, HW, pixels):  # rank order
        s = s + xf[:, r : r + pixels].sum(1)
        ss = ss + xf[:, r : r + pixels].square().sum(1)
    gs, gss = s.reshape(B, groups, cg).sum(-1), ss.reshape(B, groups, cg).sum(-1)
    mean = gs / (HW * cg)
    rstd = torch.rsqrt(torch.clamp(gss / (HW * cg) - mean * mean, min=0.0) + eps)
    a = rstd.repeat_interleave(cg, -1) * gamma
    b = beta - mean.repeat_interleave(cg, -1) * a
    per_pixel = scale is not None and scale.shape[1] * scale.shape[2] > 1
    if scale is not None and not per_pixel:
        s1 = scale.float().reshape(B, C) + 1.0
        a, b = a * s1, b * s1 + shift.float().reshape(B, C)
    y = xf * a[:, None] + b[:, None]
    if per_pixel:
        y = y * (scale.float().reshape(B, HW, C) + 1.0) + shift.float().reshape(B, HW, C)
    return (y / (1.0 + torch.exp(-y))).to(x.dtype).reshape(B, H, W, C)


@pytest.mark.parametrize("film", ["none", "per sample", "per pixel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_kernel_arithmetic_stays_inside_the_kernel_tolerance(film, dtype):
    """Kernel #1/#5's arithmetic, emulated (folded coefficients, the cluster's
    sums in rank order), against the plain version it is held to on the
    card: within the kernel tolerance, 1e-4 in float32 and 2e-2 in bf16."""
    B, H, W, C = 2, 16, 16, 64
    rng = np.random.default_rng(22)
    tdt = getattr(torch, dtype)
    x = _t(rng.standard_normal((B, H, W, C)) * 2 + 0.5, tdt)
    gamma, beta = (_t(1.0 + 0.1 * rng.standard_normal(C), torch.float32), _t(0.1 * rng.standard_normal(C), torch.float32))
    film_args = ()
    if film != "none":
        fs = (B, 1, 1, C) if film == "per sample" else (B, H, W, C)
        film_args = tuple(_t(0.5 * rng.standard_normal(fs), tdt) for _ in range(2))
    plan = TN.group_norm_plan(H * W, C, 8, tdt)
    ours = _emulate_gn_kernel(x, gamma, beta, 8, 1e-5, plan.cluster, *film_args)
    ref = TN.group_norm_silu_reference(x, gamma, beta, 8, 1e-5, *film_args)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(_np(ours), _np(ref), tol)


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


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 256, 32), (2, 1024, 32), (3, 128, 128)])
def test_linear_attention_tokens_fused_reference_is_the_jax_kernels_function(shape):
    """#3's seam-true plain version (what chip_smoke.py holds kernels #3 and
    #12 against) against the JAX qkv-fused kernel in interpret mode, bf16
    h ~ N(0, 1) and W ~ N(0, 1)/sqrt(C) from seed 4: within 2.5e-4 absolute
    (outputs are under 0.1, where rtol = atol = 2e-2 would say nothing), at
    most 1% of the elements differing, and a mean |diff| strictly below the
    module composition's, which rounds qkv to bf16 before both softmaxes."""
    B, N, C = shape
    rng = np.random.default_rng(4)
    h = _t(rng.standard_normal(shape), torch.bfloat16)
    w = _t(rng.standard_normal((C, 3 * HD)) / np.sqrt(C), torch.bfloat16)
    kernel = np.asarray(
        JA._pallas_linattn_qkv_fused(_j(_np(h), jnp.bfloat16), _j(_np(w), jnp.bfloat16), H, D, SCALE,
                                     interpret=True), np.float32)
    ours = np.abs(_np(TA.linear_attention_tokens_fused_reference(h, w, H, D, SCALE)) - kernel)
    composed = np.abs(_np(TA.linear_attention_tokens_reference(h, w, H, D, SCALE)) - kernel)
    assert ours.max() <= 2.5e-4 and (ours > 0).mean() <= 0.01, (ours.max(), (ours > 0).mean())
    assert ours.mean() < composed.mean()


def test_chip_smoke_holds_kernels_3_and_12_against_the_seam_reference():
    """chip_smoke.py holds kernel #3 against the TPU kernel's seams and #12
    against the same function on its packed view; the entry point keeps the
    module composition for the CPU and for the backward's recompute."""
    import diffusion_model_nemo_tpu_torch as port

    spec = importlib.util.spec_from_file_location("chip_smoke_table", _REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    table = smoke.kernel_table(port)
    assert table["linear_attention_tokens"][2] is TA.linear_attention_tokens_fused_reference
    assert table["linear_attention_v4"][2] is TA.linear_attention_v4_fused_reference
    assert set(smoke.SEAM) == {"linear_attention_tokens", "linear_attention_v4", "linear_attention_qkv"}
    rng = np.random.default_rng(8)
    h = _t(rng.standard_normal((2, 64, 64)), torch.bfloat16)
    w = _t(rng.standard_normal((64, 3 * HD)) * 0.125, torch.float32)
    fused = TA.linear_attention_tokens_fused_reference(h, w, H, D, SCALE)
    packed = TA.linear_attention_v4_fused_reference(h.reshape(2, 32, 128), w, 64, H, D, SCALE)
    assert torch.equal(packed, fused) and fused.dtype == torch.bfloat16
    torch.testing.assert_close(TA.fused_linear_attention_tokens(h, w, H, D, SCALE),
                               TA.linear_attention_tokens_reference(h, w, H, D, SCALE), rtol=0, atol=0)


def test_seam_references_keep_their_roundings_with_float64_sums():
    """The seam check's yardstick: #3's, #12's and #8's plain versions with
    ``acc=torch.float64`` keep the same bf16 roundings and move only the
    float32 summation order: a few elements one bf16 step from the float32
    versions, #12 still equal to #3 on its packed view, and #8 in float32
    within float32 rounding."""
    rng = np.random.default_rng(9)
    h = _t(rng.standard_normal((2, 256, 64)), torch.bfloat16)
    w = _t(rng.standard_normal((64, 3 * HD)) * 0.125, torch.float32)
    qkv = _t(rng.standard_normal((2, 256, 3 * HD)), torch.bfloat16)
    for f32, f64 in (
        (TA.linear_attention_tokens_fused_reference(h, w, H, D, SCALE),
         TA.linear_attention_tokens_fused_reference(h, w, H, D, SCALE, torch.float64)),
        (TA.linear_attention_qkv_fused_reference(qkv, H, D, SCALE),
         TA.linear_attention_qkv_fused_reference(qkv, H, D, SCALE, torch.float64)),
    ):
        assert f64.dtype == f32.dtype == torch.bfloat16
        step = 2.0**-7 * float(f64.float().abs().max())
        assert float((f64.float() - f32.float()).abs().max()) <= step
        assert 0 < float((f64 != f32).float().mean()) < 0.02
    packed = TA.linear_attention_v4_fused_reference(h.reshape(2, 128, 128), w, 256, H, D, SCALE, torch.float64)
    assert torch.equal(packed, TA.linear_attention_tokens_fused_reference(h, w, H, D, SCALE, torch.float64))
    q32 = qkv.float()
    torch.testing.assert_close(TA.linear_attention_qkv_fused_reference(q32, H, D, SCALE, torch.float64),
                               TA.linear_attention_qkv_fused_reference(q32, H, D, SCALE), rtol=1e-5, atol=1e-6)


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
    """The port's plain block (the CPU route of ``fused_linear_attention_block``
    and the backward of #9) and #10's plain version (what kernel #9 is held
    against on the card: #9 computes #10's function in bf16) against the JAX
    Pallas v1 kernel in interpret mode in bf16 (2e-2), and the plain block
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
    v2 = TA.linear_attention_block_v2_reference(_t(x, torch.bfloat16), *tw, H, D, SCALE)
    _close(_np(v2), kernel, BF16_TOL)
    ours32 = TA.linear_attention_block_reference(_t(x, torch.float32), *tw, H, D, SCALE)
    _close(_np(ours32), _JBLOCK(_j(x, jnp.float32), *jw, H, D, SCALE), FILM_F32_TOL)


def test_chip_smoke_holds_kernel_9_against_the_v2_reference():
    """On the card chip_smoke.py holds kernel #9 (v1) against #10's plain
    version, whose seams #9 computes in bf16, not against the module
    composition (which #9 would miss at the microbenchmark's inputs)."""
    import diffusion_model_nemo_tpu_torch as port

    spec = importlib.util.spec_from_file_location("chip_smoke_table", _REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    table = smoke.kernel_table(port)
    assert table["linear_attention_block_v1"][2] is TA.linear_attention_block_v2_reference
    assert table["linear_attention_block_v2"][2] is TA.linear_attention_block_v2_reference


@pytest.mark.parametrize("shape", [(2, 1024, 32), (2, 256, 64), (2, 64, 128), (2, 256, 32), (2, 100, 128)])
def test_linear_attention_block_packed_reference_is_the_jax_kernels_function(shape):
    """#2's plain version (what chip_smoke.py holds kernel #2 against) against
    the JAX packed kernel in interpret mode, at unet_small's four #2 shapes
    and a ragged N: within the bf16 kernel tolerance, and strictly closer to
    it than the module composition, which rounds after the prenorm affine
    and rounds y, the out-norm and the residual sum (about one bf16 step
    against two)."""
    p = _block_params(2, shape[-1])
    x = np.random.default_rng(3).standard_normal(shape) * 0.5
    names = ("ng", "nb", "wqkv", "wout", "bout", "og", "ob")
    targs = (_t(x, torch.bfloat16), *[_t(p[k], torch.float32) for k in names])
    jargs = (_j(x, jnp.bfloat16), *[_j(p[k], jnp.float32) for k in names])
    kernel = np.asarray(JA._pallas_linattn_block_packed(*jargs, H, D, SCALE, 1e-5, interpret=True), np.float32)
    ours = _np(TA.linear_attention_block_packed_reference(*targs, H, D, SCALE))
    composed = _np(TA.linear_attention_block_reference(*targs, H, D, SCALE))
    _close(ours, kernel, BF16_TOL)
    assert np.abs(ours - kernel).max() < np.abs(composed - kernel).max()


def test_chip_smoke_holds_kernel_2_against_its_own_reference():
    """chip_smoke.py holds kernel #2 against the packed TPU kernel's seams;
    the entry point keeps the module composition for the CPU and for the
    backward's recompute, as the JAX package's custom_vjp does."""
    import diffusion_model_nemo_tpu_torch as port

    spec = importlib.util.spec_from_file_location("chip_smoke_table", _REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.kernel_table(port)["linear_attention_block"][2] is TA.linear_attention_block_packed_reference
    p = _block_params(5, 32)
    args = (_t(np.random.default_rng(6).standard_normal((2, 256, 32)), torch.bfloat16),
            *[_t(p[k], torch.float32) for k in ("ng", "nb", "wqkv", "wout", "bout", "og", "ob")])
    torch.testing.assert_close(TA.fused_linear_attention_block_packed(*args, H, D, SCALE),
                               TA.linear_attention_block_reference(*args, H, D, SCALE), rtol=0, atol=0)


# --------------------------------- the whole-block kernel's launch plan (#2, #9, #10) --
def _admitted(gate):
    """(N, C, dtype) that a whole-block kernel's callers send it: #2's gate
    (C divides 128), #9's gate (no C condition: C = 1 .. 1024 here; the
    U-Net's widest linear-attention level is 256), the microbenchmark's
    shapes for #10 in bf16 and float32."""
    if gate == "packed":
        return [(N, C, torch.bfloat16) for C in (1, 2, 4, 8, 16, 32, 64, 128) for N in range(64, 4097)
                if TA.use_packed_linattn_block((1, N, C), torch.bfloat16, H, D)]
    if gate == "v1":
        return [(N, C, torch.bfloat16) for N in range(64, 4097, 8) for C in range(1, 1025, 7)]
    if gate == "tokens":  # #3's gate: any C (here 1 .. 1280, the most the core mode holds in bf16)
        return [(N, C, torch.bfloat16) for N in range(64, 4097, 8) for C in range(1, 1281, 9)
                if TA.use_linattn_tokens((1, N, C), torch.bfloat16, H, D)]
    from diffusion_model_nemo_tpu_torch.tools import microbench_attn as MA
    from diffusion_model_nemo_tpu_torch.tools import microbench_attn_lanes as ML

    tool = MA.SHAPES if gate == "microbench" else ML.SHAPES
    return [(N, C, dt) for _B, N, C in tool for dt in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("gate", ["packed", "v1", "microbench", "tokens", "lanes"])
def test_linattn_block_plan_covers_every_admitted_shape(gate):
    """For every shape a caller sends the whole-block kernel (and, for #3's
    gate and #12's microbenchmark, its core mode), the plan gives each of
    the cluster's CTAs a non-empty contiguous slab, the slabs cover all N
    tokens once, the cluster stays portable (at most 8 CTAs) and a CTA's
    shared memory fits one H100 CTA's 232,448 bytes."""
    shapes = _admitted(gate)
    core = gate in ("tokens", "lanes")
    assert shapes
    for N, C, dt in shapes:
        plan = TA.linattn_block_plan(N, C, dt, core=core)
        assert 1 <= plan.cluster <= 8 and plan.cluster == min(8, -(-N // 128)), (N, C, plan)
        assert plan.cluster * plan.slab >= N > (plan.cluster - 1) * plan.slab, (N, C, plan)
        assert plan.smem_bytes <= 232448, (N, C, plan)
        esize = 2 if dt == torch.bfloat16 else 4
        assert plan.smem_bytes == TA._linattn_block_smem(C, plan.slab, plan.resident, esize, core)


def test_linattn_block_plan_keeps_the_main_path_resident():
    """unet_small's four #2 calls and the microbenchmark's two shapes keep
    their slab in shared memory; N = 4096 at C = 128 takes the recompute form."""
    for N, C in ((1024, 32), (256, 64), (64, 128), (256, 32)):
        plan = TA.linattn_block_plan(N, C, torch.bfloat16)
        assert plan.resident and plan.slab <= 128 and plan.smem_bytes <= 232448 // 2 - 1024, plan
    assert TA.linattn_block_plan(1024, 32, torch.bfloat16).cluster == 8
    assert not TA.linattn_block_plan(4096, 128, torch.bfloat16).resident
    assert TA.linattn_block_plan(256, 64, torch.float32).resident


def test_linattn_core_plan_keeps_no_y():
    """The core mode (#3, #12) keeps h alone: unet_small's one #3 call is one
    resident CTA a sample with room for two CTAs an SM; a slab too large to
    keep (N = 4096 at C = 256) takes the recompute form; the core's bytes are
    the block's without the f32 y."""
    plan = TA.linattn_block_plan(64, 64, torch.bfloat16, core=True)
    assert plan.cluster == 1 and plan.slab == 64 and plan.resident and plan.smem_bytes <= 232448 // 2 - 1024
    assert TA.linattn_block_plan(4096, 128, torch.bfloat16, core=True).resident
    assert not TA.linattn_block_plan(4096, 256, torch.bfloat16, core=True).resident
    assert TA.linattn_block_plan(104, 128, torch.bfloat16, core=True).slab == 104
    block, core = (TA._linattn_block_smem(64, 64, True, 2, c) for c in (False, True))
    assert block - core == 4 * 64 * 64


def test_linattn_block_plan_mirrors_the_kernel_source():
    """The plan's constants are the kernel's (csrc/linear_attention.cu):
    tile, row padding, reduction scratch and the portable cluster bound."""
    import re

    src = (_REPO / "diffusion_model_nemo_tpu_torch" / "csrc" / "linear_attention.cu").read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["TILE"] == TA._BLOCK_TILE == 64 and const["PAD"] == 8 and const["MISC_BYTES"] == 512
    assert const["MAX_CLUSTER"] == TA._BLOCK_MAX_CLUSTER == 8
    assert "constexpr size_t SMEM_LIMIT = 232448;" in src and TA._SMEM_LIMIT == 232448


_REFUSED = [
    ("linear_attention_block_cuda", (2, 64, 2048), torch.bfloat16, "shared memory"),
    ("linear_attention_block_v1_cuda", (2, 64, 1536), torch.bfloat16, "shared memory"),
    ("linear_attention_block_v2_cuda", (2, 64, 512), torch.float32, "shared memory"),
    ("linear_attention_block_v2_cuda", (2, 0, 32), torch.bfloat16, "N, C >= 1"),
]


@pytest.mark.parametrize("N,C,dtype", [(64, 1312, torch.bfloat16), (64, 416, torch.float32)])
def test_linattn_core_plan_refuses_what_does_not_fit(N, C, dtype):
    """Past the core mode's shared memory (C above 1280 in bf16, 384 in
    float32) the plan raises ValueError; there is no other route."""
    with pytest.raises(ValueError, match="shared memory"):
        TA.linattn_block_plan(N, C, dtype, core=True)
    TA.linattn_block_plan(N, C - 32, dtype, core=True)


@pytest.mark.parametrize("wrapper,shape,dtype,match", _REFUSED, ids=[f"{w}-{s}" for w, s, _d, _m in _REFUSED])
def test_whole_block_wrappers_raise_where_the_plan_refuses(wrapper, shape, dtype, match):
    """A shape the plan refuses raises ValueError in the wrapper, on any
    device and before anything is launched: there is no other route."""
    B, N, C = shape
    with pytest.raises(ValueError, match=match):
        TA.linattn_block_plan(N, C, dtype)
    v = torch.zeros(C)
    before = TOPS.launch_counts()
    with pytest.raises(ValueError, match=match):
        getattr(TA, wrapper)(torch.zeros(shape, dtype=dtype), v, v, torch.zeros(C, 3 * HD), torch.zeros(HD, C),
                             v, v, v, H, D, SCALE)
    assert TOPS.launch_counts() == before


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("C", [32, 40, 128])
def test_whole_block_weight_operands_hold_the_weights(folded, C):
    """The whole-block kernel's weight operands in bf16 are W_qkv (γ∘W_qkv
    where folded, with β·W_qkv) and W_out zero-padded to C rounded up to 8,
    in fragment order: the inverse permutation gives them back bit for bit."""
    p = {k: _t(v, torch.float32) for k, v in _block_params(48, C).items()}
    wq, bq, wo = TA._linattn_block_weights(folded, torch.bfloat16, p["ng"], p["nb"], p["wqkv"], p["wout"])
    ref_q = (p["ng"][:, None] * p["wqkv"]).bfloat16() if folded else p["wqkv"].bfloat16()
    assert torch.equal(TA.fragment_order_inverse(wq)[:C], ref_q)
    assert (bq is None) == (not folded)
    if folded:
        torch.testing.assert_close(bq, p["nb"] @ p["wqkv"], rtol=0, atol=0)
    c8 = -(-C // 8) * 8
    out = TA.fragment_order_inverse(wo)
    assert out.shape == (HD, c8) and torch.equal(out[:, :C], p["wout"].bfloat16()) and not out[:, C:].any()
    wq32, bq32, wo32 = TA._linattn_block_weights(False, torch.float32, p["ng"], p["nb"], p["wqkv"], p["wout"])
    assert torch.equal(wq32, p["wqkv"]) and bq32 is None and torch.equal(wo32[:, :C], p["wout"])


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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 64, 3 * HD), (2, 256, 3 * HD), (2, 1024, 3 * HD), (3, 128, 3 * HD)])
def test_linear_attention_qkv_fused_reference_is_the_jax_kernels_function(shape, dtype):
    """#8's seam-true plain version (what chip_smoke.py holds kernel #8
    against) against the JAX ``_linattn_kernel`` in interpret mode, qkv ~
    N(0, 1) from seed 8. In bf16: within one bf16 step at the output's scale
    (outputs are under 0.1, where rtol = atol = 2e-2 would say nothing), at
    most 0.1% of the elements differing, and a mean |diff| strictly below
    the module composition's, which rounds q_sm, k_sm and the context to
    bf16 (about a third of its elements one bf16 step away). In float32:
    within 1e-5."""
    t = _t(np.random.default_rng(8).standard_normal(shape), getattr(torch, dtype))
    kernel = np.asarray(
        JA._pallas_linear_attention(_j(_np(t), getattr(jnp, dtype)), H, D, SCALE, interpret=True), np.float32)
    ours = TA.linear_attention_qkv_fused_reference(t, H, D, SCALE)
    assert ours.dtype == t.dtype and ours.shape == (shape[0], shape[1], HD)
    if dtype == "float32":
        _close(_np(ours), kernel, CORE_F32_TOL)
        return
    diff = np.abs(_np(ours) - kernel)
    composed = np.abs(_np(TA.linear_attention_qkv_reference(t, H, D, SCALE)) - kernel)
    assert diff.max() <= 2.0**-7 * np.abs(kernel).max() and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    assert diff.mean() < composed.mean()


def test_chip_smoke_holds_kernel_8_against_the_seam_reference():
    """chip_smoke.py holds kernel #8 against the TPU kernel's seams in both
    dtypes (with the seam check in bf16), as one kernel a call at the corners
    of its gate, and no longer names the three-launch form's kernels; the
    entry point keeps the module composition for the CPU and for the
    backward's recompute, as the JAX package's custom_vjp does."""
    import diffusion_model_nemo_tpu_torch as port

    spec = importlib.util.spec_from_file_location("chip_smoke_table", _REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.kernel_table(port)["linear_attention_qkv"][2] is TA.linear_attention_qkv_fused_reference
    assert "linear_attention_qkv" in smoke.SEAM and smoke.ONE_LAUNCH["linear_attention_qkv"] == "linattn_block_kernel"
    assert not {"qkv_kv_kernel", "merge_kernel", "qkv_apply_kernel"} & set(smoke.HAND_KERNELS)
    assert set(smoke.QKV_EXTRA) == {(2, 4096, 384), (3, 104, 384), (2, 64, 384)}
    assert all(TA._use_linattn_qkv_kernel(shape, H, D) for shape in smoke.QKV_EXTRA)
    qkv = _t(np.random.default_rng(9).standard_normal((2, 64, 3 * HD)), torch.bfloat16)
    torch.testing.assert_close(TA.fused_linear_attention_qkv(qkv, H, D, SCALE),
                               TA.linear_attention_qkv_reference(qkv, H, D, SCALE), rtol=0, atol=0)
    f = qkv.float()  # in float32 the seams are the composition's math
    torch.testing.assert_close(TA.linear_attention_qkv_fused_reference(f, H, D, SCALE),
                               TA.linear_attention_qkv_reference(f, H, D, SCALE), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_linattn_raw_plan_covers_every_admitted_shape(dtype):
    """Every N that #8's gate admits (64 <= N <= 4096, N % 8 == 0) has a raw
    plan in both dtypes: a non-empty contiguous slab a CTA, the slabs
    covering N once, 128 tokens a CTA up to N = 256 and 64 beyond, up to the
    H100's largest cluster (16 CTAs), one H100 CTA's shared memory; the slab
    stays resident up to 128 tokens a CTA and reloads 64-token tiles beyond;
    the float32 U-Net's three shapes are resident in both dtypes, N = 1024
    with room for two CTAs an SM."""
    Ns = [N for N in range(1, 4200) if TA._use_linattn_qkv_kernel((1, N, 3 * HD), H, D)]
    assert (Ns[0], Ns[-1], len(Ns)) == (64, 4096, 505)
    esize = 2 if dtype == torch.bfloat16 else 4
    for N in Ns:
        plan = TA.linattn_block_plan(N, 3 * HD, dtype, raw=True)
        assert 1 <= plan.cluster <= 16 and plan.cluster == min(16, -(-N // (128 if N <= 256 else 64))), (N, plan)
        assert plan.cluster * plan.slab >= N > (plan.cluster - 1) * plan.slab, (N, plan)
        assert plan.resident == (plan.slab <= 128), (N, plan)
        assert plan.smem_bytes == TA._linattn_raw_smem(plan.slab, plan.resident, esize) <= 232448, (N, plan)
    plans = [TA.linattn_block_plan(N, 3 * HD, dtype, raw=True) for N in (64, 256, 1024)]
    assert [(p.cluster, p.slab, p.resident) for p in plans] == [(1, 64, True), (2, 128, True), (16, 64, True)]
    assert plans[2].smem_bytes <= 232448 // 2 - 1024
    with pytest.raises(ValueError, match="384"):
        TA.linattn_block_plan(256, 256, dtype, raw=True)


def test_linattn_raw_plan_mirrors_the_kernel_source():
    """The raw plan's constants are the kernel's (csrc/linear_attention.cu):
    the 64-token reload tile, 16 bytes of row padding, the f32 gram's padded
    rows and heads, which the k and v regions must hold, and the f32 rows of
    k_sm and of q_sm transposed, which take k's region in float32 and one of
    their own in bf16."""
    import re

    src = (_REPO / "diffusion_model_nemo_tpu_torch" / "csrc" / "linear_attention.cu").read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["RAW_TILE"] == TA._BLOCK_TILE == 64 and const["THREADS"] == 256
    assert const["RAW_MAX_CLUSTER"] == TA._RAW_MAX_CLUSTER == 16
    assert "constexpr int GRS = DH + 4;" in src and "constexpr int GHS = DH * GRS + 4;" in src
    assert "L.rs = HD + 16 / esize;" in src and "constexpr int FRS = HD + 4;" in src
    assert "size_t(HD) * (L.rows + 4) * 4" in src
    assert TA._RAW_GRAM_BYTES == 4 * (32 * (32 + 4) + 4) * 4 == 18496
    # a reloaded bf16 tile is smaller than the gram that takes its place; q_sm^T outgrows a reloaded f32 tile
    assert TA._linattn_raw_smem(64, False, 2) == 2048 + 1024 + 2 * 18496 + 64 * 136 * 2 + 128 * 68 * 4
    assert TA._linattn_raw_smem(64, False, 4) == 2048 + 1024 + 128 * 68 * 4 + 2 * 64 * 132 * 4
    assert TA._linattn_raw_smem(128, True, 4) == 2048 + 1024 + 3 * 128 * 132 * 4


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


@pytest.mark.parametrize("film", [False, True])
def test_norm_bm_wrapper_needs_a_cuda_tensor(film):
    """Kernel #6's wrapper takes no CPU tensor: the CPU runs the plain
    version through ``group_norm_silu``, never a substitute inside it."""
    x = torch.zeros(128, 4, 4, 32, dtype=torch.bfloat16)
    g = torch.ones(32)
    ss = (torch.zeros(128, 1, 1, 32), torch.zeros(128, 1, 1, 32)) if film else ()
    with pytest.raises(ValueError, match="group_norm_silu_bm_cuda needs a CUDA tensor"):
        TN.group_norm_silu_bm_cuda(x, g, g, 8, 1e-5, *ss)


def test_norm_bm_reads_a_per_sample_film_in_place():
    """A [B, 1, 1, C] FiLM cut from a time MLP's [B, 1, 1, 2C] output goes
    to kernel #6 as a [B, C] view of the same memory at strides (2C, 1)."""
    x = torch.zeros(4, 2, 2, 8, dtype=torch.bfloat16)
    for dt in (torch.float32, torch.bfloat16):
        scale, shift = torch.randn(4, 1, 1, 16).to(dt).chunk(2, dim=-1)
        for t in (scale, shift):
            v = TN._film_per_sample(t, x, "scale")
            assert v.shape == (4, 8) and v.stride() == (16, 1) and v.data_ptr() == t.data_ptr()
    v = TN._film_per_sample(torch.zeros(4, 8, dtype=torch.float16), x, "scale")
    assert v.dtype == torch.float32


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


# --------------------------------------------------- kernel 11: 3x3 conv --
_CONV_SHAPES = [(2, 8, 8, 32, 32), (2, 8, 8, 64, 32), (2, 4, 4, 64, 64)]


def _conv_inputs(shape, seed=31):
    B, Hh, W, C, Fo = shape
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, Hh, W, C)),
        rng.standard_normal((3, 3, C, Fo)) * 0.1,
        rng.standard_normal(Fo) * 0.1,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _CONV_SHAPES)
def test_conv3x3_matches_jax(shape, dtype):
    """The plain version of kernel #11 against the JAX ``conv3x3_reference``
    (f32 weights, rounded to x's dtype by both): float32 at 1e-4 (a 3x3 conv
    summed in another order), bf16 at 2e-2."""
    x, w, b = _conv_inputs(shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    ours = TC.conv3x3_reference(_t(x, tdt), _t(w, torch.float32), _t(b, torch.float32))
    assert ours.dtype == tdt and ours.shape == shape[:3] + (shape[4],) and ours.is_contiguous()
    ref = JC.conv3x3_reference(_j(x, jdt), _j(w, jnp.float32), _j(b, jnp.float32))
    _close(_np(ours), ref, tol)


@pytest.mark.parametrize("shape", _CONV_SHAPES)
def test_conv3x3_matches_jax_tap_split_kernel(shape):
    """The port's ungated entry (the plain version on the CPU) against the
    JAX Pallas tap-split kernel in interpret mode, bf16 x, w and b (2e-2)."""
    x, w, b = _conv_inputs(shape)
    jx, jw, jb = (_j(a, jnp.bfloat16) for a in (x, w, b))
    kernel = JC._pallas_conv3x3(
        jx, JC.pack_tap_split_weights(jw), jb.reshape(1, -1), shape[4], JC._block_g(jx, shape[4]),
        interpret=True,
    )
    ours = TC.conv3x3(*(_t(a, torch.bfloat16) for a in (x, w, b)))
    _close(_np(ours), kernel, BF16_TOL)


def test_pack_tap_split_weights_matches_jax_bitwise():
    w = np.random.default_rng(32).standard_normal((3, 3, 32, 16))
    ours = TC.pack_tap_split_weights(_t(w, torch.float32))
    np.testing.assert_array_equal(_np(ours), np.asarray(JC.pack_tap_split_weights(_j(w, jnp.float32))))


@pytest.mark.parametrize("flag", [None, "0", "1", "interpret"])
def test_tap_split_rule_matches_jax_on_tpu(monkeypatch, flag):
    """``use_tap_split`` equals the JAX ``_use_tap_split`` as it reads on a
    TPU, under each value of ``DMN_TPU_TAP_SPLIT_CONV``."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if flag is None:
        monkeypatch.delenv("DMN_TPU_TAP_SPLIT_CONV", raising=False)
    else:
        monkeypatch.setenv("DMN_TPU_TAP_SPLIT_CONV", flag)
    for B in (4, 8, 128):
        for Hh, W in ((32, 32), (16, 16), (3, 3), (4, 6)):
            for C in (32, 64, 127, 128, 256):
                for Fo in (32, 64, 128):
                    for k in (3, 1):
                        x = jax.ShapeDtypeStruct((B, Hh, W, C), jnp.bfloat16)
                        w = jax.ShapeDtypeStruct((k, k, C, Fo), jnp.bfloat16)
                        assert TC.use_tap_split(x.shape, w.shape) == JC._use_tap_split(x, w), (x.shape, w.shape)


def test_conv3x3_tap_split_gradient_matches_autograd_through_plain(monkeypatch):
    """Under the gate the op is a kernel call whose backward recomputes the
    plain conv: its gradients equal autograd through ``conv3x3_reference``."""
    monkeypatch.setenv("DMN_TPU_TAP_SPLIT_CONV", "1")
    shape = (8, 4, 4, 16, 8)
    assert TC.use_tap_split(shape[:4], (3, 3, 16, 8))
    x, w, b = _conv_inputs(shape, seed=33)
    cot = _t(np.random.default_rng(34).standard_normal(shape[:3] + (shape[4],)), torch.float32)

    def grads(fn):
        leaves = [_t(a, torch.float32).requires_grad_(True) for a in (x, w, b)]
        out = fn(*leaves)
        return out, torch.autograd.grad(out, leaves, cot)

    out_k, g_k = grads(TC.conv3x3_tap_split)
    out_p, g_p = grads(TC.conv3x3_reference)
    assert type(out_k.grad_fn).__name__.startswith("_KernelCall")
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    for a, b_ in zip(g_k, g_p):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


_PACK_SHAPES = [(2, 6, 5, 48, 40), (2, 4, 4, 32, 16), (1, 3, 7, 70, 136), (2, 5, 3, 3, 8)]


@pytest.mark.parametrize("shape", _PACK_SHAPES)
def test_conv3x3_weight_repack_round_trips_bitwise(shape):
    """The bf16 kernel's B operand (``pack_conv3x3_weights``: K in (chunk of
    32 channels, tap, channel) order, C and F zero-padded, fragment order) is
    a permutation: ``unpack_conv3x3_weights`` gives [3, 3, C, F] back bit for
    bit."""
    C, Fo = shape[3:]
    w = _t(np.random.default_rng(35).standard_normal((3, 3, C, Fo)), torch.bfloat16)
    packed = TC.pack_conv3x3_weights(w)
    assert packed.shape == (-(-C // 32) * 9, -(-Fo // 32) * 4, 32, 8) and packed.dtype == w.dtype
    assert torch.equal(TC.unpack_conv3x3_weights(packed, C, Fo), w)


def _emulate_conv3x3_mma(x, packed, C, Fo):
    """Pure-torch copy of the K loop of ``csrc/conv3x3.cu:conv3x3_mma_kernel``
    over its packed weights: per chunk of 32 input channels (C zero-padded)
    and per tap, the SAME-padded input shifted by the tap times that (chunk,
    tap)'s k32 slice of the weight, read from fragment order as the
    mma.m16n8k16 B fragments lay it out (lane 4g + t holds, for column
    8j + g, rows 2t, 2t+1, 2t+8, 2t+9 of k16 step 0, then of step 1),
    accumulated in f32."""
    B, H, W, _ = x.shape
    kp, n8 = packed.shape[:2]
    Cp = kp // 9 * 32
    xp = torch.nn.functional.pad(x.float(), (0, Cp - C, 1, 1, 1, 1))
    acc = torch.zeros(B, H, W, n8 * 8)
    for chunk in range(Cp // 32):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            frag = packed[chunk * 9 + tap].float()  # [n8, 32, 8]
            wk = torch.zeros(32, n8 * 8)
            for lane in range(32):
                g, t = divmod(lane, 4)
                rows = [16 * s + 8 * h + 2 * t + j for s in (0, 1) for h in (0, 1) for j in (0, 1)]
                for jt in range(n8):
                    wk[rows, 8 * jt + g] = frag[jt, lane]
            band = xp[:, ky:ky + H, kx:kx + W, chunk * 32:(chunk + 1) * 32]
            acc += band @ wk
    return acc[..., :Fo]


@pytest.mark.parametrize("shape", _PACK_SHAPES)
def test_conv3x3_kernel_k_order_over_the_packed_weights_is_the_conv(shape):
    """The tensor-core kernel's arithmetic, emulated in f32 over the packed
    layout (chunk x tap K order, zero padding), plus the bias equals
    ``conv3x3_reference`` in float32 within 1e-5 (the same products summed
    in another order)."""
    x, w, b = _conv_inputs(shape, seed=36)
    tx, tw, tb = _t(x, torch.float32), _t(w, torch.float32), _t(b, torch.float32)
    packed = TC.pack_conv3x3_weights(tw)
    ours = _emulate_conv3x3_mma(tx, packed, shape[3], shape[4]) + tb
    torch.testing.assert_close(ours, TC.conv3x3_reference(tx, tw, tb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", _PACK_SHAPES)
def test_conv3x3_wgmma_weight_repack_round_trips_bitwise(shape):
    """The wgmma form's B operand (``pack_conv3x3_weights_wgmma``: per chunk
    of 32 channels and output tile, 5 K-major atoms of 64 k in the 128-byte
    swizzle) is a permutation of the padded weight:
    ``unpack_conv3x3_weights_wgmma`` gives [3, 3, C, F] back bit for bit at
    both n-tiles of the form, and the swizzle moves only whole 16-byte
    pieces within a row."""
    C, Fo = shape[3:]
    w = _t(np.random.default_rng(37).standard_normal((3, 3, C, Fo)), torch.bfloat16)
    for nt in (64, 128):
        packed = TC.pack_conv3x3_weights_wgmma(w, nt)
        assert packed.shape == (-(-C // 32), -(-Fo // nt), 5, nt, 64) and packed.dtype == w.dtype
        assert torch.equal(TC.unpack_conv3x3_weights_wgmma(packed, C, Fo), w)


def _emulate_conv3x3_wgmma(x, packed, C, Fo):
    """Pure-torch copy of the K loop of ``csrc/conv3x3.cu:conv3x3_wgmma_kernel``
    over its packed weights: per chunk of 32 input channels (C zero-padded)
    and per k16 step s (tap s // 2, channels 16 (s % 2) ..), the SAME-padded
    input shifted by the tap times B[k][n] read as the wgmma descriptor
    reads it: atom s // 4, k = 16 (s % 4) + i in it, row n, 16-byte piece
    k // 8 found at position (k // 8) XOR (n % 8); accumulated in f32."""
    B, H, W, _ = x.shape
    q, nft, _, nt, _ = packed.shape
    xp = torch.nn.functional.pad(x.float(), (0, q * 32 - C, 1, 1, 1, 1))
    n = torch.arange(nt)
    acc = torch.zeros(B, H, W, nft * nt)
    for chunk in range(q):
        for s in range(18):
            ky, kx = divmod(s // 2, 3)
            bk = torch.zeros(16, nft * nt)
            for i in range(16):
                k = 16 * (s % 4) + i
                pos = ((k // 8) ^ (n % 8)) * 8 + k % 8
                bk[i] = packed[chunk, :, s // 4, n, pos].float().reshape(-1)
            c0 = chunk * 32 + 16 * (s % 2)
            acc += xp[:, ky:ky + H, kx:kx + W, c0:c0 + 16] @ bk
    return acc[..., :Fo]


@pytest.mark.parametrize("shape", _PACK_SHAPES)
def test_conv3x3_wgmma_k_order_over_the_packed_weights_is_the_conv(shape):
    """The wgmma form's arithmetic, emulated in f32 over its packed layout
    (atoms, swizzle, zero padding), plus the bias equals
    ``conv3x3_reference`` in float32 within 1e-5."""
    x, w, b = _conv_inputs(shape, seed=38)
    tx, tw, tb = _t(x, torch.float32), _t(w, torch.float32), _t(b, torch.float32)
    packed = TC.pack_conv3x3_weights_wgmma(tw, 64 if shape[4] <= 64 else 128)
    ours = _emulate_conv3x3_wgmma(tx, packed, shape[3], shape[4]) + tb
    torch.testing.assert_close(ours, TC.conv3x3_reference(tx, tw, tb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Fo,route", [(8, "mma"), (32, "mma"), (63, "mma"),
                                      (64, "wgmma"), (128, "wgmma"), (200, "wgmma")])
def test_conv3x3_route(Fo, route):
    """The bf16 kernel's form, by F alone: wgmma where F >= 64."""
    assert TC.conv3x3_route(Fo) == route


# ------------------------------------- kernel 10: whole linattn block, v2 --
_NAMES = ("ng", "nb", "wqkv", "wout", "bout", "og", "ob")


@pytest.mark.parametrize("block_g", [1, 2])
@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 256, 32)])
def test_linear_attention_block_v2_matches_jax_kernel(shape, block_g):
    """The port's v2 entry (its plain version on the CPU, what kernel #10 is
    held against on the card) against the JAX Pallas v2 kernel in interpret
    mode at 1 and 2 samples per grid step, bf16 (2e-2)."""
    p = _block_params(15, shape[-1])
    x = np.random.default_rng(16).standard_normal(shape) * 0.5
    ours = TA.linear_attention_block_v2(
        _t(x, torch.bfloat16), *[_t(p[k], torch.float32) for k in _NAMES], H, D, SCALE
    )
    kernel = JA._pallas_linear_attention_block_v2(
        _j(x, jnp.bfloat16), *[_j(p[k], jnp.float32) for k in _NAMES], H, D, SCALE, 1e-5,
        block_g=block_g, interpret=True,
    )
    _close(_np(ours), kernel, BF16_TOL)


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 256, 32)])
def test_linear_attention_block_v2_float32_matches_jax_kernel(shape):
    """In float32 v2 runs every product in float32: its plain version against
    the JAX v2 kernel in float32, interpret mode (1e-4), and against the JAX
    module composition, whose math it then is (1e-4)."""
    p = _block_params(17, shape[-1])
    x = np.random.default_rng(18).standard_normal(shape) * 0.5
    ours = TA.linear_attention_block_v2(
        _t(x, torch.float32), *[_t(p[k], torch.float32) for k in _NAMES], H, D, SCALE
    )
    assert ours.dtype == torch.float32
    kernel = JA._pallas_linear_attention_block_v2(
        _j(x, jnp.float32), *[_j(p[k], jnp.float32) for k in _NAMES], H, D, SCALE, 1e-5,
        block_g=1, interpret=True,
    )
    _close(_np(ours), kernel, F32_TOL)
    _close(_np(ours), _JBLOCK(_j(x, jnp.float32), *[_j(p[k], jnp.float32) for k in _NAMES], H, D, SCALE), F32_TOL)


def test_linear_attention_block_v2_reference_is_closer_to_exact_than_the_composition():
    """At the microbenchmark's [128, 256, 64] bf16 inputs the module
    composition (bf16 out projection and out-norm, then a bf16 residual add)
    lands up to 0.039 from a float64 evaluation of the same block where the
    out-norm's output cancels x; v2's seams (f32 out-norm and residual, one
    cast), which kernel #10 keeps, stay within 0.02 of it."""
    from diffusion_model_nemo_tpu_torch.tools import microbench_attn as MA

    B, N, C = 128, 256, 64
    x = _t(np.random.default_rng(0).standard_normal((B, N, C)), torch.bfloat16)
    w = MA._weights(C, torch.device("cpu"))
    args = (x, *w, H, D, SCALE, 1e-5)
    v2 = TA.linear_attention_block_v2_reference(*args).double()
    comp = TA.linear_attention_block_reference(*args).double()
    d = torch.float64
    ng, nb, wqkv, wout, bout, og, ob = (t.to(d) for t in w)
    xd = x.to(d)

    def gn(t, g, b):
        m, var = t.mean((1, 2), keepdim=True), t.var((1, 2), keepdim=True, unbiased=False)
        return (t - m) / torch.sqrt(var + 1e-5) * g + b

    q, k, v = (gn(xd, ng, nb) @ wqkv).split(HD, dim=-1)
    q = torch.softmax(q.reshape(B, N, H, D), -1) * SCALE
    gram = torch.einsum("bnhd,bnhe->bhde", torch.softmax(k, 1).reshape(B, N, H, D), v.reshape(B, N, H, D))
    y = torch.einsum("bnhd,bhde->bnhe", q, gram).reshape(B, N, HD) @ wout + bout
    exact = gn(y, og, ob) + xd
    err_v2, err_comp = float((v2 - exact).abs().max()), float((comp - exact).abs().max())
    assert err_v2 < 0.02 < err_comp, (err_v2, err_comp)


# ------------------------- kernels 12 and 13: the lane-packing probe's kernels --
_REPO = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=1)
def _jax_lanes_tool():
    """The JAX package's tools/microbench_attn_lanes.py, where #12 and #13 live."""
    spec = importlib.util.spec_from_file_location(
        "jax_microbench_attn_lanes", _REPO / "tools" / "microbench_attn_lanes.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_v4_kernel(x, wqkv, block_g):
    """``_v4_kernel`` in interpret mode, around the same pallas_call as ``v4_call``."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    B, N, C = x.shape
    R = N * C // 128
    kernel = functools.partial(_jax_lanes_tool()._v4_kernel, n_tokens=N, heads=H, dim_head=D, scale=SCALE)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, N, HD), x.dtype),
        grid=(B // block_g,),
        in_specs=[
            pl.BlockSpec((block_g, R, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((C, 3 * HD), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((block_g, N, HD), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(x.reshape(B, R, 128), wqkv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 32), (2, 128, 64)])
def test_linear_attention_v4_matches_jax_kernel(shape, dtype):
    """The port's v4 entry on the packed view (the plain version on the CPU,
    what kernel #12 is held against on the card) against the JAX ``_v4_kernel``
    in interpret mode: v4 runs in x's dtype, float32 at 1e-4, bf16 at 2e-2."""
    B, N, C = shape
    x = np.random.default_rng(19).standard_normal(shape)
    w = _block_params(20, C)["wqkv"]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    packed = _t(x, tdt).reshape(B, N * C // 128, 128)
    ours = TA.linear_attention_v4(packed, _t(w, torch.float32), N, H, D, SCALE)
    assert ours.dtype == tdt and ours.shape == (B, N, HD)
    kernel = _jax_v4_kernel(_j(x, jdt), _j(w, jnp.float32), block_g=2)
    _close(_np(ours), kernel, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [64, 256])
def test_transpose2d_matches_jax_kernel_exactly(rows, dtype):
    """The port's transpose entry against the JAX ``_tr_kernel`` in interpret
    mode, bit for bit."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    x = np.random.default_rng(21).standard_normal((rows, 128))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    kernel = pl.pallas_call(
        _jax_lanes_tool()._tr_kernel,
        out_shape=jax.ShapeDtypeStruct((128, rows), jdt),
        in_specs=[pl.BlockSpec((rows, 128), lambda: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((128, rows), lambda: (0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(_j(x, jdt))
    ours = TT.transpose2d(_t(x, tdt))
    assert ours.dtype == tdt and ours.is_contiguous()
    np.testing.assert_array_equal(_np(ours), np.asarray(kernel, np.float32))


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's ``__byte_perm``: byte n of the result is byte (sel >> 4n) & 7
    of the 8-byte value y:x."""
    both = x | (y << 32)
    return sum(((both >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


@pytest.mark.parametrize("rows,cols,esize", [(4096, 128, 2), (1000, 96, 2), (1001, 97, 2), (4096, 128, 4),
                                             (100, 36, 4), (37, 5, 4)])
def test_transpose_kernel_index_map_is_a_bijection(rows, cols, esize):
    """An emulation of kernel #13's index map (csrc/transpose.cu, its
    constants read from the source): each thread's V x V block (V = 16 bytes
    of elements), whole or cut at a ragged edge, writes y[c, r] = x[r, c],
    and the threads of the grid together write every element of y [cols,
    rows] exactly once. For 2-byte elements its register transpose (one byte
    permute per 32-bit word) turns the 8 rows of a block into its 8 columns."""
    import re

    src = (_REPO / "diffusion_model_nemo_tpu_torch" / "csrc" / "transpose.cu").read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    warps, pieces, row_blocks, V = const["THREADS"] // 32, const["PIECES"], const["ROW_BLOCKS"], 16 // esize
    tr, tc = warps * row_blocks * V, pieces * V
    x = np.arange(rows * cols).reshape(rows, cols)
    y = np.full((cols, rows), -1)
    hits = np.zeros((cols, rows), np.int64)
    for bx in range(-(-rows // tr)):
        for by in range(-(-cols // tc)):
            for warp in range(warps):
                for lane in range(32):
                    c0 = (by * pieces + lane // 2) * V
                    r0 = (bx * warps * row_blocks + row_blocks * warp + lane % 2) * V
                    if r0 >= rows or c0 >= cols:
                        continue
                    block = x[r0 : r0 + V, c0 : c0 + V]
                    y[c0 : c0 + V, r0 : r0 + V] = block.T
                    hits[c0 : c0 + V, r0 : r0 + V] += 1
    assert (hits == 1).all() and np.array_equal(y, x.T)
    if esize == 2:  # the 16-byte path's transpose: word m of column j holds rows 2m (low half) and 2m + 1
        e = np.random.default_rng(13).integers(0, 2**16, (8, 8))
        a = [[int(e[i, 2 * k]) | int(e[i, 2 * k + 1]) << 16 for k in range(4)] for i in range(8)]
        o = [[_byte_perm(a[2 * m][j >> 1], a[2 * m + 1][j >> 1], 0x7632 if j & 1 else 0x5410) for m in range(4)]
             for j in range(8)]
        got = np.array([[(o[j][i // 2] >> (16 * (i % 2))) & 0xFFFF for i in range(8)] for j in range(8)])
        assert np.array_equal(got, e.T)


# ------------------------------------------ the new wrappers and the registry --
def _new_wrapper_calls(device):
    tok = torch.zeros(2, 64, 32, dtype=torch.bfloat16, device=device)
    c, w, wo = torch.zeros(32, device=device), torch.zeros(32, 3 * HD, device=device), torch.zeros(HD, 32, device=device)
    x = torch.zeros(2, 8, 8, 32, dtype=torch.bfloat16, device=device)
    return {
        "linear_attention_block_v2": (TA.linear_attention_block_v2_cuda, TA.linear_attention_block_v2,
                                      (tok, c, c, w, wo, c, c, c, H, D, SCALE)),
        "linear_attention_v4": (TA.linear_attention_v4_cuda, TA.linear_attention_v4,
                                (tok.reshape(2, 16, 128), w, 64, H, D, SCALE)),
        "conv3x3": (TC.conv3x3_cuda, TC.conv3x3, (x, torch.zeros(3, 3, 32, 16, device=device), None)),
        "transpose2d": (TT.transpose2d_cuda, TT.transpose2d, (torch.zeros(64, 128, device=device),)),
    }


@pytest.mark.parametrize("name", ["linear_attention_block_v2", "linear_attention_v4", "conv3x3", "transpose2d"])
def test_new_kernel_wrappers_refuse_cpu_tensors(name):
    wrapper, _entry, args = _new_wrapper_calls("cpu")[name]
    with pytest.raises(ValueError, match=f"{wrapper.__name__} needs a CUDA tensor"):
        wrapper(*args)


@pytest.mark.parametrize("name", ["linear_attention_block_v2", "linear_attention_v4", "conv3x3", "transpose2d"])
def test_new_entries_send_non_cpu_tensors_to_their_kernel(name):
    """Off the CPU each new entry goes to its kernel's wrapper, which raises
    unless the tensor is a CUDA one (meta tensors stand in); on the CPU it
    runs the plain version and launches nothing."""
    wrapper, entry, args = _new_wrapper_calls("meta")[name]
    with pytest.raises(ValueError, match=f"{wrapper.__name__} needs a CUDA tensor"):
        entry(*args)
    before = TOPS.launch_counts()
    entry(*_new_wrapper_calls("cpu")[name][2])
    assert TOPS.launch_counts() == before


def test_kernel_registry_holds_all_thirteen_kernels():
    assert len(TOPS.KERNELS) == 13
    assert set(TOPS.launch_counts()) == set(TOPS.KERNELS)
    assert all(TOPS.KERNELS[name].__name__ == f"{name}_cuda" for name in TOPS.KERNELS)
    TOPS.reset_launch_counts()
    assert set(TOPS.launch_counts().values()) == {0}


# ------------------------- kernel 7 on the tensor cores: its seams, emulated --
def _emulate_attention_mma(q, k, v, tile):
    """Pure-torch copy of the tensor-core kernel's arithmetic
    (csrc/attention.cu:attn_mma_kernel): keys in tiles of ``tile`` (the last
    one ragged, its missing keys at -inf), f32 scores of bf16 operands, an
    online softmax in base 2 with a running row max and an f32 row sum, the
    *unnormalised* probabilities rounded to bf16 for p·v, one division at
    the end."""
    log2e = 1.4426950408889634
    B, N, h, d = q.shape
    qf, kf, vf = (a.float().permute(0, 2, 1, 3) for a in (q, k, v))  # [B, h, N, d]
    m = torch.full((B, h, N, 1), -torch.inf)
    l = torch.zeros(B, h, N, 1)
    o = torch.zeros(B, h, N, d)
    for n0 in range(0, N, tile):
        s = qf @ kf[:, :, n0 : n0 + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        f = torch.exp2((m - m_new) * log2e)
        p = torch.exp2(s * log2e - m_new * log2e)
        l = l * f + p.sum(dim=-1, keepdim=True)
        o = o * f + p.to(q.dtype).float() @ vf[:, :, n0 : n0 + tile]
        m = m_new
    return (o / l).permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("shape", [(1, 1024, 2, 64), (1, 1100, 2, 32), (1, 1024, 1, 128)])
def test_attention_tensor_core_seams_stay_inside_the_kernel_tolerance(shape, tile):
    """The redesigned kernel #7 feeds p·v the unnormalised probabilities in
    bf16 and divides by an f32 row sum, where the plain version (and the JAX
    kernel) normalise first: one bf16 rounding per term apart. Emulated here
    from numpy-seeded inputs, with k and v strided slices of one qkv tensor
    and a ragged N, it stays inside rtol = atol = 2e-2 of both."""
    B, N, h, d = shape
    qkv = np.random.default_rng(41).standard_normal((B, N, 3, h, d))
    tqkv = _t(qkv, torch.bfloat16)
    q, k, v = _t(qkv[:, :, 0] * d**-0.5, torch.bfloat16), tqkv[:, :, 1], tqkv[:, :, 2]
    assert not k.is_contiguous() and TA.use_attention_kernel(shape)
    ours = _emulate_attention_mma(q, k, v, tile)
    assert ours.dtype == torch.bfloat16 and ours.shape == shape
    _close(_np(ours), _np(TA.attention_reference(q, k, v)), BF16_TOL)
    jq, jk, jv = (_j(a, jnp.bfloat16) for a in (qkv[:, :, 0] * d**-0.5, qkv[:, :, 1], qkv[:, :, 2]))
    _close(_np(ours), _jax_attn_kernel(jq, jk, jv), BF16_TOL)


def test_attention_wrapper_refuses_misaligned_bf16_operands():
    """Kernel #7 copies 16-byte pieces of bf16 rows: a base or a stride over
    (B, N, h) that is no multiple of 16 bytes is refused with the shape."""
    qkv = torch.zeros(1, 1024, 3, 2, 64, dtype=torch.bfloat16)
    for name, t in (("q", qkv[:, :, 0]), ("k", qkv[:, :, 1]), ("v", qkv[:, :, 2])):
        TA.check_attention_alignment(name, t)  # the DiT's slices pass
    flat = torch.zeros(4 + 1024 * 2 * 64, dtype=torch.bfloat16)
    shifted = flat[4:].reshape(1, 1024, 2, 64)  # base 8 bytes off
    with pytest.raises(ValueError, match=r"bf16 k with a 16-byte aligned base.*\(1, 1024, 2, 64\)"):
        TA.check_attention_alignment("k", shifted)
    odd = torch.zeros(1, 1024, 2, 68, dtype=torch.bfloat16)[..., :64]  # rows of 136 bytes
    with pytest.raises(ValueError, match=r"bf16 v .*\(1, 1024, 2, 64\) strides \(139264, 136, 68, 1\)"):
        TA.check_attention_alignment("v", odd)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.attention_cuda(shifted, shifted, shifted)


# ------------------- kernel 4 on the tensor cores: operands, gate, emulation --
def _emulate_small_block(x, wq_f, bq, wo_f, bo, scale, eps=1e-5):
    """Kernel #4's arithmetic from the operands its wrapper derives (the
    folded weights in fragment order, read back through the inverse layout),
    with the kernel's seams: (x−μ)·rstd, q, k, v, the probabilities and the
    attention output rounded to bf16, f32 sums, the residual added in f32."""
    B, N, C = x.shape
    bf = lambda a: a.to(torch.bfloat16).float()  # noqa: E731
    wq, wo = TA.fragment_order_inverse(wq_f).float()[:C], TA.fragment_order_inverse(wo_f).float()
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 2), keepdim=True) - mean * mean, min=0.0)
    h = bf((xf - mean) * torch.rsqrt(var + eps))
    qkv = bf(h @ wq + bq).reshape(B, N, 3, H, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    s = torch.einsum("bihd,bjhd->bhij", q, k) * scale
    p = bf(torch.softmax(s, dim=-1))
    att = bf(torch.einsum("bhij,bjhd->bihd", p, v)).reshape(B, N, HD)
    return (att @ wo + bo + xf).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 8, 32), (2, 24, 96), (1, 64, 128), (2, 16, 48)])
def test_small_block_operands_compute_the_block(shape):
    """The wrapper's derived operands (γ∘W_qkv and W_out in fragment order,
    β·W_qkv, b_out) with the kernel's seams give the plain block within 2e-2."""
    C = shape[-1]
    p = _block_params(43, C)
    x = _t(np.random.default_rng(44).standard_normal(shape) * 0.5, torch.bfloat16)
    w = [_t(p[k], torch.float32) for k in ("ng", "nb", "wqkv", "wout", "bout")]
    wq_f, bq, wo_f, bo = TA._small_block_weights(*w)
    assert wq_f.shape == (-(-C // 32), 3 * HD // 8, 32, 8) and wq_f.dtype == torch.bfloat16 and wq_f.is_contiguous()
    assert wo_f.shape == (HD // 32, C // 8, 32, 8) and wo_f.dtype == torch.bfloat16 and wo_f.is_contiguous()
    assert bq.dtype == bo.dtype == torch.float32
    ours = _emulate_small_block(x, wq_f, bq, wo_f, bo, SCALE)
    _close(_np(ours), _np(TA.attention_block_reference(x, *w, H, D, SCALE)), BF16_TOL)


@pytest.mark.parametrize("shape", [(256, 384), (128, 64), (32, 8)])
def test_fragment_order_layout_is_a_pure_permutation(shape):
    """The weight re-layout moves bits and nothing else (a bitwise round
    trip), and puts each lane's mma B fragments where the kernel reads them."""
    K, J = shape
    w = _t(np.random.default_rng(45).standard_normal(shape), torch.bfloat16)
    f = TA.fragment_order(w)
    assert f.shape == (K // 32, J // 8, 32, 8) and f.is_contiguous()
    assert torch.equal(TA.fragment_order_inverse(f), w)
    assert torch.equal(f.flatten().sort().values, w.flatten().sort().values)
    # lane (g, t) of pair kp, tile nt: column 8 nt + g; rows 2t, 2t+1, 2t+8, 2t+9 of each step
    kp, nt, g, t = K // 32 - 1, J // 8 - 1, 5, 2
    rows = [32 * kp + 16 * step + 8 * half + 2 * t + j for step in (0, 1) for half in (0, 1) for j in (0, 1)]
    assert torch.equal(f[kp, nt, 4 * g + t], w[rows, 8 * nt + g])
    # a K that is no multiple of 32 gains zero rows, and nothing else moves
    odd = TA.fragment_order_inverse(TA.fragment_order(w[:K - 8]))
    assert torch.equal(odd[:K - 8], w[:K - 8]) and not odd[K - 8:].any()


@pytest.mark.parametrize("N,C", [(4, 64), (72, 64), (12, 64), (16, 44)])
def test_small_block_wrapper_refuses_shapes_outside_its_gate(N, C):
    with pytest.raises(ValueError, match=rf"attention_block_small_cuda takes .*got \[N={N}, C={C}\]"):
        TA.small_block_smem_bytes(N, C)


def test_small_block_shared_memory_follows_the_kernel_layout():
    assert TA.small_block_smem_bytes(16, 256) == 2 * 16 * (264 + 392 + 136) + 256
    assert TA.small_block_smem_bytes(16, 48) == TA.small_block_smem_bytes(16, 64)  # k padded to 32
    assert TA.small_block_smem_bytes(8, 64) == TA.small_block_smem_bytes(16, 64)  # padded to one m16 tile
    with pytest.raises(ValueError, match=r"\[N=64, C=4096\] needs \d+ B of shared memory"):
        TA.small_block_smem_bytes(64, 4096)
    x = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    c, w, wo = torch.zeros(64), torch.zeros(64, 3 * HD), torch.zeros(HD, 64)
    with pytest.raises(ValueError, match="attention_block_small_cuda needs a CUDA tensor"):
        TA.attention_block_small_cuda(x, c, c, w, wo, c, H, D, SCALE)


# ------------------------------------- derived weights per parameter version --
def _fold_sources(C=32, seed=46):
    p = _block_params(seed, C)
    return [_t(p[k], torch.float32) for k in ("ng", "nb", "wqkv")]


_WOUT = _t(_block_params(45, 32)["wout"], torch.float32)


def _block_weights(ng, nb, w_qkv):
    """Kernel #2's derived operands (γ∘W_qkv in fragment order, β·W_qkv,
    W_out in fragment order), kept per parameter version."""
    return TA._linattn_block_weights(True, torch.bfloat16, ng, nb, w_qkv, _WOUT)


def _folded(wq):
    """γ∘W_qkv [32, 384] back from kernel #2's fragment order."""
    return TA.fragment_order_inverse(wq)[:32]


def test_derived_weights_come_back_at_the_same_version():
    ng, nb, w = _fold_sources()
    a = _block_weights(ng, nb, w)
    b = _block_weights(ng, nb, w)
    assert a[0] is b[0] and a[1] is b[1]
    # the module passes weight.t(): a new view object each call, one base
    wt = w.t().contiguous()
    c, d = _block_weights(ng, nb, wt.t()), _block_weights(ng, nb, wt.t())
    assert c[0] is d[0] and c[0] is not a[0] and torch.equal(c[0], a[0])
    assert torch.equal(_folded(a[0]), TA._fold(ng, nb, w)[0])
    assert TA._linattn_core_weights(w, torch.bfloat16) is TA._linattn_core_weights(w, torch.bfloat16)
    assert TA._linattn_core_weights(w, torch.float32) is not TA._linattn_core_weights(w, torch.bfloat16)
    assert torch.equal(TA.fragment_order_inverse(TA._linattn_core_weights(w, torch.bfloat16))[:32], w.bfloat16())


@pytest.mark.parametrize("how", ["add_", "foreach", "copy_", "load_state_dict", "view"])
def test_derived_weights_follow_in_place_updates(how):
    lin = torch.nn.Linear(32, 3 * HD, bias=False)  # weight [384, 32], as Conv1x1 holds it
    ng, nb = torch.ones(32), torch.zeros(32)
    w = lin.weight.detach()
    before = _block_weights(ng, nb, w.t())
    with torch.no_grad():
        if how == "add_":
            w.add_(1.0)
        elif how == "foreach":  # the optimizer's step
            torch._foreach_add_([w], [torch.ones_like(w)])
        elif how == "copy_":  # the EMA's update of a parameter
            lin.weight.copy_(w + 1.0)
        elif how == "load_state_dict":
            lin.load_state_dict({"weight": w + 1.0})
        else:
            w.t()[0].add_(1.0)  # through another view of the same base
    after = _block_weights(ng, nb, w.t())
    assert after[0] is not before[0] and not torch.equal(after[0], before[0])
    assert torch.equal(_folded(after[0]), TA._fold(ng, nb, w.t())[0])
    assert _block_weights(ng, nb, w.t())[0] is after[0]


def test_derived_weights_are_not_taken_over_by_a_tensor_on_the_same_storage():
    ng, nb, w = _fold_sources()
    first = _block_weights(ng, nb, w)
    twin = torch.empty(0).set_(w.untyped_storage(), 0, w.shape, w.stride())  # same data_ptr, new tensor
    assert twin.data_ptr() == w.data_ptr() and twin._base is None
    with torch.no_grad():
        twin.mul_(2.0)  # bumps the twin's version only: w's entry would be stale for it
    second = _block_weights(ng, nb, twin)
    assert second[0] is not first[0] and torch.equal(_folded(second[0]), TA._fold(ng, nb, twin)[0])


def test_derived_weights_go_with_their_sources_and_skip_inference_tensors():
    ng, nb, w = _fold_sources(seed=47)
    n0 = TA._derived.stats()["entries"]
    _block_weights(ng, nb, w)
    assert TA._derived.stats()["entries"] == n0 + 1
    del w
    assert TA._derived.stats()["entries"] == n0
    with torch.inference_mode():
        inf = torch.ones(32, 3 * HD)  # tracks no version: never kept
    a, b = _block_weights(ng, nb, inf), _block_weights(ng, nb, inf)
    assert a[0] is not b[0] and torch.equal(a[0], b[0])
    assert TA._derived.stats()["entries"] == n0


def _train_two_steps_through_the_small_block(monkeypatch, cached: bool):
    """Two optimizer steps of a bf16 U-Net (8x8, dim 16: its mid attention is
    N = 16, C = 32) whose bottleneck block runs, on the CPU, an emulation of
    kernel #4 fed by the wrapper's derived operands."""
    import diffusion_model_nemo_tpu_torch as port
    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config
    from diffusion_model_nemo_tpu_torch.data import SyntheticVisionDataset
    from diffusion_model_nemo_tpu_torch.ops.recompute import _KernelCall

    calls = []

    def emulated(x, ng, nb, wqkv, wout, bout, heads, dim_head, scale, eps=1e-5):
        calls.append(tuple(x.shape))
        return _emulate_small_block(x, *TA._small_block_weights(ng, nb, wqkv, wout, bout), scale, eps)

    def kernel_call(kernel, plain, *args):
        run = emulated if kernel is TA.attention_block_small_cuda else plain
        return _KernelCall.apply(run, plain, *args)

    monkeypatch.setattr(TA, "kernel_call", kernel_call)
    monkeypatch.setattr(TA._derived, "enabled", cached)
    cfg = unet_small_model_config(image_size=8)
    cfg["diffusion_model"].update(dim=16, dim_mults=[1, 2], resnet_block_groups=4, input_dim=8, dtype="bfloat16")
    model = port.DDPM(cfg, device="cpu", seed=3)
    trainer = port.Trainer(max_steps=2, devices=1, seed=3)
    state = trainer.init_state(model, 2)
    ds = SyntheticVisionDataset(image_size=8, channels=3, length=4, seed=3)
    batch = {"image": np.stack([ds[i]["image"] for i in range(4)])}
    losses = []
    for step in range(2):
        draws = model.draw_training_inputs(batch["image"].shape, torch.Generator().manual_seed(step))
        losses.append(float(trainer.train_step(model, state, batch, draws)["train_loss"]))
    assert calls == [(4, 16, 32)] * 2, calls
    return losses, {k: v.detach().clone() for k, v in state.params.items()}


def test_training_with_derived_weights_kept_equals_training_without(monkeypatch):
    """The second step must see the first step's in-place optimizer update:
    with the cache on, losses and every parameter equal the run that derives
    the weights anew on every call, bit for bit."""
    hits0 = TA._derived.stats()["hits"]
    kept_losses, kept = _train_two_steps_through_the_small_block(monkeypatch, True)
    assert TA._derived.stats()["hits"] == hits0  # every step is a new parameter version
    fresh_losses, fresh = _train_two_steps_through_the_small_block(monkeypatch, False)
    assert kept_losses == fresh_losses and all(np.isfinite(kept_losses))
    assert all(torch.equal(kept[k], fresh[k]) for k in kept)


def test_c_launchers_are_typed_once(monkeypatch):
    """``_build.launch`` sets a launcher's ctypes signature at its first call
    and reuses the typed function afterwards."""
    import ctypes
    import types

    from diffusion_model_nemo_tpu_torch.ops import _build

    class Fn:
        sets = 0
        rc = 0

        def __setattr__(self, name, value):
            if name == "argtypes":
                type(self).sets += 1
            object.__setattr__(self, name, value)

        def __call__(self, *args):
            return self.rc

    lib = types.SimpleNamespace(dmn_fake=Fn(), dmn_attn_error_string=lambda code: b"refused")
    monkeypatch.setattr(_build, "library", lambda stem: lib)
    monkeypatch.setattr(_build, "_functions", {})
    for _ in range(3):
        _build.launch("attention", "dmn_fake", [ctypes.c_int], 1)
    assert Fn.sets == 1 and lib.dmn_fake.restype is ctypes.c_int
    assert _build.c_function("attention", "dmn_fake", [ctypes.c_int], ctypes.c_int) is lib.dmn_fake
    Fn.rc = 9
    with pytest.raises(RuntimeError, match=r"attention.cu:dmn_fake failed: CUDA error 9 \(refused\)"):
        _build.launch("attention", "dmn_fake", [ctypes.c_int], 1)
