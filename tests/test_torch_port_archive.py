"""``.dmn`` archives, the msgpack codec, the local hub and bits/dim of the
port against the JAX package, on the CPU.

The models are the YAML's unet_small cut to a tiny float32 U-Net (dim 8,
dim_mults [1, 2], 8 px, T = 20). Weights come from the JAX ``init_params``
and are carried over with ``utils/weights.py``; inputs and the bits/dim
loop's per-t noise are made in the test (the JAX noise re-derived from its
key, as ``calculate_bits_per_dimension`` splits it) and fed to both.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import DDPM as JDDPM
from diffusion_model_nemo_tpu.ops import math as JM
from diffusion_model_nemo_tpu.training.checkpoints import load_archive as j_load_archive
from diffusion_model_nemo_tpu_torch import DDPM, Trainer
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.ops import math as TM
from diffusion_model_nemo_tpu_torch.utils import msgpack

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/ddpm/unet_small.yaml"
T, IMG, B = 20, 8, 3
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic",
]
F32_REL_L2 = 2e-4  # tests/test_torch_export.py:78


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jmodel():
    """The JAX DDPM with its own weights and an EMA that differs from them."""
    model = JDDPM(cfg=j_load_config(YAML, overrides=TINY).model)
    # ``init_params``'s init (its example input and key), compiled once
    # instead of run op by op.
    x, t = jnp.zeros((1, IMG, IMG, 3), jnp.float32), jnp.zeros((1,), jnp.float32)
    model.params = jax.jit(model.diffusion_model.init)(jax.random.PRNGKey(0), x, t)["params"]

    @jax.jit
    def perturbed(params):
        leaves, treedef = jax.tree.flatten(params)
        keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
        return jax.tree.unflatten(treedef, [p + 0.05 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])

    model.ema_params = perturbed(model.params)
    return model


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32)
    t = np.asarray([0, 7, 19], np.int32)
    return x, t


def _port_out(model, params, x, t):
    return model.model_fn(params, torch.from_numpy(x), torch.from_numpy(t)).numpy()


def _jax_out(model, params, x, t):
    return np.asarray(model.model_fn(params, jnp.asarray(x), jnp.asarray(t)))


# ---------------------------------------------------------------- msgpack --
def test_msgpack_reads_and_writes_flax_unet_trees(jmodel):
    tree = jax.tree.map(np.asarray, jmodel.params)
    flax_bytes = serialization.msgpack_serialize(tree)
    ours = msgpack.unpackb(flax_bytes)
    assert jax.tree.structure(ours) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert msgpack.packb(tree) == flax_bytes
    back = serialization.msgpack_restore(msgpack.packb(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int32", "npscalar", "chunked"])
def test_msgpack_dtypes_both_ways(kind, monkeypatch):
    rng = np.random.default_rng(3)
    if kind == "npscalar":
        value = np.float32(1.25)
    elif kind == "bfloat16":
        value = np.asarray(jnp.asarray(rng.standard_normal((4, 5)), jnp.bfloat16))
    elif kind == "int32":
        value = rng.integers(-1000, 1000, (3, 7)).astype(np.int32)
    else:
        value = rng.standard_normal((33, 3)).astype(np.float32)
    if kind == "chunked":  # arrays over flax's chunk size: its chunked dict
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"leaf": value, "meta": {"n": 3, "s": "x"}}
    flax_bytes = serialization.msgpack_serialize(tree)
    assert msgpack.packb(tree) == flax_bytes
    ours = msgpack.unpackb(flax_bytes)["leaf"]
    theirs = serialization.msgpack_restore(msgpack.packb(tree))["leaf"]
    if kind == "bfloat16":  # a bf16 tensor: the same bits, never widened
        assert torch.is_tensor(ours) and ours.dtype == torch.bfloat16
        assert np.array_equal(ours.view(torch.int16).numpy(), value.view(np.int16))
        again = serialization.msgpack_restore(msgpack.packb({"leaf": ours}))["leaf"]
        assert again.dtype == value.dtype and np.array_equal(again.view(np.int16), value.view(np.int16))
    else:
        assert np.asarray(ours).dtype == np.asarray(value).dtype and np.array_equal(ours, value)
    assert np.asarray(theirs).dtype == np.asarray(value).dtype and np.array_equal(theirs, value)


# --------------------------------------------------------------- archives --
@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_jax_archive_restores_in_the_port(jmodel, tmp_path, use_ema):
    path = jmodel.save_to(str(tmp_path / "jax.dmn"))
    model = DDPM.restore_from(path, use_ema=use_ema, device="cpu")
    x, t = _inputs()
    ref_params = jmodel.ema_params if use_ema else jmodel.params
    assert _rel_l2(_port_out(model, model.params, x, t), _jax_out(jmodel, ref_params, x, t)) < F32_REL_L2
    assert _rel_l2(_port_out(model, model.ema_params, x, t), _jax_out(jmodel, jmodel.ema_params, x, t)) < F32_REL_L2
    other = jmodel.params if use_ema else jmodel.ema_params
    assert _rel_l2(_port_out(model, model.params, x, t), _jax_out(jmodel, other, x, t)) > 1e-2


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_port_archive_restores_in_jax(jmodel, tmp_path, use_ema):
    model = DDPM.restore_from(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    path = model.save_to(str(tmp_path / "port.dmn"))
    _cfg, _p, _e, extra = j_load_archive(path)
    assert extra == {"model_class": "DDPM"}
    back = JDDPM.restore_from(path, use_ema=use_ema)
    x, t = _inputs(1)
    ours = model.ema_params if use_ema else model.params
    assert _rel_l2(_jax_out(back, back.params, x, t), _port_out(model, ours, x, t)) < F32_REL_L2
    assert back.cfg.diffusion_model.dim == 8 and back.timesteps == T


def test_hub_publish_resolves_in_the_other_package(jmodel, tmp_path, monkeypatch):
    monkeypatch.setenv("DMN_MODEL_HUB", str(tmp_path / "hub"))
    jmodel.publish_to_hub("from_jax")
    ported = DDPM.from_pretrained("from_jax", device="cpu")
    ported.publish_to_hub("from_port")
    names = sorted(m.pretrained_model_name for m in DDPM.list_available_models())
    assert names == ["from_jax", "from_port"]
    assert sorted(m.pretrained_model_name for m in JDDPM.list_available_models()) == names
    back = JDDPM.from_pretrained("from_port")
    x, t = _inputs(2)
    assert _rel_l2(_jax_out(back, back.params, x, t), _jax_out(jmodel, jmodel.params, x, t)) < F32_REL_L2
    with pytest.raises(FileNotFoundError, match="from_jax"):
        DDPM.from_pretrained("absent", device="cpu")


def test_init_from_nemo_model_warm_starts(jmodel, tmp_path):
    path = jmodel.save_to(str(tmp_path / "warm.dmn"))
    model = DDPM(load_config(YAML, overrides=TINY).model, device="cpu", seed=5)
    x, t = _inputs(3)
    assert _rel_l2(_port_out(model, model.params, x, t), _jax_out(jmodel, jmodel.params, x, t)) > 1e-2
    model.maybe_init_from_pretrained_checkpoint({"init_from_nemo_model": path})
    assert _rel_l2(_port_out(model, model.params, x, t), _jax_out(jmodel, jmodel.params, x, t)) < F32_REL_L2
    assert _rel_l2(_port_out(model, model.ema_params, x, t), _jax_out(jmodel, jmodel.ema_params, x, t)) < F32_REL_L2


# ---------------------------------------------------------------- bits/dim --
def _jax_bpd_noise(key, shape):
    """The per-t noise of the JAX scan (t descending): split the carried key
    once per step and draw from the sub-key."""
    out = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def _quantized(seed):
    """Data where bits/dim is defined: the 8-bit grid (``uint8 / 127.5 - 1``,
    as ``preprocess_batch`` makes it), with ±1 pixels so that the decoder
    NLL's tail bins run (tests/test_bpd_golden.py)."""
    x = np.random.default_rng(seed).integers(0, 256, (B, IMG, IMG, 3)).astype(np.float32) / 127.5 - 1.0
    x[:, 0, 0, 0], x[:, 0, 1, 0] = 1.0, -1.0
    return x


@pytest.fixture(scope="module")
def bpd_pair(jmodel):
    model = DDPM(load_config(YAML, overrides=TINY).model, device="cpu")
    model._load_flax(jax.tree.map(np.asarray, jmodel.params), None)
    x = _quantized(4)
    key = jax.random.PRNGKey(11)
    ref = jmodel.calculate_bits_per_dimension(jnp.asarray(x), key=key)
    ours = model.calculate_bits_per_dimension(
        torch.from_numpy(x), noise=torch.from_numpy(_jax_bpd_noise(key, x.shape)))
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in ours.items()}


def test_bits_per_dimension_matches_jax(bpd_pair):
    ref, ours = bpd_pair
    assert ours["terms_bpd"].shape == (B, T) and ours["total_bpd"].shape == ours["prior_bpd"].shape == (B,)
    np.testing.assert_allclose(ours["total_bpd"], ref["total_bpd"], rtol=1e-4)
    np.testing.assert_allclose(ours["prior_bpd"], ref["prior_bpd"], rtol=1e-4)
    np.testing.assert_allclose(ours["terms_bpd"], ref["terms_bpd"], rtol=1e-3, atol=1e-5)


def test_bits_per_dimension_t0_term_is_the_decoder_nll(jmodel, bpd_pair):
    """Canary (tests/test_bpd_golden.py): the t = 0 term is the discretized
    decoder NLL, not the KL that every other t takes."""
    from diffusion_model_nemo_tpu_torch.loss import compute_variational_loss_terms

    _ref, ours = bpd_pair
    model = DDPM(load_config(YAML, overrides=TINY).model, device="cpu")
    model._load_flax(jax.tree.map(np.asarray, jmodel.params), None)
    x = torch.from_numpy(_quantized(4))
    noise = torch.from_numpy(_jax_bpd_noise(jax.random.PRNGKey(11), tuple(x.shape)))
    s = model.sampler
    x_t = s.q_sample(x, 0, noise[T - 1])
    true_mean, true_log_var = s.q_posterior(x_start=x, x=x_t, t=0)
    out = s.p_mean_variance(model.get_model_fn(), model.params, x=x_t, t=0)
    args = dict(samples=x, model_mean=out.mean, model_log_variance=torch.broadcast_to(out.log_variance, out.mean.shape),
                true_mean=true_mean, true_log_variance_clipped=true_log_var)
    vb0, nll0 = compute_variational_loss_terms(t=0, **args)
    kl0, _ = compute_variational_loss_terms(t=1, **args)  # the KL branch at the same inputs
    np.testing.assert_allclose(ours["terms_bpd"][:, 0], nll0.numpy(), rtol=1e-6)
    assert torch.equal(vb0, nll0)
    assert np.abs(ours["terms_bpd"][:, 0] - kl0.numpy()).min() > 1e-3


def test_bits_per_dimension_draws_from_a_generator(jmodel):
    model = DDPM(load_config(YAML, overrides=TINY).model, device="cpu")
    x = torch.from_numpy(_inputs(5)[0])
    a = model.calculate_bits_per_dimension(x, generator=torch.Generator().manual_seed(3), max_batch_size=2)
    b = model.calculate_bits_per_dimension(x, generator=torch.Generator().manual_seed(3), max_batch_size=2)
    assert a["total_bpd"].shape == (2,) and torch.equal(a["total_bpd"], b["total_bpd"])
    assert torch.isfinite(a["terms_bpd"]).all()


@pytest.mark.parametrize("fn", ["mean_flattened", "normal_kl", "approx_standard_normal_cdf",
                                "discretized_gaussian_log_likelihood", "num_to_groups"])
def test_math_matches_jax(fn):
    rng = np.random.default_rng(7)
    a, b, c, d = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(4))
    if fn == "num_to_groups":
        assert all(TM.num_to_groups(n, k) == JM.num_to_groups(n, k) for n in (0, 4, 7, 64) for k in (1, 3, 64))
        return
    if fn == "mean_flattened":
        args = (a,)
    elif fn == "normal_kl":
        args = (a, b, c, d)
    elif fn == "approx_standard_normal_cdf":
        args = (3 * a,)
    else:
        # 8-bit-grid data with both tail bins; means near the data, as a
        # denoiser's are (a mean many scales away leaves 1 - cdf to float32
        # cancellation, where XLA's and torch's tanh differ in the last bit)
        x = np.round((np.clip(a, -1, 1) + 1) * 127.5) / 127.5 - 1
        x[0, 0, 0] = [-1.0, 1.0, 0.0]
        means, log_scales = x + 0.02 * b, -3 + 0.1 * c
        ours = TM.discretized_gaussian_log_likelihood(torch.from_numpy(x), means=torch.from_numpy(means),
                                                      log_scales=torch.from_numpy(log_scales))
        ref = JM.discretized_gaussian_log_likelihood(jnp.asarray(x), means=jnp.asarray(means),
                                                     log_scales=jnp.asarray(log_scales))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        return
    ours = getattr(TM, fn)(*(torch.from_numpy(v) for v in args))
    ref = getattr(JM, fn)(*(jnp.asarray(v) for v in args))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("limit,expect", [(None, 4), (2, 2), (0.5, 2), (0.01, 1), (1.0, 4)])
def test_trainer_test_limits_batches(limit, expect):
    from diffusion_model_nemo_tpu.training.trainer import Trainer as JTrainer

    assert expect == JTrainer._resolve_limit_batches(limit, 4)
    cfg = load_config(YAML, overrides=[*TINY, "model.timesteps=3"]).model
    model = DDPM(cfg, device="cpu")
    model.setup_test_data({"name": "synthetic", "batch_size": 2, "length": 8})
    seen = []
    step = model.test_step
    model.test_step = lambda batch, i, **kw: seen.append(i) or step(batch, i, **kw)
    result = Trainer(limit_test_batches=limit).test(model)
    assert seen == list(range(expect))
    assert set(result) == {"test_total_bpd", "test_terms_bpd", "test_prior_bpd"}
    assert all(np.isfinite(v) for v in result.values())
    np.testing.assert_allclose(result["test_total_bpd"], result["test_terms_bpd"] + result["test_prior_bpd"], rtol=1e-5)
