"""The port's ImprovedDDPM (learned variance, hybrid loss) against the JAX
package, on the CPU.

The models are examples/configs/improved_ddpm/unet_small.yaml cut to a tiny
float32 U-Net (dim 8, dim_mults [1, 2], 8 px, T = 20); the port's weights are
the JAX ``init_params`` carried over with ``utils/weights.py``. Inputs are
made with numpy from a seed; the training step's draws (flip, t, noise) are
re-derived from the JAX step's key as ``ImprovedDDPM.training_step`` splits
it, and bits/dim's per-t noise as its scan splits its key.

Tolerances: 1e-5 for each process op on float32 inputs; 2e-4 for a whole
U-Net, step or bits/dim result (relative; tests/test_torch_export.py:78);
the whole float32 gradient of the hybrid loss 2e-4 relative L2.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import instantiate
from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.data import hf_vision_data as JD
from diffusion_model_nemo_tpu.models import ImprovedDDPM as JImproved
from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore
from diffusion_model_nemo_tpu.modules.learned_gaussian_diffusion import LearnedGaussianDiffusion as JLearned
from diffusion_model_nemo_tpu.training.checkpoints import load_archive as j_load_archive
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import ImprovedDDPM, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules import LearnedGaussianDiffusion
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/improved_ddpm/unet_small.yaml"
T, IMG, B = 20, 8, 3
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic",
]
OP_TOL = 1e-5
WHOLE_TOL = 2e-4  # tests/test_torch_export.py:78


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is as fast
    alone, and does not oversubscribe the cores that the suite's other
    workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_init(jmodel, key, **kwargs):
    """``init_params`` under one jit (the eager init compiles op by op)."""
    x, t = jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,), jnp.float32)
    jmodel.params = jax.jit(jmodel.diffusion_model.init)(key, x, t, **kwargs)["params"]
    jmodel.ema_params = jax.tree.map(jnp.copy, jmodel.params)


@pytest.fixture(scope="module")
def pair():
    """The JAX ImprovedDDPM and the port's, with the same (carried) weights."""
    jmodel = JImproved(cfg=j_load_config(YAML, overrides=TINY).model)
    jax_init(jmodel, jax.random.PRNGKey(0))
    model = ImprovedDDPM(load_config(YAML, overrides=TINY).model, device="cpu")
    model._load_flax(jax.tree.map(np.asarray, jmodel.params), None)
    return jmodel, model


def _samplers(objective="pred_noise"):
    kw = dict(timesteps=T, schedule_name="cosine", objective=objective)
    return JLearned(**kw), LearnedGaussianDiffusion(**kw, device="cpu")


def _process_inputs(seed=0):
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((B, IMG, IMG, 6)).astype(np.float32)
    out[..., 3:] = np.tanh(out[..., 3:])  # the v half in [-1, 1], as a trained network's
    x = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    t = np.asarray([0, 7, T - 1], np.int32)
    return out, x, t


# ------------------------------------------------------------- the process --
def test_model_log_variance_matches_jax():
    jproc, proc = _samplers()
    out, x, t = _process_inputs()
    ours = proc.model_log_variance(torch.from_numpy(out), torch.from_numpy(x), torch.from_numpy(t))
    ref = jproc.model_log_variance(jnp.asarray(out), jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=OP_TOL, atol=OP_TOL)
    # v = -1 is the clipped posterior variance, v = +1 is beta_t
    ends = proc.model_log_variance(torch.cat([torch.zeros(B, 1, 1, 3), -torch.ones(B, 1, 1, 3)], -1),
                                   torch.zeros(B, 1, 1, 3), torch.from_numpy(t))
    c = proc.constants
    np.testing.assert_allclose(ends[:, 0, 0, 0].numpy(), c.posterior_log_variance_clipped[t].numpy(), rtol=1e-6)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_v"])
def test_p_mean_variance_matches_jax(objective):
    jproc, proc = _samplers(objective)
    out, x, t = _process_inputs(1)
    ours = proc.p_mean_variance(None, None, torch.from_numpy(x), torch.from_numpy(t), model_output=torch.from_numpy(out))
    ref = jproc.p_mean_variance(None, None, jnp.asarray(x), jnp.asarray(t), model_output=jnp.asarray(out))
    for name in ("mean", "variance", "log_variance", "pred_x_start"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=OP_TOL, atol=OP_TOL, err_msg=name)


def test_one_ancestral_step_matches_jax(pair):
    """One learned-variance ancestral step of the network at t = 7 with
    injected noise: μ_θ + exp(½ log σ²_θ)·noise, the noise drawn from the
    key the JAX step draws it from."""
    jmodel, model = pair
    _, x, _ = _process_inputs(2)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    ref = jax.jit(lambda p, x: jmodel.sampler.p_sample(jmodel.model_fn, p, x, jnp.int32(7), key))(
        jmodel.params, jnp.asarray(x))
    ours = model.sampler.p_sample(model.get_model_fn(), model.params, torch.from_numpy(x), 7,
                                  noise=torch.from_numpy(noise))
    assert _rel_l2(ours.numpy(), ref) < WHOLE_TOL


def test_bf16_network_output_and_variance_are_float32():
    cfg = load_config(YAML, overrides=[*TINY, "model.diffusion_model.dtype=bfloat16"]).model
    model = ImprovedDDPM(cfg, device="cpu")
    x = torch.randn(2, IMG, IMG, 3)
    t = torch.tensor([3, 11], dtype=torch.int32)
    out = model.model_fn(model.params, x, t)
    pmv = model.sampler.p_mean_variance(None, None, x, t, model_output=out)
    assert out.dtype == pmv.log_variance.dtype == pmv.variance.dtype == torch.float32 and out.shape[-1] == 6


# --------------------------------------------------------- the training step --
def _step_inputs(seed=0, batch=4):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, IMG, IMG, 3), dtype=np.uint8)
    return {"image": images, "label": rng.integers(0, 10, batch).astype(np.int32)}


def _jax_draws(key, batch):
    """ImprovedDDPM.training_step's draws from its key (k_pre, k_t, k_noise)."""
    k_pre, k_t, k_noise, _k_drop = jax.random.split(key, 4)
    return {
        "flip": torch.from_numpy(np.asarray(jax.random.bernoulli(k_pre, 0.5, (batch,)))),
        "t": torch.from_numpy(np.asarray(jax.random.randint(k_t, (batch,), 0, T, dtype=jnp.int32))),
        "noise": torch.from_numpy(np.asarray(jax.random.normal(k_noise, (batch, IMG, IMG, 3), jnp.float32))),
    }


def _port_step(model, batch, draws, detach=True):
    """The port's metrics, and the gradients of the total and of the VLB
    term alone (``detach``: ``vb_loss.detach_model_mean``)."""
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    model.vb_loss.detach_model_mean = detach
    try:
        loss, metrics = model.training_step(params, batch, draws)
        grads = torch.autograd.grad(loss, list(params.values()), retain_graph=True)
        vb = torch.autograd.grad(metrics["vb_losses"], list(params.values()), allow_unused=True)
    finally:
        model.vb_loss.detach_model_mean = True
    vb = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), vb)]
    return ({k: float(v) for k, v in metrics.items()}, dict(zip(params, grads)), dict(zip(params, vb)))


def _key_with(batch, want):
    """The first step key whose t draws hold every t of ``want``."""
    for i in range(1000):
        key = jax.random.PRNGKey(i)
        k_t = jax.random.split(key, 4)[1]
        t = np.asarray(jax.random.randint(k_t, (batch,), 0, T, dtype=jnp.int32))
        if set(want) <= set(t.tolist()):
            return key
    raise AssertionError(f"no key draws {want}")


def _jax_step(jmodel, batch, key):
    """The JAX step under one jit: metrics, jax.grad of the total and of
    the VLB term alone (one forward, two cotangents)."""
    b = jax.tree.map(jnp.asarray, batch)

    @jax.jit
    def run(p):
        (loss, metrics), vjp = jax.vjp(lambda q: jmodel.training_step(q, b, key, 0), p)
        zero = jax.tree.map(jnp.zeros_like, metrics)
        total = vjp((jnp.ones_like(loss), zero))[0]
        vb = vjp((jnp.zeros_like(loss), dict(zero, vb_losses=jnp.ones_like(loss))))[0]
        return metrics, total, vb

    return run(jmodel.params)


@pytest.fixture(scope="module")
def steps(pair):
    """The JAX step and the port's on the same batch and the draws the
    step's key gives; the key is the first whose t hold 0 (the decoder NLL)
    and T - 1."""
    jmodel, model = pair
    batch = _step_inputs(batch=8)
    key = _key_with(8, (0, T - 1))
    jmetrics, jgrads, jvb = _jax_step(jmodel, batch, key)
    draws = _jax_draws(key, 8)
    return {"jax": (jmetrics, jgrads, jvb), "port": _port_step(model, batch, draws), "inputs": (batch, draws)}


def _flat(model, grads):
    if not isinstance(grads, dict) or not all(torch.is_tensor(v) for v in grads.values()):
        grads = from_flax_params(jax.tree.map(np.asarray, grads), model.diffusion_model)
    return np.concatenate([grads[k].detach().numpy().ravel() for k in sorted(grads)])


def test_training_step_metrics_match_jax(steps):
    """train_loss, simple_loss and vb_losses at 2e-4. decoder_nll (a metric,
    in the loss only where t = 0) is the batch mean of the discretized
    Gaussian NLL at every sample's own t; at t > 0 its float32 value sits up
    to 2.5% from float64 in both packages (the cdf differences of bins far
    in the tails cancel), so the mixed-t step holds it to 3e-2 and the
    all-t = 0 step below to 2e-4."""
    jmetrics, _, _ = steps["jax"]
    metrics = steps["port"][0]
    assert set(metrics) == set(jmetrics) == {"train_loss", "simple_loss", "vb_losses", "decoder_nll"}
    for k in ("train_loss", "simple_loss", "vb_losses"):
        np.testing.assert_allclose(metrics[k], float(jmetrics[k]), rtol=WHOLE_TOL, err_msg=k)
    np.testing.assert_allclose(metrics["decoder_nll"], float(jmetrics["decoder_nll"]), rtol=3e-2)
    assert metrics["vb_losses"] > 0 and metrics["decoder_nll"] > 0


def test_training_step_at_t0_matches_jax(pair):
    """Every sample at t = 0: the VLB term is the decoder NLL, all four
    metrics at 2e-4."""
    jmodel, model = pair
    batch = _step_inputs(1, batch=8)
    key = jax.random.PRNGKey(0)
    draws = _jax_draws(key, 8)
    draws["t"] = torch.zeros(8, dtype=torch.int32)
    b = jax.tree.map(jnp.asarray, batch)
    x0 = JD.preprocess_batch(b, jax.random.split(key, 4)[0], train=True)["pixel_values"]
    noise = jnp.asarray(draws["noise"].numpy())
    t0 = jnp.zeros((8,), jnp.int32)

    @jax.jit
    def j_metrics(p):  # training_step's arithmetic with t = 0
        x_t = jmodel.sampler.q_sample(x0, t0, noise)
        out = jmodel.model_fn(p, x_t, t0)
        simple = jmodel.loss(input=jnp.split(out, 2, axis=-1)[0], target=noise)
        mean, logv = jmodel.sampler.q_posterior(x_start=x0, x=x_t, t=t0)
        pmv = jmodel.sampler.p_mean_variance(None, p, x=x_t, t=t0, model_output=out)
        vb, nll = jmodel.vb_loss(samples=x0, model_mean=pmv.mean, model_log_variance=pmv.log_variance,
                                 true_mean=mean, true_log_variance_clipped=logv, t=t0)
        return {"train_loss": simple + vb, "simple_loss": simple, "vb_losses": vb, "decoder_nll": nll}

    ref = j_metrics(jmodel.params)
    _, metrics = model.training_step(model.params, batch, draws)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(ref[k]), rtol=WHOLE_TOL, err_msg=k)
    np.testing.assert_allclose(float(metrics["vb_losses"]), 1e-3 * float(metrics["decoder_nll"]), rtol=1e-6)


def test_training_step_gradient_matches_jax_and_pins_detach(pair, steps):
    """The whole float32 gradient of simple + vb, and that of the VLB term
    alone, against jax.vjp; the VLB gradient reaches the network through
    the variance half only (``detach_model_mean``): with the detach off the
    port's VLB gradient leaves the tolerance by far."""
    _, model = pair
    _, jgrads, jvb = steps["jax"]
    _, grads, vb = steps["port"]
    assert _rel_l2(_flat(model, grads), _flat(model, jgrads)) < WHOLE_TOL
    assert _rel_l2(_flat(model, vb), _flat(model, jvb)) < WHOLE_TOL
    batch, draws = steps["inputs"]
    _, _, attached = _port_step(model, batch, draws, detach=False)
    assert _rel_l2(_flat(model, attached), _flat(model, jvb)) > 100 * WHOLE_TOL


# ---------------------------------------------------------------- bits/dim --
def _jax_bpd_noise(key, shape):
    """The JAX scan's per-t noise (t descending): one split a step."""
    out = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def test_bits_per_dimension_reads_the_learned_variance_like_jax(pair):
    jmodel, model = pair
    x = np.random.default_rng(4).integers(0, 256, (B, IMG, IMG, 3)).astype(np.float32) / 127.5 - 1.0
    key = jax.random.PRNGKey(11)
    ref = jmodel.calculate_bits_per_dimension(jnp.asarray(x), key=key)
    noise = torch.from_numpy(_jax_bpd_noise(key, x.shape))
    ours = model.calculate_bits_per_dimension(torch.from_numpy(x), noise=noise)
    for k in ("total_bpd", "prior_bpd"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=WHOLE_TOL, err_msg=k)
    np.testing.assert_allclose(ours["terms_bpd"].numpy(), np.asarray(ref["terms_bpd"]), rtol=1e-3, atol=1e-5)
    replayed = model.calculate_bits_per_dimension(torch.from_numpy(x), noise=noise, graphs=True)
    assert torch.equal(replayed["terms_bpd"], ours["terms_bpd"])


# ---------------------------------------------------------------- archives --
def _inputs(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32), np.asarray([0, 7, T - 1], np.int32)


def test_archives_restore_both_ways(pair, tmp_path):
    jmodel, model = pair
    x, t = _inputs(6)
    restored = restore_model_from_archive(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    assert type(restored) is ImprovedDDPM and isinstance(restored.sampler, LearnedGaussianDiffusion)
    ours = restored.model_fn(restored.params, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert ours.shape[-1] == 6
    apply = jax.jit(jmodel.model_fn)  # one network: any model's params
    assert _rel_l2(ours, apply(jmodel.params, jnp.asarray(x), jnp.asarray(t))) < WHOLE_TOL
    path = model.save_to(str(tmp_path / "port.dmn"))
    assert j_load_archive(path)[3] == {"model_class": "ImprovedDDPM"}
    back = j_restore(path)
    assert type(back).__name__ == "ImprovedDDPM"
    ref = model.model_fn(model.params, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert _rel_l2(apply(back.params, jnp.asarray(x), jnp.asarray(t)), ref) < WHOLE_TOL


# ------------------------------------------------- DDIM on a learned variance --
def test_ddim_refuses_a_learned_variance_output_as_jax_fails(pair):
    """The JAX DDIM step reshapes the [B, H, W, 2C] output to x's shape and
    fails (TypeError); the port raises a ValueError that names the cause."""
    jmodel, model = pair
    ddim = dict(model.cfg.sampler, _target_="diffusion_model_nemo.modules.GeneralizedGaussianDiffusion",
                eta=0.0, ddim_timesteps=5)
    jsampler = instantiate(ddim)
    with pytest.raises(TypeError, match="reshape"):
        jsampler.p_sample_loop(jmodel.model_fn, jmodel.params, (2, IMG, IMG, 3), jax.random.PRNGKey(0))
    ours = ImprovedDDPM(load_config(YAML, overrides=TINY).model, device="cpu")
    ours.change_sampler(ddim)
    with pytest.raises(ValueError, match="learned-variance"):
        ours.sample(2, IMG, generator=torch.Generator().manual_seed(0))
