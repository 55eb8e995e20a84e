"""The port's training options against the JAX package, on the CPU:
Min-SNR-γ, offset noise, ``pred_v`` training, zero terminal SNR and dropout.

The process pieces (``min_snr_weight``, ``v_target``,
``predict_noise_from_v``, ``rescale_zero_terminal_snr`` and the whole
constant table at T = 1000) are held to the JAX package's at 1e-6. The
whole training steps of DDPM, ImprovedDDPM, ConditionalDDPM, ScoreSDE and
WavegradDDPM, each from its shipped YAML cut to a tiny float32 U-Net (dim 8,
dim_mults [1, 2], 8 px, T = 20) with every option that family's JAX
``training_step`` reads switched on, are held to the JAX model's own
``training_step(params, batch, key, step)`` from the same weights (the
port's, carried to flax with ``utils/weights.py``). The port is fed the
draws that ``key`` yields there: the splits of each family's step (the
flip, t or the level, the noise), the offset ``normal(fold_in(k_noise, 1))``
and the dropout masks. The masks are read from the JAX step itself by
intercepting ``flax.linen.Dropout.__call__`` (mask = output ≠ 0; where the
input is 0 either mask gives 0). The DiT's forward with dropout is held to
flax's the same way.

Tolerances: 1e-6 for the process pieces (relative, finite entries; the
``inf``/``nan`` of a zero-terminal-SNR table at the same positions); float32
loss 1e-5 relative, the whole gradient 2e-4 relative L2
(tests/test_torch_export.py:78), the DiT's output 2e-4 relative L2.
"""

from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import DDPM as JDDPM
from diffusion_model_nemo_tpu.models import ConditionalDDPM as JConditional
from diffusion_model_nemo_tpu.models import ImprovedDDPM as JImproved
from diffusion_model_nemo_tpu.models import ScoreSDE as JScoreSDE
from diffusion_model_nemo_tpu.models import WavegradDDPM as JWavegrad
from diffusion_model_nemo_tpu.modules.dit import DiT as JDiT
from diffusion_model_nemo_tpu.modules.gaussian_diffusion import GaussianDiffusion as JGaussian
from diffusion_model_nemo_tpu.ops import schedules as JS
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import DDPM, ConditionalDDPM, ImprovedDDPM, ScoreSDE, WavegradDDPM
from diffusion_model_nemo_tpu_torch.modules import GaussianDiffusion
from diffusion_model_nemo_tpu_torch.modules.dit import DiT
from diffusion_model_nemo_tpu_torch.ops import schedules as TS
from diffusion_model_nemo_tpu_torch.training.trainer import param_grads
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
T, IMG, B = 20, 8, 4
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.diffusion_model.dropout=0.1",
]
# The options each family's JAX training_step reads.
DDPM_OPTIONS = ["+model.snr_gamma=5.0", "+model.offset_noise_strength=0.1", "+model.sampler.objective=pred_v"]
OP_TOL = 1e-6
LOSS_TOL = 1e-5
WHOLE_TOL = 2e-4  # tests/test_torch_export.py:78


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------- the process --
def _pair(objective, **kw):
    args = dict(timesteps=T, schedule_name="cosine", objective=objective, **kw)
    return JGaussian(**args), GaussianDiffusion(**args, device="cpu")


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_min_snr_weight_matches_jax(objective):
    """The objective-aware weight at every t, γ = 5 (and γ = 0.5, below
    most SNRs)."""
    jproc, proc = _pair(objective)
    t = np.arange(T, dtype=np.int32)
    for gamma in (5.0, 0.5):
        ours = proc.min_snr_weight(torch.from_numpy(t), gamma).numpy()
        ref = np.asarray(jproc.min_snr_weight(jnp.asarray(t), gamma))
        np.testing.assert_allclose(ours, ref, rtol=OP_TOL, atol=0)
        if objective == "pred_noise":
            assert ours.max() <= 1.0 + OP_TOL  # min(SNR, γ) / SNR


def test_v_target_and_predict_noise_from_v_match_jax():
    jproc, proc = _pair("pred_v")
    rng = np.random.default_rng(0)
    x0, noise, v = (rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32) for _ in range(3))
    t = np.asarray([0, 5, 13, T - 1], np.int32)
    tt = (torch.from_numpy(t),)
    ours = proc.v_target(torch.from_numpy(x0), *tt, torch.from_numpy(noise))
    ref = jproc.v_target(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=OP_TOL, atol=OP_TOL)
    x_t = proc.q_sample(torch.from_numpy(x0), *tt, torch.from_numpy(noise))
    eps = proc.predict_noise_from_v(x_t, *tt, torch.from_numpy(v))
    ref = jproc.predict_noise_from_v(jnp.asarray(x_t.numpy()), jnp.asarray(t), jnp.asarray(v))
    np.testing.assert_allclose(eps.numpy(), np.asarray(ref), rtol=OP_TOL, atol=OP_TOL)
    # v of the true (x0, ε) gives back ε and x0
    back = proc.predict_noise_from_v(x_t, *tt, ours)
    np.testing.assert_allclose(back.numpy(), noise, rtol=0, atol=1e-5)
    np.testing.assert_allclose(proc.predict_start_from_v(x_t, *tt, ours).numpy(), x0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_zero_terminal_snr_table_matches_jax(schedule):
    """The rescaled betas (float64) and every table of the process at T =
    1000: finite entries within 1e-6 relative, inf and nan at the same
    positions; ᾱ_T is exactly 0."""
    betas = JS.get_named_beta_schedule(schedule, 1000)
    ours_b, ref_b = TS.rescale_zero_terminal_snr(betas), JS.rescale_zero_terminal_snr(betas)
    assert ours_b.dtype == np.float64
    np.testing.assert_allclose(ours_b, ref_b, rtol=1e-12, atol=0)
    jproc = JGaussian(1000, schedule, objective="pred_v", zero_terminal_snr=True)
    proc = GaussianDiffusion(1000, schedule, objective="pred_v", zero_terminal_snr=True, device="cpu")
    assert float(proc.constants.alphas_cumprod[-1]) == 0.0
    infs = 0
    for name in proc.constants.__dataclass_fields__:
        ours = getattr(proc.constants, name).numpy()
        ref = np.asarray(getattr(jproc.constants, name))
        assert ours.shape == ref.shape and ours.dtype == np.float32, name
        np.testing.assert_array_equal(np.isinf(ours), np.isinf(ref), err_msg=name)
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref), err_msg=name)
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(ours[~fin & ~np.isnan(ref)], ref[~fin & ~np.isnan(ref)], err_msg=name)
        np.testing.assert_allclose(ours[fin], ref[fin], rtol=1e-6, atol=0, err_msg=name)
        infs += int(np.isinf(ref).sum())
    assert infs >= 3  # the 1/ᾱ tables at T


def test_zero_terminal_snr_refuses_pred_noise_as_jax():
    with pytest.raises(ValueError, match="zero_terminal_snr requires objective"):
        JGaussian(T, "cosine", zero_terminal_snr=True)
    with pytest.raises(ValueError, match="zero_terminal_snr requires objective"):
        GaussianDiffusion(T, "cosine", zero_terminal_snr=True, device="cpu")
    GaussianDiffusion(T, "cosine", objective="pred_x0", zero_terminal_snr=True, device="cpu")


# ------------------------------------------------------ the training steps --
def _site(path) -> str:
    """A flax Dropout module's path as the port's site key: a ResNet
    block's ``<block>/block2`` (its one Dropout), a DiT block's
    ``block_<i>/Dropout_<j>``."""
    key = "/".join(path)
    return key[: -len("/Dropout_0")] if key.endswith("/block2/Dropout_0") else key


def _with_masks(fn):
    """``fn(*args)`` with the output of every flax Dropout recorded: (fn's
    output, {site: output ≠ 0})."""

    def run(*args):
        records = {}

        def intercept(next_fun, args_, kwargs, context):
            out = next_fun(*args_, **kwargs)
            if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
                records[_site(context.module.path)] = out != 0
            return out

        with nn.intercept_methods(intercept):
            out = fn(*args)
        return out, records

    return run


def _ddpm_draws(key, shape, split):
    """The DDPM family's draws from its step's key (JAX arrays): ``split``
    names the four keys as the family's ``training_step`` splits them."""
    keys = dict(zip(split, jax.random.split(key, 4)))
    out = {
        "flip": jax.random.bernoulli(keys["pre"], 0.5, (shape[0],)),
        "t": jax.random.randint(keys["t"], (shape[0],), 0, T, dtype=jnp.int32),
        "noise": jax.random.normal(keys["noise"], shape, jnp.float32),
        "offset": jax.random.normal(jax.random.fold_in(keys["noise"], 1), (shape[0], 1, 1, shape[-1]), jnp.float32),
    }
    if "mask" in keys:  # ConditionalDDPM: get_model_fn splits k_mask into the label mask's and dropout's
        k_bern, _k_drop = jax.random.split(keys["mask"])
        out["label_mask"] = jax.random.bernoulli(k_bern, 0.5, (shape[0],))
    return out


def _score_draws(key, shape):
    k_pre, k_t, k_noise, _k_drop = jax.random.split(key, 4)
    return {"flip": jax.random.bernoulli(k_pre, 0.5, (shape[0],)),
            "t": jax.random.uniform(k_t, (shape[0],), dtype=jnp.float32),
            "noise": jax.random.normal(k_noise, shape, jnp.float32)}


def _wavegrad_draws(key, shape):
    k_pre, k_level, k_noise, _k_drop = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_level)
    return {"flip": jax.random.bernoulli(k_pre, 0.5, (shape[0],)),
            "s": jax.random.randint(k1, (shape[0],), 1, T + 1),
            "u": jax.random.uniform(k2, (shape[0],), dtype=jnp.float32),
            "noise": jax.random.normal(k_noise, shape, jnp.float32)}


DDPM_SPLIT = ("pre", "t", "noise", "drop")
FAMILIES = {
    # name: (YAML, extra overrides, JAX class, port class, draws from (key, shape))
    "ddpm": ("ddpm/unet_small.yaml", [*DDPM_OPTIONS, "+model.sampler.zero_terminal_snr=true"], JDDPM, DDPM,
             lambda k, s: _ddpm_draws(k, s, DDPM_SPLIT)),
    "improved": ("improved_ddpm/unet_small.yaml", DDPM_OPTIONS, JImproved, ImprovedDDPM,
                 lambda k, s: _ddpm_draws(k, s, DDPM_SPLIT)),
    "conditional": ("conditional_ddpm/unet_small.yaml", [*DDPM_OPTIONS, "model.num_classes=10"], JConditional,
                    ConditionalDDPM, lambda k, s: _ddpm_draws(k, s, ("pre", "mask", "t", "noise"))),
    # The JAX ScoreSDE and WaveGrad steps read dropout only (no offset
    # noise, no Min-SNR-γ): the options set here change nothing there.
    "score_sde": ("score_sde/vp/unet_small.yaml", ["+model.snr_gamma=5.0", "+model.offset_noise_strength=0.1"],
                  JScoreSDE, ScoreSDE, _score_draws),
    "wavegrad": ("wavegrad_ddpm/unet_small.yaml", ["+model.snr_gamma=5.0", "+model.offset_noise_strength=0.1"],
                 JWavegrad, WavegradDDPM, _wavegrad_draws),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_training_step_with_every_option_matches_jax(family):
    """The port's step, fed the draws of the JAX step's key and the masks
    of its dropout sites, against ``training_step`` of the JAX model: the
    loss and the whole gradient. Every site has a mask of the shape the
    port draws (``draw_training_inputs``), and both mask values occur."""
    yaml, extra, jcls, cls, draws_of = FAMILIES[family]
    overrides = [*TINY, *extra]
    model = cls(load_config(REPO / "examples/configs" / yaml, overrides=overrides).model, device="cpu", seed=0)
    jmodel = jcls(cfg=j_load_config(REPO / "examples/configs" / yaml, overrides=overrides).model)
    jparams = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    rng = np.random.default_rng(3)
    batch = {"image": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, B).astype(np.int32)}
    key = jax.random.PRNGKey(11)
    b = jax.tree.map(jnp.asarray, batch)
    shape = (B, IMG, IMG, 3)

    def step(p):
        (loss, metrics), masks = _with_masks(lambda q: jmodel.training_step(q, b, key, 0))(p)
        return loss, (metrics, masks, draws_of(key, shape))

    # The draws are traced into the same program; XLA's backend optimization
    # level 0 compiles the program in half the time (the loss moves ~1e-8).
    lowered = jax.jit(jax.value_and_grad(step, has_aux=True)).lower(jparams)
    (jloss, (_metrics, masks, jdraws)), jgrads = lowered.compile(
        compiler_options={"xla_backend_optimization_level": 0})(jparams)

    drawn = model.draw_training_inputs(shape, torch.Generator().manual_seed(0))
    sites = {k[len("dropout/"):]: v.shape for k, v in drawn.items() if k.startswith("dropout/")}
    assert sites == {k: tuple(v.shape) for k, v in masks.items()} and len(sites) == 9
    assert {k for k in drawn if not k.startswith("dropout/")} == set(jdraws)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in jdraws.items()}
    draws.update({f"dropout/{k}": torch.from_numpy(np.array(v)) for k, v in masks.items()})
    kept = np.mean([float(np.mean(np.array(v))) for v in masks.values()])
    assert 0.8 < kept < 0.98, kept

    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, metrics = model.training_step(params, batch, draws)
    grads = param_grads(loss, params, getattr(model.diffusion_model, "unused_params", frozenset()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_TOL)
    ours = to_flax_params({k: g.detach() for k, g in grads.items()}, model.diffusion_model)
    flat = lambda tree: np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])  # noqa: E731
    assert _rel_l2(flat(ours), flat(jax.tree.map(np.asarray, jgrads))) < WHOLE_TOL
    # the masks reach the network: all-kept masks give another loss
    no_drop = {k: (torch.ones_like(v) if k.startswith("dropout/") else v) for k, v in draws.items()}
    assert abs(float(model.training_step(model.params, batch, no_drop)[0]) - float(loss)) > 1e-6


def test_dit_forward_with_dropout_matches_flax():
    """A 2-block DiT (dim 32, 4 heads, patch 2, 8 px) with dropout 0.2:
    flax's training forward (``deterministic=False``) and the port's with
    the masks flax drew; without masks the port's forward is flax's
    deterministic one."""
    kw = dict(dim=32, depth=2, heads=4, patch_size=2, channels=3, dropout=0.2)
    jnet = JDiT(**kw)
    net = DiT(**kw)
    net.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in net.parameters():  # adaLN-Zero: redraw the zero leaves, or the output is 0
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    params = jax.tree.map(jnp.asarray, to_flax_params(net.state_dict(), net))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    t = np.asarray([1, 5, 9, 19], np.int32)
    fwd = _with_masks(lambda p, x, t: jnet.apply({"params": p}, x, t, deterministic=False,
                                                 rngs={"dropout": jax.random.PRNGKey(2)}))
    ref, masks = jax.jit(fwd)(params, jnp.asarray(x), jnp.asarray(t))
    assert sorted(masks) == sorted(net.dropout_shapes(x.shape)) == [f"block_{i}/Dropout_{j}" for i in (0, 1)
                                                                     for j in (0, 1)]
    ours = net(torch.from_numpy(x), torch.from_numpy(t),
               dropout_masks={k: torch.from_numpy(np.array(v)) for k, v in masks.items()})
    assert _rel_l2(ours.detach().numpy(), ref) < WHOLE_TOL
    plain = net(torch.from_numpy(x), torch.from_numpy(t))
    ref_plain = jax.jit(lambda p, x, t: jnet.apply({"params": p}, x, t))(params, jnp.asarray(x), jnp.asarray(t))
    assert _rel_l2(plain.detach().numpy(), ref_plain) < WHOLE_TOL
    assert _rel_l2(plain.detach().numpy(), ours.detach().numpy()) > 1e-3
