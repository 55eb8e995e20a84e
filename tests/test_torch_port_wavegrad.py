"""The port's WavegradDDPM (FiLM U-Net, continuous noise level, searched
short schedule) against the JAX package, on the CPU.

The models are examples/configs/wavegrad_ddpm/unet_small.yaml cut to a tiny
float32 U-Net (dim 8, dim_mults [1, 2], 8 px, T = 20); the port's weights
are the JAX ``init_params`` carried over with ``utils/weights.py``. Inputs
are made with numpy from a seed; the training step's draws (flip, the
level's s and u, the noise) are re-derived from the JAX step's key as
``WavegradDDPM.training_step`` splits it; a chain's and bits/dim's noise as
their scans split their keys (the port's eager chain takes them through
its one draw function).

Tolerances: 1e-6 for the level and the process ops on float32 inputs
(the same float32 arithmetic); 2e-4 relative for a whole U-Net, a step's
loss or bits/dim (tests/test_torch_export.py:78) and the whole float32
gradient; 1e-3 for a 20-step chain (twenty network calls at the 2e-4
forward tolerance); the searched ``beta_end`` exactly equal.
"""

import copy
import gc
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import WavegradDDPM as JWavegrad
from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore
from diffusion_model_nemo_tpu.modules.parts import FeatureWiseLinearModulation as JFiLM
from diffusion_model_nemo_tpu.modules.parts import PositionalEncoding as JPE
from diffusion_model_nemo_tpu.modules.wavegrad_diffusion import WaveGradDiffusion as JWaveGradDiffusion
from diffusion_model_nemo_tpu.training.checkpoints import load_archive as j_load_archive
from diffusion_model_nemo_tpu_torch.cli import eval_wavegrad_ddpm, test_wavegrad_ddpm, train_wavegrad_ddpm
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import WavegradDDPM, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules import WaveGradDiffusion, WaveGradUNet
from diffusion_model_nemo_tpu_torch.modules import gaussian_diffusion as TG
from diffusion_model_nemo_tpu_torch.modules.parts import FeatureWiseLinearModulation, PositionalEncoding
from diffusion_model_nemo_tpu_torch.serving import serve
from diffusion_model_nemo_tpu_torch.training.trainer import param_grads
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/wavegrad_ddpm/unet_small.yaml"
T, IMG, B = 20, 8, 3
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic",
]
OP_TOL = 1e-6
WHOLE_TOL = 2e-4  # tests/test_torch_export.py:78
CHAIN_TOL = 1e-3
SCHEDULE_CFG = load_config(YAML).model.sampler.schedule_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_model(overrides=()):
    jmodel = JWavegrad(cfg=j_load_config(YAML, overrides=[*TINY, *overrides]).model)
    x, level = jnp.zeros((1, IMG, IMG, 3)), jnp.full((1, 1, 1, 1), 0.5, jnp.float32)
    jmodel.params = jax.jit(jmodel.diffusion_model.init)(jax.random.PRNGKey(0), x, level)["params"]
    jmodel.ema_params = jax.tree.map(jnp.copy, jmodel.params)
    return jmodel


def _port_model(jmodel, overrides=()):
    model = WavegradDDPM(load_config(YAML, overrides=[*TINY, *overrides]).model, device="cpu")
    model._load_flax(jax.tree.map(np.asarray, jmodel.params), None)
    return model


@pytest.fixture(scope="module")
def pair():
    """The JAX WavegradDDPM and the port's, with the same (carried) weights."""
    jmodel = _jax_model()
    return jmodel, _port_model(jmodel)


def _levels(seed=0, n=B):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, 1, 1, 1)).astype(np.float32)


# ----------------------------------------------------------------- modules --
def test_positional_encoding_and_film_match_jax():
    """The level's encoding at levels in [0, 1] (angles up to 5000 rad) and
    a FiLM's (scale, shift) with the same weights."""
    level = _levels(1, 5)
    for c in (8, 32, 64):
        ref = JPE(c).apply({}, jnp.asarray(level))
        ours = PositionalEncoding(c)(torch.from_numpy(level))
        assert ours.shape == (5, 1, 1, c)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    x = np.random.default_rng(2).standard_normal((5, 8, 8, 16)).astype(np.float32)
    jfilm = JFiLM(24)
    variables = jfilm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(level))
    ref = jfilm.apply(variables, jnp.asarray(x), jnp.asarray(level))
    film = FeatureWiseLinearModulation(16, 24)
    film.load_state_dict(from_flax_params(jax.tree.map(np.asarray, variables["params"]), film))
    ours = film(torch.from_numpy(x), torch.from_numpy(level))
    for a, b in zip(ours, ref):
        assert _rel_l2(a.detach().numpy(), b) < WHOLE_TOL


def test_unet_forward_with_classes_matches_jax():
    """With ``num_classes``: a label per sample and the null class."""
    extra = ["model.num_classes=10"]
    jmodel = _jax_model(extra)
    model = _port_model(jmodel, extra)
    x = np.random.default_rng(4).standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    level, classes = _levels(4), np.asarray([0, 10, 7], np.int32)
    ref = jax.jit(lambda p, x, lv, c: jmodel.diffusion_model.apply({"params": p}, x, lv, c))(
        jmodel.params, jnp.asarray(x), jnp.asarray(level), jnp.asarray(classes))
    ours = model.model_fn(model.params, torch.from_numpy(x), torch.from_numpy(level), torch.from_numpy(classes))
    assert _rel_l2(ours.numpy(), ref) < WHOLE_TOL


def test_unet_forward_matches_jax(pair):
    """The float32 WaveGradUNet at continuous levels, same weights."""
    jmodel, model = pair
    assert isinstance(model.diffusion_model, WaveGradUNet)
    x = np.random.default_rng(5).standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    level = _levels(5)
    ref = jax.jit(jmodel.model_fn)(jmodel.params, jnp.asarray(x), jnp.asarray(level))
    ours = model.model_fn(model.params, torch.from_numpy(x), torch.from_numpy(level))
    assert ours.dtype == torch.float32 and _rel_l2(ours.numpy(), ref) < WHOLE_TOL
    # the deepest FiLM exists (its parameters load) and never reaches the output
    deepest = max(int(k.split("_")[1].split(".")[0]) for k in model.params if k.startswith("film_"))
    params = {k: (v + 1.0 if k.startswith(f"film_{deepest}.") else v) for k, v in model.params.items()}
    assert torch.equal(model.model_fn(params, torch.from_numpy(x), torch.from_numpy(level)), ours)


# ----------------------------------------------------------------- process --
def _samplers(schedule="linear", timesteps=T):
    """Each with its own copy of the config's schedule dicts (a search
    writes into them)."""
    kw = dict(timesteps=timesteps, schedule_name=schedule)
    return (JWaveGradDiffusion(**kw, schedule_cfg=copy.deepcopy(dict(SCHEDULE_CFG))),
            WaveGradDiffusion(**kw, schedule_cfg=copy.deepcopy(dict(SCHEDULE_CFG)), device="cpu"))


def test_continuous_level_and_q_sample_match_jax():
    """The level from the draws the JAX function makes from its key, then
    the continuous forward process and the integer/float dispatch."""
    jproc, proc = _samplers()
    key = jax.random.PRNGKey(7)
    ref = jproc.sample_continuous_noise_level(B, key)
    k1, k2 = jax.random.split(key)
    s = np.asarray(jax.random.randint(k1, (B,), 1, T + 1))
    u = np.asarray(jax.random.uniform(k2, (B,), dtype=jnp.float32))
    level = proc.sample_continuous_noise_level(torch.from_numpy(s), torch.from_numpy(u))
    np.testing.assert_allclose(level.numpy(), np.asarray(ref), rtol=OP_TOL, atol=OP_TOL)
    rng = np.random.default_rng(8)
    x0, noise = (rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    for t in (np.asarray(level), np.asarray([0, 9, T - 1], np.int32)):
        ours = proc.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))
        theirs = jproc.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [[0, 9, T - 1], 0, 9], ids=["batch", "scalar-0", "scalar-9"])
def test_p_mean_variance_conditions_on_the_next_level_like_jax(t):
    """The level the network is given (√ᾱ_{t+1}, broadcast at a scalar t)
    and the posterior from its output, against the JAX process."""
    jproc, proc = _samplers()
    rng = np.random.default_rng(9)
    x, out = (rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    seen = {}

    def jfn(p, x, lv):
        seen["jax"] = np.asarray(lv)
        return jnp.asarray(out)

    def tfn(p, x, lv):
        seen["port"] = lv.numpy()
        return torch.from_numpy(out)

    tt = np.asarray(t, np.int32)
    ref = jproc.p_mean_variance(jfn, None, jnp.asarray(x), jnp.asarray(tt))
    ours = proc.p_mean_variance(tfn, None, torch.from_numpy(x), torch.from_numpy(tt) if tt.ndim else int(t))
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert seen["port"].shape == (B, 1, 1, 1)
    for name in ("mean", "log_variance", "pred_x_start"):
        np.testing.assert_allclose(np.broadcast_to(getattr(ours, name).numpy(), getattr(ref, name).shape),
                                   np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-5, err_msg=name)
    # a 0-d device t (the captured step's) reads the same level by a gather
    if not tt.ndim:
        proc.p_mean_variance(tfn, None, torch.from_numpy(x), torch.tensor(int(t)))
        np.testing.assert_array_equal(seen["port"], seen["jax"])


@pytest.mark.parametrize("schedule,timesteps,short,iters", [
    ("linear", 1000, 50, 100), ("linear", T, 6, 30), ("cosine", 1000, 50, 100), ("quadratic", 200, 10, 60),
])
def test_searched_schedule_equals_jax_and_restores(schedule, timesteps, short, iters):
    """The random search picks the same float64 beta_end as the JAX one
    (the same candidates, compared at the same float32 table end), the
    short table equals JAX's, and the restore brings the original table
    back: the very tensors of construction."""
    jproc, proc = _samplers(schedule, timesteps)
    original = proc.constants
    key = "max_clip" if schedule == "cosine" else "beta_end"
    jproc.search_noise_schedule_coefficients(timesteps=short, iters=iters, seed=0, verbose=False)
    jproc.change_noise_schedule(verbose=False)
    jproc.compute_constants(short)
    proc.use_searched_schedule(short, iters, seed=0)
    assert proc.schedule_cfg[schedule][key] == jproc.schedule_cfg[schedule][key] != SCHEDULE_CFG[schedule][key]
    assert proc.timesteps == jproc.timesteps == short
    for name in ("sqrt_alphas_cumprod_prev", "posterior_mean_coef1", "posterior_log_variance_clipped"):
        np.testing.assert_array_equal(getattr(proc.constants, name).numpy(), np.asarray(getattr(jproc.constants, name)))
    proc.restore_schedule()
    jproc.change_noise_schedule(reset_cfg=True, verbose=False)
    jproc.compute_constants(timesteps)
    assert proc.constants is original and proc.timesteps == timesteps
    np.testing.assert_array_equal(proc.constants.betas.numpy(), np.asarray(jproc.constants.betas))


def test_search_writes_into_the_model_config_as_jax_does(pair):
    """A property of the JAX package, kept: the search writes the best
    beta_end into the schedule's dict, which the model's config shares, and
    the reset restores the sampler's copy only. The config (and so an
    archive saved after a sample dump) keeps the searched value."""
    for m in (_jax_model(), WavegradDDPM(load_config(YAML, overrides=TINY).model, device="cpu")):
        before = float(m.cfg.sampler.schedule_cfg.linear.beta_end)
        m.sampler.search_noise_schedule_coefficients(timesteps=6, iters=20, seed=0, verbose=False)
        searched = float(m.sampler.schedule_cfg["linear"]["beta_end"])
        m.sampler.change_noise_schedule(reset_cfg=True, verbose=False)
        assert float(m.sampler.schedule_cfg["linear"]["beta_end"]) == before
        assert float(m.cfg.sampler.schedule_cfg.linear.beta_end) == searched != before


def test_pred_v_is_refused_as_in_jax():
    with pytest.raises(ValueError, match="pred_noise"):
        WaveGradDiffusion(T, "linear", objective="pred_v", device="cpu")


# ------------------------------------------------------------ training step --
def _jax_draws(key, batch):
    """WavegradDDPM.training_step's draws from its key."""
    k_pre, k_level, k_noise, _k_drop = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_level)
    return {
        "flip": torch.from_numpy(np.asarray(jax.random.bernoulli(k_pre, 0.5, (batch,)))),
        "s": torch.from_numpy(np.asarray(jax.random.randint(k1, (batch,), 1, T + 1))),
        "u": torch.from_numpy(np.asarray(jax.random.uniform(k2, (batch,), dtype=jnp.float32))),
        "noise": torch.from_numpy(np.asarray(jax.random.normal(k_noise, (batch, IMG, IMG, 3), jnp.float32))),
    }


def test_training_step_loss_and_gradient_match_jax(pair):
    jmodel, model = pair
    rng = np.random.default_rng(10)
    batch = {"image": rng.integers(0, 256, (6, IMG, IMG, 3), dtype=np.uint8)}
    key = jax.random.PRNGKey(3)
    b = jax.tree.map(jnp.asarray, batch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.training_step(p, b, key, 0), has_aux=True))(
        jmodel.params)
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, metrics = model.training_step(params, batch, _jax_draws(key, 6))
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(metrics) == {"train_loss"}
    jflat = from_flax_params(jax.tree.map(np.asarray, jgrads), model.diffusion_model)
    ours = np.concatenate([(torch.zeros_like(p) if g is None else g).numpy().ravel()
                           for (k, p), g in zip(params.items(), grads)])
    theirs = np.concatenate([jflat[k].numpy().ravel() for k in params])
    assert _rel_l2(ours, theirs) < WHOLE_TOL
    unused = {k for k, g in zip(params, grads) if g is None}
    # The deepest FiLM, as the network declares it: JAX's gradient is 0 there.
    assert unused == model.diffusion_model.unused_params and all(k.startswith("film_2.") for k in unused)
    assert all(not jflat[k].any() for k in unused)


def test_param_grads_zero_only_what_the_network_declares_unused():
    """The trainer's gradients: a parameter the network declares unused
    gets a zero gradient; any other one the loss does not read raises, for
    every family, as autograd does."""
    params = {k: torch.ones(2, requires_grad=True) for k in ("read", "declared", "other")}
    loss = (params["read"] * 3).sum()
    with pytest.raises(RuntimeError, match="other"):
        param_grads(loss, params, frozenset({"declared"}))
    with pytest.raises(RuntimeError):
        param_grads(loss, params)
    grads = param_grads((params["read"] * 3).sum(), {k: params[k] for k in ("read", "declared")},
                        frozenset({"declared"}))
    assert grads["read"].tolist() == [3.0, 3.0] and grads["declared"].tolist() == [0.0, 0.0]


def test_fit_captured_steps_equal_eager_and_dump_restores_the_schedule(tmp_path):
    """Trainer.fit with the captured step (graphs=True runs the step
    functions eagerly on the CPU) equals the eager fit bit for bit; the
    sample dump searches a 50-step schedule and restores the original
    table, then bits/dim runs on it (compute_bpd)."""
    from diffusion_model_nemo_tpu_torch.training import Trainer

    runs = []
    for graphs in (False, True):
        cfg = load_config(YAML, overrides=[*TINY, "model.train_ds.batch_size=2", "+model.train_ds.length=4",
                                           "model.save_every=2", f"+model.results_dir={tmp_path / str(graphs)}"]).model
        model = WavegradDDPM(cfg, device="cpu")
        original, bpd, seen = model.sampler.constants, model.calculate_bits_per_dimension, []

        def spy(x, *args, _bpd=bpd, _model=model, **kwargs):
            seen.append((_model.sampler.timesteps, _model.sampler.constants is original))
            return _bpd(x, *args, **kwargs)

        model.calculate_bits_per_dimension = spy
        trainer = Trainer(max_steps=2, log_every_n_steps=1)
        trainer.fit(model, graphs=graphs)
        assert model.sampler.constants is original and model.sampler.timesteps == T
        assert (tmp_path / str(graphs) / "sample-1-1.png").exists()
        assert seen == [(T, True)]  # bits/dim after the dump, on the restored table
        runs.append((model, trainer))
    (m0, t0), (m1, t1) = runs
    timed = lambda logged: [{k: v for k, v in m.items() if k != "samples_per_sec"} for m in logged]  # noqa: E731
    assert timed(t0.logged) == timed(t1.logged)
    assert all(torch.equal(m0.params[k], m1.params[k]) for k in m0.params)


# ------------------------------------------------------------------ chains --
def _jax_chain_noise(key, shape, steps):
    """The JAX ancestral scan's draws: the initial image, then one split a
    step (t = T-1 … 1; t = 0 draws but adds none)."""
    key, init_key = jax.random.split(key)
    draws = [np.asarray(jax.random.normal(init_key, shape, jnp.float32))]
    for _ in range(steps - 1):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (shape[0], int(np.prod(shape[1:]))), jnp.float32))
                     .reshape(shape))
    return draws


def feed(monkeypatch, draws):
    """The port's eager chain takes its draws through ``_randn``: feed it
    the JAX scan's."""
    queue = [torch.from_numpy(d) for d in draws]
    monkeypatch.setattr(TG, "_randn", lambda shape, generator, device: queue.pop(0))
    return queue


def test_ancestral_chain_matches_jax_and_replays_equal_eager(pair, monkeypatch):
    jmodel, model = pair
    key = jax.random.PRNGKey(12)
    shape = (2, IMG, IMG, 3)
    ref = jax.jit(lambda p: jmodel.sampler.p_sample_loop(jmodel.model_fn, p, shape, key))(jmodel.params)
    queue = feed(monkeypatch, _jax_chain_noise(key, shape, T))
    with torch.inference_mode():
        ours = model.sampler.p_sample_loop(model.get_model_fn(), model.params, shape, graphs=False)
    assert not queue
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=CHAIN_TOL, atol=CHAIN_TOL)
    monkeypatch.undo()
    runs = [model.sample(2, IMG, generator=torch.Generator().manual_seed(1), graphs=g) for g in (False, True, True)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


def test_searched_schedule_chain_captures_anew(pair):
    """A chain after ``compute_constants(T')`` on the same sampler builds a
    new graph on the new table (repair of the stale-schedule key): the
    graph holds no reference to the old table, and its chain equals the
    eager one on the new table."""
    _, model = pair
    sampler = model.sampler
    gen = lambda: torch.Generator().manual_seed(2)  # noqa: E731
    model.sample(2, IMG, generator=gen(), graphs=True)
    before = {id(g) for g in sampler.graphs.values()}
    old = weakref.ref(sampler.constants.posterior_mean_coef1)
    sampler.use_searched_schedule(6, 30, seed=0)
    try:
        new_table = sampler.constants
        replayed = model.sample(2, IMG, generator=gen(), graphs=True)
        new = [g for g in sampler.graphs.values() if id(g) not in before]
        assert len(new) == 1 and new[0].info["name"] == "ancestral"
        held = {id(t) for t in new[0].sources}
        assert id(new_table.posterior_mean_coef1) in held and id(old()) not in held
        assert torch.equal(replayed, model.sample(2, IMG, generator=gen(), graphs=False))
    finally:
        sampler.restore_schedule()
    assert old() is sampler.constants.posterior_mean_coef1  # the original table is back


@pytest.mark.parametrize("process", ["GaussianDiffusion", "GeneralizedGaussianDiffusion"])
def test_a_compute_constants_table_is_not_replayed_stale(process):
    """On a plain process (ancestral, DDIM): the same T, a new schedule: the
    chain captures anew and the old graph, with its table, goes."""
    from diffusion_model_nemo_tpu_torch import modules

    proc = getattr(modules, process)(T, "linear", device="cpu")
    fn = lambda p, x, t: x * 0.5  # noqa: E731
    proc.p_sample_loop(fn, None, (1, 2, 2, 1), torch.Generator().manual_seed(0), graphs=True)
    (graph,) = proc.graphs.values()
    old = weakref.ref(proc.constants.betas)
    proc.schedule_cfg = {"linear": {"beta_start": 1e-3, "beta_end": 0.2}}
    proc.compute_constants(T)
    out = proc.p_sample_loop(fn, None, (1, 2, 2, 1), torch.Generator().manual_seed(0), graphs=True)
    (rebuilt,) = proc.graphs.values()
    del graph
    gc.collect()
    assert old() is None and rebuilt.sources[-1] is proc.table_tensors()[-1]
    assert torch.equal(out, proc.p_sample_loop(fn, None, (1, 2, 2, 1), torch.Generator().manual_seed(0),
                                               graphs=False))


# ---------------------------------------------------------------- bits/dim --
def _jax_bpd_noise(key, shape, steps=T):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def test_bits_per_dimension_matches_jax(pair):
    """Through WaveGrad's p_mean_variance (the level √ᾱ_{t+1} at each t);
    the JAX package computes it (no failure to keep)."""
    jmodel, model = pair
    x = np.random.default_rng(13).integers(0, 256, (B, IMG, IMG, 3)).astype(np.float32) / 127.5 - 1.0
    key = jax.random.PRNGKey(14)
    ref = jmodel.calculate_bits_per_dimension(jnp.asarray(x), key=key)
    noise = torch.from_numpy(_jax_bpd_noise(key, x.shape))
    ours = model.calculate_bits_per_dimension(torch.from_numpy(x), noise=noise)
    for k in ("total_bpd", "prior_bpd"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=WHOLE_TOL, err_msg=k)
    np.testing.assert_allclose(ours["terms_bpd"].numpy(), np.asarray(ref["terms_bpd"]), rtol=1e-3, atol=1e-5)
    replayed = model.calculate_bits_per_dimension(torch.from_numpy(x), noise=noise, graphs=True)
    assert torch.equal(replayed["terms_bpd"], ours["terms_bpd"])


# ---------------------------------------------------------------- archives --
def test_archives_restore_both_ways(pair, tmp_path):
    jmodel, model = pair
    x, level = np.random.default_rng(15).uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32), _levels(15)
    apply = jax.jit(jmodel.model_fn)
    restored = restore_model_from_archive(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    assert type(restored) is WavegradDDPM and isinstance(restored.sampler, WaveGradDiffusion)
    ours = restored.model_fn(restored.params, torch.from_numpy(x), torch.from_numpy(level)).numpy()
    assert _rel_l2(ours, apply(jmodel.params, jnp.asarray(x), jnp.asarray(level))) < WHOLE_TOL
    path = model.save_to(str(tmp_path / "port.dmn"))
    assert j_load_archive(path)[3] == {"model_class": "WavegradDDPM"}
    back = j_restore(path)
    assert type(back).__name__ == "WavegradDDPM"
    ref = model.model_fn(model.params, torch.from_numpy(x), torch.from_numpy(level)).numpy()
    assert _rel_l2(apply(back.params, jnp.asarray(x), jnp.asarray(level)), ref) < WHOLE_TOL


def test_interpolate_raises():
    model = WavegradDDPM(load_config(YAML, overrides=TINY).model, device="cpu")
    with pytest.raises(NotImplementedError):
        model.interpolate(None, None)


# ---------------------------------------------------------- CLIs, serving --
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_wavegrad_ddpm for 2 steps with a dump at step 2 (search,
    sample, restore, bits/dim); its archive."""
    root = tmp_path_factory.mktemp("wavegrad_cli")
    model, trainer = train_wavegrad_ddpm.main([
        *TINY[:5], "model.train_ds.name=synthetic", "model.train_ds.batch_size=2", "+model.train_ds.length=4",
        "model.save_every=2", f"+model.results_dir={root / 'results'}", "trainer.max_steps=2",
        "trainer.log_every_n_steps=1", "trainer.accelerator=cpu", f"exp_manager.exp_dir={root / 'exp'}",
        "exp_manager.create_tensorboard_logger=false", "+exp_manager.version=run",
    ])
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    return root, model, trainer, dmn


def test_train_cli_dumps_on_the_searched_schedule_and_writes_the_archive(trained):
    root, model, trainer, dmn = trained
    assert [m["global_step"] for m in trainer.logged if "train_loss" in m] == [1, 2]
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged if "train_loss" in m)
    assert (root / "results" / "sample-1-1.png").exists()
    assert model.sampler.timesteps == T and isinstance(restore_model_from_archive(str(dmn), device="cpu"), WavegradDDPM)


def test_eval_and_test_clis_search_their_schedules(trained, tmp_path):
    _, _, _, dmn = trained
    out_dir = eval_wavegrad_ddpm.main([f"model_path={dmn}", "batch_size=2", "device=cpu", "add_timestamp=false",
                                       "sample_timesteps=6", "search_iters=20", f"output_dir={tmp_path}"])
    assert (out_dir / "samples_grid.png").exists()
    result = test_wavegrad_ddpm.main([f"model_path={dmn}", "batch_size=2", "limit_test_batches=1", "device=cpu",
                                      "search_timesteps=6", "search_iters=20"])
    assert np.isfinite(result["test_total_bpd"])


def _post(srv, path, payload):
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://{srv.host}:{srv.port}{path}", data=json.dumps(payload).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serving_samples_on_its_own_chain_and_ddim_as_jax_does(trained):
    """/sample on the archive's own ancestral chain (use_ddim_sampler=false);
    /vocode answers 400; with the DDIM swap the server runs, as the JAX
    server does, DDIM on the network with the integer t as its level (the
    same chain as the JAX DDIM sampler on the same network)."""
    import io

    _, _, _, dmn = trained
    srv = serve(str(dmn), port=0, max_batch=2, use_ddim_sampler=False, device="cpu")
    srv.start_background()
    try:
        code, body = _post(srv, "/sample", {"num_images": 2, "seed": 0, "format": "npy"})
        assert code == 200 and np.load(io.BytesIO(body)).shape == (2, IMG, IMG, 3)
        assert _post(srv, "/vocode", {"mel_npy": ""})[0] == 400
        assert type(srv.batcher.model.sampler) is WaveGradDiffusion
    finally:
        srv.shutdown()
    ddim = serve(str(dmn), port=0, max_batch=2, use_ddim_sampler=True, ddim_timesteps=5, device="cpu")
    try:
        model = ddim.batcher.model
        assert type(model.sampler).__name__ == "GeneralizedGaussianDiffusion"
        jmodel = j_restore(str(dmn))
        jmodel.change_sampler(dict(model.cfg.sampler))
        img = np.random.default_rng(16).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
        ref = jmodel.sampler.p_sample_loop(jmodel.model_fn, jmodel.params, img.shape, jax.random.PRNGKey(0),
                                           img=jnp.asarray(img))
        with torch.inference_mode():
            ours = model.sampler.p_sample_loop(model.get_model_fn(), model.params, img.shape,
                                               img=torch.from_numpy(img), graphs=False)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=CHAIN_TOL, atol=CHAIN_TOL)
    finally:
        ddim.shutdown()
