"""The port's ScoreSDE model against the JAX package, on the CPU: the
score-matching loss, the training step, the likelihood (ODE bits/dim), the
model built from the shipped YAML, archives, the three CLIs, serving, and
the ``compute_bpd`` property the port keeps from the JAX package.

The network is examples/configs/score_sde/vp/unet_small.yaml cut to a
float32 U-Net (dim 8, dim_mults [1], 4 GroupNorm groups as shipped, 8 px);
the JAX side gets the port's seeded weights through ``utils/weights.py``.
Inputs are made with numpy from a seed; the training step's draws (flip,
t, noise) come from the JAX step's key as ``ScoreSDE.training_step`` splits
it, and the trace probe from the JAX likelihood's key.

Tolerances, each stated where it is used: the loss 1e-5 relative; the
training step's loss 1e-5 and its whole gradient 1e-4 relative L2; the
likelihood equal NFE and bits/dim within 1e-4 relative. The replayed RK45
loop (the card's captured step, run eagerly here) equals the eager loop
bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.loss import SDEScoreFunctionLoss as JLoss
from diffusion_model_nemo_tpu.models import ScoreSDE as JScoreSDE
from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore
from diffusion_model_nemo_tpu.modules import VESDE as JVE
from diffusion_model_nemo_tpu.modules import VPSDE as JVP
from diffusion_model_nemo_tpu.modules import subVPSDE as JSubVP
from diffusion_model_nemo_tpu.training.checkpoints import load_archive as j_load_archive
from diffusion_model_nemo_tpu_torch.cli import eval_score_sde, test_score_sde, train_score_sde
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.loss import SDEScoreFunctionLoss
from diffusion_model_nemo_tpu_torch.models import ScoreSDE, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules import (
    VESDE, VPSDE, LikelihoodEstimate, PredictorCorrectorSampler, ProbabilityFlowSampler, subVPSDE,
)
from diffusion_model_nemo_tpu_torch.serving import serve
from diffusion_model_nemo_tpu_torch.training import Trainer
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/score_sde/vp/unet_small.yaml"
IMG, B, N = 8, 2, 20
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={N}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic",
]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BPD_TOL = 1e-4
SHAPE = (B, IMG, IMG, 3)


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
def pair():
    """The port's ScoreSDE (seeded weights), the JAX one with the same
    weights, and the JAX network jitted once."""
    model = ScoreSDE(load_config(YAML, overrides=TINY).model, device="cpu")
    jmodel = JScoreSDE(cfg=j_load_config(YAML, overrides=TINY).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    jmodel.ema_params = jmodel.params
    jfn = jax.jit(jmodel.model_fn)
    return model, jmodel, (lambda p, x, t: jfn(p, x, t))


def _images(seed, batch=B):
    return {"image": np.random.default_rng(seed).integers(0, 256, (batch, IMG, IMG, 3), dtype=np.uint8)}


def _x(seed, batch=B):
    return _images(seed, batch)["image"].astype(np.float32) / 127.5 - 1.0


# --------------------------------------------------------------------- loss --
@pytest.mark.parametrize("kind,weighting,reduction", [
    ("vp", w, r) for w in (False, True) for r in ("mean", "batch_mean", "sum", "none")
] + [("ve", False, "mean"), ("subvp", True, "mean"), ("ve", True, "sum")])
def test_score_matching_loss_matches_jax(pair, kind, weighting, reduction):
    """Both likelihood weightings, the four reductions (and VE, sub-VP),
    t rescaled to [eps, T], on the U-Net: 1e-5 relative. Weighted and
    unreduced, both packages fail alike."""
    model, jmodel, jfn = pair
    jsde, sde = {"vp": (JVP(N=N), VPSDE(N=N, device="cpu")), "ve": (JVE(N=N), VESDE(N=N, device="cpu")),
                 "subvp": (JSubVP(N=N), subVPSDE(N=N, device="cpu"))}[kind]
    kw = dict(continuous=True, likelihood_weighting=weighting, eps=1e-5, reduction=reduction)
    jloss, loss = JLoss(**kw), SDEScoreFunctionLoss(**kw)
    jloss.update_sde(jsde)
    loss.update_sde(sde)
    rng = np.random.default_rng(2)
    x, t, noise = _x(1), rng.uniform(0, 1, B).astype(np.float32), rng.standard_normal(SHAPE).astype(np.float32)
    if weighting and reduction == "none":
        # g(t)² [B] times the unreduced [B, H, W, C] losses broadcasts on the
        # channel axis: the JAX loss fails there, and so does the port's.
        with pytest.raises(ValueError, match="broadcasting"):
            jloss(jfn, jmodel.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
        with pytest.raises(RuntimeError, match="must match"):
            loss(model.model_fn, model.params, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
        return
    ours = loss(model.model_fn, model.params, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
    ref = jloss(jfn, jmodel.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
    np.testing.assert_allclose(float(ours), float(ref), rtol=LOSS_TOL)


# -------------------------------------------------------- the training step --
def _jax_draws(key, batch):
    """ScoreSDE.training_step's draws from its key (k_pre, k_t, k_noise)."""
    k_pre, k_t, k_noise, _k_drop = jax.random.split(key, 4)
    return {
        "flip": torch.from_numpy(np.array(jax.random.bernoulli(k_pre, 0.5, (batch,)))),
        "t": torch.from_numpy(np.array(jax.random.uniform(k_t, (batch,), dtype=jnp.float32))),
        "noise": torch.from_numpy(np.array(jax.random.normal(k_noise, (batch, IMG, IMG, 3), jnp.float32))),
    }


def test_training_step_loss_and_gradient_match_jax(pair):
    """The JAX step's key gives the port its draws (flip, t ~ U(0, 1) as
    float32, noise): the loss at 1e-5 and the whole float32 gradient at
    1e-4 relative L2 against jax.grad."""
    model, jmodel, _ = pair
    batch = _images(3, batch=4)
    key = jax.random.PRNGKey(7)
    b = jax.tree.map(jnp.asarray, batch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.training_step(p, b, key, 0), has_aux=True))(
        jmodel.params)
    draws = _jax_draws(key, 4)
    assert draws["t"].dtype == torch.float32 and draws["flip"].any() and not draws["flip"].all()
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, metrics = model.training_step(params, batch, draws)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_TOL)
    assert set(metrics) == {"train_loss"}
    jg = from_flax_params(jax.tree.map(np.asarray, jgrads), model.diffusion_model)
    flat = lambda g: np.concatenate([g[k].detach().numpy().ravel() for k in sorted(g)])  # noqa: E731
    assert _rel_l2(flat(grads), flat(jg)) < GRAD_TOL


def test_draws_and_the_captured_step_take_float_times(pair):
    """``draw_training_inputs`` gives t ~ U[0, 1) float32 [B]; the trainer's
    step graph keeps its dtype (one eager step, then a replay on the CPU,
    equal to two eager steps)."""
    model, _, _ = pair
    draws = model.draw_training_inputs((4, IMG, IMG, 3), torch.Generator().manual_seed(0))
    assert draws["t"].dtype == torch.float32 and bool(((draws["t"] >= 0) & (draws["t"] < 1)).all())
    batch = _images(5, batch=4)
    losses = {}
    for graphs in (True, False):
        trainer = Trainer(max_steps=2, devices=1)
        state = trainer.init_state(model, 2)
        losses[graphs] = [float(trainer.train_step(model, state, batch, draws, graphs=graphs)["train_loss"])
                          for _ in range(2)]
        if graphs:
            assert next(iter(state.graphs.values())).static["t"].dtype == torch.float32
    assert losses[True] == losses[False]


# ------------------------------------------------------------- the likelihood --
def _jax_epsilon(key, kind):
    if kind == "gaussian":
        return np.array(jax.random.normal(key, SHAPE, dtype=jnp.float32))
    return np.array(jax.random.randint(key, SHAPE, 0, 2).astype(jnp.float32) * 2.0 - 1.0)


@pytest.mark.parametrize("kind", ["rademacher", "gaussian"])
def test_likelihood_matches_jax(pair, kind):
    """The probability-flow ODE's bits/dim on the U-Net at the config's
    rtol = atol = 1e-5, the probe drawn from the JAX key: equal NFE, bpd
    within 1e-4 relative, the latent within 1e-3 relative L2. The JAX
    estimator runs as called (under an outer jax.jit XLA fuses the drift
    into the solver differently and JAX's own NFE may move)."""
    model, jmodel, jfn = pair
    jlk = jmodel.likelihood_estimator
    jlk.hutchinson_type = kind
    lk = LikelihoodEstimate(hutchinson_type=kind)
    lk.update_sde(model.sde)
    x = _x(4)
    key = jax.random.PRNGKey(9)
    bpd_j, z_j, nfe_j = jlk.likelihood(jfn, jmodel.params, jnp.asarray(x), key)
    eps = torch.from_numpy(_jax_epsilon(key, kind))
    bpd, z, nfe = lk.likelihood(model.train_model_fn, model.params, torch.from_numpy(x), epsilon=eps)
    assert int(nfe) == int(nfe_j) > 0, (int(nfe), int(nfe_j))
    np.testing.assert_allclose(bpd.numpy(), np.asarray(bpd_j), rtol=BPD_TOL)
    assert _rel_l2(z.numpy(), z_j) < 1e-3 and bool(torch.isfinite(bpd).all())


def test_likelihood_replays_equal_the_eager_loop(pair):
    """The captured RK step (forward and vjp through the network; run
    eagerly here) replayed against the eager solve, bit for bit, a second
    solve from the same graph too; the probe drawn from a generator."""
    model, _, _ = pair
    lk = LikelihoodEstimate(rtol=1e-3, atol=1e-3)
    lk.update_sde(model.sde)
    x = torch.from_numpy(_x(6))
    runs = [lk.likelihood(model.train_model_fn, model.params, x, generator=torch.Generator().manual_seed(1),
                          graphs=g) for g in (True, False, True)]
    for bpd, z, nfe in runs[1:]:
        assert torch.equal(bpd, runs[0][0]) and torch.equal(z, runs[0][1]) and torch.equal(nfe, runs[0][2])
    assert len(lk.graphs) == 1


def test_likelihood_max_steps_exhaustion_is_nan(pair):
    model, _, _ = pair
    lk = LikelihoodEstimate(max_steps=2)
    lk.update_sde(model.sde)
    bpd, z, nfe = lk.likelihood(model.train_model_fn, model.params, torch.from_numpy(_x(6)),
                                generator=torch.Generator().manual_seed(1))
    assert int(nfe) == 14 and bool(torch.isnan(bpd).all()) and bool(torch.isnan(z).all())


# ----------------------------------------------------------------- the model --
@pytest.mark.parametrize("sde_type,cls", [("vpsde", VPSDE), ("subvpsde", subVPSDE), ("vesde", VESDE)])
def test_score_sde_builds_from_the_shipped_yaml(sde_type, cls):
    """Each ``sde_type`` wires one SDE object into the sampler, the loss
    and the likelihood estimator, as in the JAX model."""
    cfg = load_config(YAML, overrides=[*TINY, f"model.sde.sde_type={sde_type}"]).model
    model = ScoreSDE(cfg, device="cpu")
    jmodel = JScoreSDE(cfg=j_load_config(YAML, overrides=[*TINY, f"model.sde.sde_type={sde_type}"]).model)
    assert type(model.sde) is cls and type(jmodel.sde).__name__ == cls.__name__
    assert model.sampler.sde is model.loss.sde is model.likelihood_estimator.sde is model.sde
    assert isinstance(model.sampler, PredictorCorrectorSampler) and model.sampler.predictor == "euler_maruyama"
    assert model.sde.N == N and model.diffusion_model.down_0_block1.block1.norm.groups == 4
    out, nfe = model.sample(B, IMG, generator=torch.Generator().manual_seed(0), return_nfe=True)
    assert out.shape == SHAPE and nfe == 2 * N and bool(torch.isfinite(out).all())


def test_change_sampler_rewires_the_sde(pair):
    model, _, _ = pair
    model.change_sampler({"_target_": "diffusion_model_nemo.modules.ProbabilityFlowSampler", "denoise": True})
    assert isinstance(model.sampler, ProbabilityFlowSampler) and model.sampler.sde is model.sde
    assert model.cfg.sampler["_target_"] == "diffusion_model_nemo.modules.ProbabilityFlowSampler"
    model.change_sampler(dict(load_config(YAML, overrides=TINY).model.sampler, predictor="reverse_diffusion",
                              corrector="langevin"))
    assert model.sampler.corrector == "langevin" and model.sampler.sde is model.sde
    out, nfe = model.sample(B, IMG, generator=torch.Generator().manual_seed(0), return_nfe=True)
    assert nfe == 2 * N and bool(torch.isfinite(out).all())


def test_test_step_and_epoch_end_return_the_jax_keys(pair):
    """``Trainer.test`` over one batch: the JAX model's keys
    (test_total_bpd, avg_num_forward_evaluations) from outputs with its
    test_step's keys."""
    model, jmodel, _ = pair
    model.likelihood_estimator = LikelihoodEstimate(rtol=1e-3, atol=1e-3)
    model.likelihood_estimator.update_sde(model.sde)
    model.setup_test_data({"name": "synthetic", "batch_size": B, "length": B})
    result = Trainer(limit_test_batches=1).test(model)
    out = model.test_step(_images(8), 0, generator=torch.Generator().manual_seed(0))
    jout = {k: np.asarray(v) for k, v in out.items()}
    assert set(out) == {"bpds", "nfe", "num_samples"}
    assert set(result) == set(jmodel.test_epoch_end([jout])) == {"test_total_bpd", "avg_num_forward_evaluations"}
    assert np.isfinite(result["test_total_bpd"]) and result["avg_num_forward_evaluations"] > 0


def test_compute_bpd_refuses_a_score_sde_as_jax_fails(pair, tmp_path):
    """JAX: the trainer's first save_every dump calls
    calculate_bits_per_dimension, which reads ``sampler.timesteps``
    (abstract_diffusion_model.py:269): AttributeError. The port: the dump's
    grid is written, then a ValueError naming that cause."""
    _, jmodel, _ = pair
    with pytest.raises(AttributeError, match="timesteps"):
        jmodel.calculate_bits_per_dimension(jnp.zeros(SHAPE))
    cfg = load_config(YAML, overrides=[*TINY, "model.save_every=1", "model.compute_bpd=true",
                                       "model.train_ds.batch_size=2", "+model.train_ds.length=4",
                                       f"+model.results_dir={tmp_path}"]).model
    model = ScoreSDE(cfg, device="cpu")
    with pytest.raises(ValueError, match=r"abstract_diffusion_model.py:269.*sampler.timesteps"):
        Trainer(max_steps=1, devices=1).fit(model)
    assert (tmp_path / "sample-1-1.png").exists()


# ---------------------------------------------------------------- archives --
def test_archives_restore_both_ways(pair, tmp_path):
    """The port's archive restores through ``restore_model_from_archive``
    as a ScoreSDE (and in the JAX package); the JAX package's archive
    restores in the port. The network agrees at 2e-4 relative L2."""
    model, jmodel, jfn = pair
    x, t = _x(10), np.asarray([0.3 * (N - 1), 0.9 * (N - 1)], np.float32)
    path = model.save_to(str(tmp_path / "port.dmn"))
    assert j_load_archive(path)[3] == {"model_class": "ScoreSDE"}
    restored = restore_model_from_archive(path, device="cpu")
    assert type(restored) is ScoreSDE and type(restored.sde) is VPSDE
    assert all(torch.equal(restored.params[k], v) for k, v in model.params.items())
    back = j_restore(path)
    assert type(back).__name__ == "ScoreSDE"
    ref = model.model_fn(model.params, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert _rel_l2(jfn(back.params, jnp.asarray(x), jnp.asarray(t)), ref) < 2e-4
    theirs = restore_model_from_archive(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    assert type(theirs) is ScoreSDE
    assert _rel_l2(theirs.model_fn(theirs.params, torch.from_numpy(x), torch.from_numpy(t)).numpy(), ref) < 2e-4


# -------------------------------------------------------- CLIs and serving --
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_score_sde for 2 steps at a tiny size (compute_bpd off: the JAX
    property above); its archive."""
    root = tmp_path_factory.mktemp("score_sde_cli")
    model, trainer = train_score_sde.main([
        *TINY[:5], "model.train_ds.name=synthetic", "model.train_ds.batch_size=2", "+model.train_ds.length=4",
        "model.compute_bpd=false", "model.likelihood_estimate.rtol=1e-3", "model.likelihood_estimate.atol=1e-3",
        "trainer.max_steps=2", "trainer.log_every_n_steps=1", "trainer.accelerator=cpu",
        f"exp_manager.exp_dir={root / 'exp'}", "exp_manager.create_tensorboard_logger=false",
        "+exp_manager.version=run",
    ])
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    return root, model, trainer, dmn


def test_train_cli_logs_finite_losses_and_writes_the_archive(trained):
    _, model, trainer, dmn = trained
    assert [m["global_step"] for m in trainer.logged] == [1, 2]
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    assert dmn.name == "VPSDE-SDE-UNet.dmn" and type(restore_model_from_archive(str(dmn), device="cpu")) is ScoreSDE


@pytest.mark.parametrize("args,nfe", [([], 2 * N), (["predictor=reverse_diffusion", "corrector=ald"], 2 * N),
                                      (["use_probability_flow_sampler=true"], None)])
def test_eval_cli_samples_with_each_sampler(trained, tmp_path, args, nfe):
    _, _, _, dmn = trained
    out_dir, got = eval_score_sde.main([f"model_path={dmn}", "batch_size=2", "device=cpu", "add_timestamp=false",
                                        f"output_dir={tmp_path}", *args])
    assert (out_dir / "samples_grid.png").exists() and (out_dir / "sample_1.png").exists()
    assert got == nfe if nfe is not None else got > 0 and got % 7 == 0


def test_test_cli_reports_bits_per_dimension_and_nfe(trained):
    _, _, _, dmn = trained
    result = test_score_sde.main([f"model_path={dmn}", "batch_size=2", "limit_test_batches=1", "device=cpu",
                                  "dataset_name=synthetic"])
    assert np.isfinite(result["test_total_bpd"]) and result["avg_num_forward_evaluations"] > 0


def test_serving_refuses_ddim_and_answers_with_its_own_sampler(trained):
    """``use_ddim_sampler=true`` (the serve CLI's default) raises the JAX
    server's ValueError; with false the archive's PC sampler answers."""
    _, _, _, dmn = trained
    with pytest.raises(ValueError, match="use their own ODE sampler"):
        serve(str(dmn), port=0, max_batch=2, device="cpu")
    server = serve(str(dmn), port=0, max_batch=2, use_ddim_sampler=False, device="cpu")
    try:
        images = server.batcher.submit(3, seed=4, timeout=120)
        with pytest.raises(ValueError, match="no edit surface"):  # /edit answers 400, as the JAX server does
            server.batcher.submit_edit(np.zeros((1, IMG, IMG, 3), np.uint8), strength=0.5)
    finally:
        server.shutdown()
    assert images.shape == (3, IMG, IMG, 3) and images.dtype == np.uint8
    assert isinstance(server.batcher.model.sampler, PredictorCorrectorSampler)
