"""The port's progressive distillation (``training/distillation.py``) and
``distill_ddpm`` on the CPU, against the JAX package where it has the same
function.

The teacher is ``examples/configs/ddpm/unet_small.yaml`` cut to a tiny
float32 U-Net (dim 8, dim_mults [1, 2], 8 px, T = 16); the guided teacher
is ``conditional_ddpm/unet_small.yaml`` cut the same way (4 classes). The
JAX models get the port's weights (``utils/weights.py:to_flax_params``).
Each JAX fused step (``ProgressiveDistiller._get_step``) is compiled once a
module, and the port's step is fed the draws JAX derives inside it from
the same key (its flip, t and ε), on the same uint8 batch.

Tolerances: ``predict_eps_x0`` 1e-6 relative; a loss before any update
1e-5 relative; a loss after an update 1e-3 relative; the student's
parameters after two updates 2e-4 relative L2 (the whole network's). The
later two are looser because AdamW's first steps normalize each gradient
element: an analytically zero gradient (the biases before a GroupNorm)
carries each package's rounding noise, which becomes a step of ±lr. The
captured step, run eagerly on the CPU, equals the eager step bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import DDPM as JDDPM
from diffusion_model_nemo_tpu.models import ConditionalDDPM as JConditionalDDPM
from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore
from diffusion_model_nemo_tpu.training.distillation import ProgressiveDistiller as JProgressiveDistiller
from diffusion_model_nemo_tpu.training.distillation import predict_eps_x0 as j_predict_eps_x0
from diffusion_model_nemo_tpu_torch.cli import distill_ddpm, eval_ddpm, train_ddpm
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import (ConditionalDDPM, DDPM, TextConditionalDDPM,
                                                   restore_model_from_archive)
from diffusion_model_nemo_tpu_torch.training import ConsistencyDistiller, ProgressiveDistiller, predict_eps_x0
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/ddpm/unet_small.yaml"
COND_YAML = REPO / "examples/configs/conditional_ddpm/unet_small.yaml"
TEXT_YAML = REPO / "examples/configs/dit/text_dit_small.yaml"
T, IMG, B, K, LR, W = 16, 8, 2, 4, 1e-3, 2.0
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=16",
]
COND_TINY = [*TINY, f"model.num_classes={K}"]
TEXT_TINY = [
    f"model.image_size={IMG}", "model.timesteps=4", "model.diffusion_model.dim=32", "model.diffusion_model.depth=1",
    "model.diffusion_model.heads=4", "model.diffusion_model.context_dim=16", "model.max_text_len=8",
    "model.diffusion_model.dtype=float32",
]
EPS_X0_TOL = 1e-6  # relative
LOSS_TOL = 1e-5  # relative, before any update
UPDATED_LOSS_TOL = 1e-3  # relative, after an update
WHOLE_TOL = 2e-4  # the whole network's parameters, relative L2
COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# case: (conditional teacher, stride, the teacher's objective, substeps, guided)
CASES = {
    "phase_stride2": (False, 2, "pred_v", 2, False),
    "phase_stride4": (False, 4, "pred_v", 2, False),
    "guided_transfer": (True, 1, "pred_noise", 1, True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port(conditional=False):
    if conditional:
        return ConditionalDDPM(load_config(COND_YAML, overrides=COND_TINY).model, device="cpu", seed=0)
    return DDPM(load_config(YAML, overrides=TINY).model, device="cpu", seed=0)


@pytest.fixture(scope="module")
def models():
    """{conditional: (the port model, the JAX model with its weights, the
    JAX distiller)}; the JAX steps compiled lazily, once a module."""
    out = {}
    for conditional in (False, True):
        model = _port(conditional)
        cls, yaml, over = (JConditionalDDPM, COND_YAML, COND_TINY) if conditional else (JDDPM, YAML, TINY)
        jmodel = cls(cfg=j_load_config(yaml, overrides=over).model)
        jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
        jd = JProgressiveDistiller(jmodel, learning_rate=LR, guidance_scale=W if conditional else None)
        out[conditional] = (model, jmodel, jd)
    return out


def _batch(conditional, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)}
    if conditional:
        batch["label"] = np.asarray([1, K - 1], np.int32)
    return batch


def _jax_draws(key, stride, substeps):
    """The draws of the JAX step from its key: the flip, t and ε."""
    k_pre, k_t, k_eps = jax.random.split(key, 3)
    if substeps == 2:
        t = jax.random.randint(k_t, (B,), 0, T // stride, dtype=jnp.int32) * stride
    else:
        t = jax.random.randint(k_t, (B,), 0, T, dtype=jnp.int32)
    return {"flip": torch.from_numpy(np.array(jax.random.bernoulli(k_pre, 0.5, (B,)))),
            "t": torch.from_numpy(np.array(t)),
            "eps": torch.from_numpy(np.array(jax.random.normal(k_eps, (B, IMG, IMG, 3), jnp.float32)))}


def _flat(params, net) -> np.ndarray:
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(to_flax_params(params, net))])


def _jflat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(a)) for a in jax.tree.leaves(tree)])


# ------------------------------------------------------------ predict_eps_x0 --
@pytest.mark.parametrize("objective", ["pred_noise", "pred_v", "pred_x0"])
def test_predict_eps_x0_matches_jax_and_inverts(objective):
    """(ε̂, x̂₀) from each parameterization's output: the JAX package's
    within 1e-6 relative, and the exact inverse of the forward maps."""
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1, 1, (4, IMG, IMG, 1)).astype(np.float32)
    eps = rng.standard_normal(x0.shape).astype(np.float32)
    a = rng.uniform(0.05, 0.95, (4, 1, 1, 1)).astype(np.float32)
    alpha, sigma = np.sqrt(a), np.sqrt(1 - a)
    x = alpha * x0 + sigma * eps
    out = {"pred_noise": eps, "pred_x0": x0, "pred_v": alpha * eps - sigma * x0}[objective]
    ours = predict_eps_x0(objective, *(torch.from_numpy(v) for v in (out, x, alpha, sigma)))
    ref = j_predict_eps_x0(objective, *(jnp.asarray(v) for v in (out, x, alpha, sigma)))
    for o, r, truth in zip(ours, ref, (eps, x0)):
        assert _rel_l2(o.numpy(), r) < EPS_X0_TOL
        np.testing.assert_allclose(o.numpy(), truth, atol=1e-5)
    with pytest.raises(ValueError, match="unknown objective"):
        predict_eps_x0("pred_eps", *(torch.from_numpy(v) for v in (out, x, alpha, sigma)))


# ------------------------------------------------------------ the fused step --
@pytest.fixture(scope="module")
def jax_steps(models):
    """{case: JAX's fused step, lowered in turn and compiled in threads (XLA
    compiles concurrently; the lowering holds the interpreter)}."""
    lowered = {}
    for case, (conditional, stride, objective, substeps, guided) in CASES.items():
        _model, jmodel, jd = models[conditional]
        student = jax.tree.map(jnp.copy, jmodel.params)
        args = (student, jd._tx.init(student), jmodel.params, {k: jnp.asarray(v) for k, v in _batch(conditional).items()},
                jax.random.PRNGKey(0))
        lowered[case] = jd._get_step(stride, objective, substeps, guided).lower(*args)
    with ThreadPoolExecutor(len(lowered)) as pool:
        return dict(zip(lowered, pool.map(lambda low: low.compile(COMPILE), lowered.values())))


@pytest.mark.parametrize("case", list(CASES))
def test_distill_step_matches_jax(models, jax_steps, case):
    """Two updates from the same teacher (the teacher's two DDIM half-steps
    or its one call, guided on 2B rows or not, the target, the weighted
    loss, the clip, AdamW) against JAX's compiled step on its own draws:
    the losses and the student; captured == eager bit for bit; the teacher
    untouched."""
    conditional, stride, objective, substeps, guided = CASES[case]
    model, jmodel, jd = models[conditional]
    batch = _batch(conditional)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    student = jax.tree.map(jnp.copy, jmodel.params)
    opt = jd._tx.init(student)
    jlosses = []
    for key in keys:
        student, opt, loss = jax_steps[case](student, opt, jmodel.params, jbatch, key)
        jlosses.append(float(loss))

    pd = ProgressiveDistiller(model, learning_rate=LR, guidance_scale=W if conditional else None)
    before = {k: v.clone() for k, v in model.params.items()}
    draws = [_jax_draws(k, stride, substeps) for k in keys]
    runs = []
    for graphs in (True, False):
        state = pd.init_state(model.params, objective, stride, substeps, guided)
        losses = [float(pd.train_step(state, batch, d, graphs=graphs)) for d in draws]
        runs.append((state, losses))
    (captured, losses), (eager, eager_losses) = runs
    assert losses == eager_losses and captured.graphs and not eager.graphs
    assert all(torch.equal(captured.student[k], eager.student[k]) for k in before)
    assert all(torch.equal(model.params[k], before[k]) for k in before)
    assert captured.opt_state["count"] == 2
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=LOSS_TOL)
    np.testing.assert_allclose(losses[1], jlosses[1], rtol=UPDATED_LOSS_TOL)
    ours = _flat(captured.student, model.diffusion_model)
    assert _rel_l2(ours, _jflat(student)) < WHOLE_TOL
    assert np.abs(ours - _flat(before, model.diffusion_model)).max() > 0.5 * LR


def test_target_at_t0_is_the_teachers_x0(models):
    """A phase's target at t = 0 is the teacher's clipped x̂₀ (the 0 → −1
    step the two grids share); elsewhere it is the solved DDIM x̂₀."""
    model = models[False][0]
    pd = ProgressiveDistiller(model, learning_rate=LR)
    state = pd.init_state(model.params, "pred_v", 4, 2)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, IMG, IMG, 3)).astype(np.float32))
    fn = model.get_model_fn(training=True)
    with torch.no_grad():
        for t, equal in ((0, True), (8, False)):
            t = torch.full((B,), t, dtype=torch.int32)
            _eps, x0 = pd._teacher_eps_x0(fn, model.params, x, t, "pred_v")
            assert torch.equal(pd.target(state, fn, x, t), x0) is equal


# ----------------------------------------------------------------- the recipe --
@pytest.mark.parametrize("final_steps", [8, 4, 2, 1, 3, 5, 16])
def test_halving_schedule_and_its_errors_match_jax(models, final_steps):
    """The phases T/2, T/4, … down to ``final_steps``; an unreachable one
    raises JAX's error (before any step)."""
    model, jmodel, _jd = models[False]
    pd = ProgressiveDistiller(model, learning_rate=LR)
    reachable = {8: [8], 4: [8, 4], 2: [8, 4, 2], 1: [8, 4, 2, 1]}
    if final_steps in reachable:
        assert pd.halving_schedule(final_steps) == reachable[final_steps]
        return
    with pytest.raises(ValueError) as ours:
        pd.distill(iter(()), final_steps=final_steps, steps_per_phase=1, transfer_steps=1)
    with pytest.raises(ValueError) as ref:
        JProgressiveDistiller(jmodel).distill(iter(()), final_steps, 1, jax.random.PRNGKey(0), transfer_steps=1)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("call", ["phase_3", "phase_16", "phase_0", "no_transfer", "bad_weighting", "bad_objective"])
def test_phase_validation_matches_jax(models, call):
    """``distill_phase``'s grid checks, ``distill`` without transfer steps
    across objectives, the constructor's checks: JAX's errors."""
    model, jmodel, _jd = models[False]

    def run(cls, target):
        if call == "bad_weighting":
            return cls(target, loss_weighting="snr")
        if call == "bad_objective":
            return cls(target, student_objective="pred_eps")
        d = cls(target)
        if call == "no_transfer":
            return d.distill(iter(()), 4, 1, *([] if cls is ProgressiveDistiller else [jax.random.PRNGKey(0)]))
        steps = int(call.split("_")[1])
        return d.distill_phase(target.params, "pred_noise", steps, iter(()), 1,
                               *([] if cls is ProgressiveDistiller else [jax.random.PRNGKey(0)]))

    with pytest.raises(ValueError) as ours:
        run(ProgressiveDistiller, model)
    with pytest.raises(ValueError) as ref:
        run(JProgressiveDistiller, jmodel)
    assert str(ours.value) == str(ref.value)


def _labeled_batches(seed=0):
    while True:
        yield _batch(True, seed)
        seed += 1


@pytest.mark.parametrize("student_objective, expect", [("pred_v", [True, False, False]), ("pred_noise", [True, False])])
def test_guidance_is_absorbed_exactly_once(models, monkeypatch, student_objective, expect):
    """Only the recipe's first stage wraps the teacher in the guided
    combination: later teachers are students that absorbed w (JAX
    ``tests/test_distillation.py``'s spy, on the port's ``init_state``)."""
    model = models[True][0]
    pd = ProgressiveDistiller(model, student_objective=student_objective, learning_rate=LR, guidance_scale=W)
    seen, init = [], pd.init_state

    def spy(teacher, teacher_objective=None, stride=1, substeps=1, guided=False):
        seen.append(guided)
        return init(teacher, teacher_objective, stride, substeps, guided)

    monkeypatch.setattr(pd, "init_state", spy)
    params, history = pd.distill(_labeled_batches(), final_steps=4, steps_per_phase=1, transfer_steps=1,
                                 log_every=1, graphs=False)
    assert seen == expect and list(history)[-1] == "N=4"
    assert all(bool(torch.isfinite(v).all()) for v in params.values())
    out = pd.student_model(params, 4).sample(2, IMG, generator=torch.Generator().manual_seed(2), label=1)
    assert out.shape == (2, IMG, IMG, 3) and bool(torch.isfinite(out).all())


def test_recipe_chains_its_phases_and_releases_their_graphs(models):
    """``distill`` = transfer, then each phase from the last one's student,
    on the run's draws in order (the same as the stages run by hand); each
    stage captures its own graph, which goes with its phase."""
    model = models[False][0]
    gen = torch.Generator().manual_seed(4)
    pd = ProgressiveDistiller(model, learning_rate=LR)
    shape = (B, IMG, IMG, 3)
    stages = [pd.init_state(model.params, "pred_noise", 1, 1), pd.init_state(model.params, "pred_v", 2, 2),
              pd.init_state(model.params, "pred_v", 4, 2)]
    draws = [pd.draw_inputs(s, shape, gen) for s in stages for _ in range(2)]
    batches = [_batch(False, i) for i in range(6)]
    params, history = pd.distill(iter(batches), final_steps=4, steps_per_phase=2, transfer_steps=2, log_every=1,
                                 draws=draws, graphs=True)
    assert list(history) == ["transfer", "N=8", "N=4"] and all(len(v) == 2 for v in history.values())
    assert [g["name"] for g in pd.graph_log] == ["distill_step"] * 3 and all(g["replays"] == 1 for g in pd.graph_log)
    hand = ProgressiveDistiller(model, learning_rate=LR)
    teacher, objective = model.params, "pred_noise"
    for i, (stride, substeps) in enumerate(((1, 1), (2, 2), (4, 2))):
        state = hand.init_state(teacher, objective, stride, substeps)
        for j in (2 * i, 2 * i + 1):
            hand.train_step(state, batches[j], draws[j], graphs=False)
        teacher, objective = {k: v.detach() for k, v in state.student.items()}, "pred_v"
    assert all(torch.equal(teacher[k], params[k]) for k in params)


def test_guidance_refusals_and_mesh(models):
    """``guidance_scale`` needs a class-conditional teacher: an
    unconditional or a text-conditional one is refused with JAX's message;
    ``mesh=`` is not ported."""
    model, jmodel, _jd = models[False]
    with pytest.raises(ValueError) as ref:
        JProgressiveDistiller(jmodel, guidance_scale=W)
    text = _text_teacher()
    for teacher in (model, text):
        with pytest.raises(ValueError) as ours:
            ProgressiveDistiller(teacher, guidance_scale=W)
        assert str(ours.value) == str(ref.value) and "text-conditional" in str(ours.value)
    with pytest.raises(ValueError, match="no guidance_scale"):
        ProgressiveDistiller(model).init_state(model.params, guided=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        ProgressiveDistiller(model, mesh=object())


def _text_teacher():
    return TextConditionalDDPM(load_config(TEXT_YAML, overrides=TEXT_TINY).model, device="cpu", seed=0)


@pytest.mark.parametrize("recipe", ["progressive", "consistency"])
def test_text_teacher_distils_on_its_captions(recipe):
    """A text-conditional teacher (refused only under guidance, as in JAX,
    whose step hands the whole batch to the model function) distils on its
    batch's captions: the captured step, run eagerly here, reads the caption
    tokens as the eager step does, bit for bit over two updates (a graph
    that dropped them would run on the null context), and the loss moves
    with the captions."""
    model = _text_teacher()
    gen = torch.Generator().manual_seed(5)
    # off its zero-initialized projections, so that the captions reach the output
    model.params = {k: v + 0.05 * torch.randn(v.shape, generator=gen) for k, v in model.params.items()}
    if recipe == "progressive":
        d = ProgressiveDistiller(model, learning_rate=LR)
        new_state = lambda: d.init_state(model.params, model.sampler.objective, 2, 2)  # noqa: E731
    else:
        d = ConsistencyDistiller(model, grid_steps=4, learning_rate=LR)
        new_state = d.init_state
    rng = np.random.default_rng(6)
    batches = [{"image": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
                "tokens": model.tokenizer.encode_batch(["a red square", "a blue circle"])} for _ in range(2)]
    draws = [d.draw_inputs(new_state(), (B, IMG, IMG, 3), gen) for _ in batches]
    runs = []
    for graphs in (True, False):
        state = new_state()
        runs.append((state, [float(d.train_step(state, b, dr, graphs=graphs)) for b, dr in zip(batches, draws)]))
    (captured, losses), (eager, eager_losses) = runs
    assert captured.graphs and not eager.graphs and losses == eager_losses
    assert all(torch.equal(captured.student[k], eager.student[k]) for k in captured.student)
    other = {**batches[0], "tokens": model.tokenizer.encode_batch(["a green tree", "two cats"])}
    null = {"image": batches[0]["image"]}
    with torch.no_grad():
        by_caption = [float(d.loss(new_state(), b, draws[0])) for b in (batches[0], other, null)]
    assert by_caption[0] == losses[0] and len(set(by_caption)) == 3


# ------------------------------------------------------------ the student ------
def test_student_model_and_its_archive_in_both_packages(models, tmp_path):
    """``student_model`` writes the N-step η = 0 DDIM in the student's
    objective into the teacher's config, as JAX's does; a student archive
    of either package restores in the other with the same sampler and
    weights, and samples with its own sampler."""
    model, jmodel, jd = models[False]
    pd = ProgressiveDistiller(model, learning_rate=LR)
    params = {k: v + 0.01 for k, v in model.params.items()}
    student = pd.student_model(params, 4)
    jstudent = jd.student_model(jax.tree.map(jnp.asarray, to_flax_params(params, model.diffusion_model)), 4)
    assert dict(student.cfg.sampler) == dict(jstudent.cfg["sampler"])
    assert type(student).__name__ == "DDPM" and student.sampler.ddim_timesteps == 4
    assert student.sampler.objective == "pred_v" and model.cfg.sampler.get("ddim_timesteps") is None
    assert all(torch.equal(student.params[k], params[k]) and torch.equal(student.ema_params[k], params[k])
               for k in params)

    jback = j_restore(student.save_to(str(tmp_path / "port.dmn")))
    assert dict(jback.cfg["sampler"]) == dict(jstudent.cfg["sampler"])
    restored = from_flax_params(jax.tree.map(np.asarray, jback.params), model.diffusion_model)
    assert all(torch.equal(restored[k], params[k]) for k in params)
    back = restore_model_from_archive(jstudent.save_to(str(tmp_path / "jax.dmn")), use_ema=True, device="cpu")
    assert type(back).__name__ == "DDPM" and dict(back.cfg.sampler) == dict(student.cfg.sampler)
    assert type(back.sampler).__name__ == "GeneralizedGaussianDiffusion" and back.sampler.ddim_timesteps == 4
    assert all(torch.equal(back.params[k], params[k]) for k in params)
    out = back.sample(2, IMG, generator=torch.Generator().manual_seed(1))
    assert out.shape == (2, IMG, IMG, 3) and bool(torch.isfinite(out).all())


def test_distill_cli_train_distill_eval(tmp_path):
    """``train_ddpm`` (2 steps) → ``distill_ddpm`` (the ε → v transfer and
    halvings to 4 steps) → ``eval_ddpm`` with the archive's own sampler
    (``use_ddim_sampler=false``); ``devices=2`` refused."""
    _model, trainer = train_ddpm.main([
        "--config-path=examples/configs/ddpm", "--config-name=unet_small.yaml", *TINY, "trainer.accelerator=cpu",
        "trainer.max_steps=2", "model.compute_bpd=false", f"exp_manager.exp_dir={tmp_path / 'exp'}",
        "exp_manager.create_tensorboard_logger=false", f"+model.results_dir={tmp_path / 'results'}"])
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    student, history = distill_ddpm.main([
        f"model_path={dmn}", f"output_path={tmp_path / 'student.dmn'}", "final_steps=4", "steps_per_phase=2",
        "transfer_steps=2", "batch_size=4", "dataset_name=synthetic", "dataset_length=16", "log_every=1",
        "device=cpu"])
    assert list(history) == ["transfer", "N=8", "N=4"] and all(np.isfinite(v).all() for v in history.values())
    back = restore_model_from_archive(str(tmp_path / "student.dmn"), device="cpu")
    assert back.sampler.ddim_timesteps == 4 and back.sampler.objective == "pred_v"
    out = eval_ddpm.main([f"model_path={tmp_path / 'student.dmn'}", "batch_size=2", "use_ddim_sampler=false",
                          f"output_dir={tmp_path / 'samples'}", "add_timestamp=false", "device=cpu"])
    assert (out / "samples_grid.png").is_file() and len(list(out.glob("sample_*.png"))) == 2
    with pytest.raises(NotImplementedError, match="devices=2"):
        distill_ddpm.main([f"model_path={dmn}", "devices=2", "device=cpu"])
