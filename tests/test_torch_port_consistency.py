"""The port's consistency distillation (``training/consistency.py``), its
sampler (``modules/consistency_sampler.py``) and ``consistency_ddpm`` on the
CPU, against the JAX package where it has the same function.

The teacher is ``examples/configs/ddpm/unet_small.yaml`` cut to a tiny
float32 U-Net (dim 8, dim_mults [1, 2], 8 px, T = 16); the JAX model gets
the port's weights (``utils/weights.py:to_flax_params``). Each JAX fused
step (``ConsistencyDistiller._build_step``) is compiled once a module, and
the port's step is fed the draws JAX derives inside it from the same key
(its flip, n and z), on the same uint8 batch. The sampler's chain gets
JAX's initial image and re-noise draws.

Tolerances: the head, the teacher's Heun / Euler step and the sampler's
chain 1e-5 relative L2; a loss before any update 1e-5 relative, after an
update 1e-3 (where the step's draws put the student's head at σ_max, where
the two heads are close and the loss is a small difference of large terms:
the same tolerances times the heads' mean square, absolute); the student and the EMA target after two updates 2e-4 relative
L2 (the whole network's: AdamW's first steps turn each package's rounding
noise on an analytically zero gradient into a step of ±lr). The captured
step and chain, run eagerly on the CPU, equal the eager ones bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import DDPM as JDDPM
from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore
from diffusion_model_nemo_tpu.modules.consistency_sampler import ConsistencySampler as JConsistencySampler
from diffusion_model_nemo_tpu.training.consistency import ConsistencyDistiller as JConsistencyDistiller
from diffusion_model_nemo_tpu_torch.cli import consistency_ddpm, eval_ddpm, train_ddpm
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.data import preprocess_batch
from diffusion_model_nemo_tpu_torch.models import DDPM, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules import ConsistencySampler
from diffusion_model_nemo_tpu_torch.training import ConsistencyDistiller
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/ddpm/unet_small.yaml"
T, IMG, B, N, LR, MU = 16, 8, 2, 5, 1e-3, 0.95
SHAPE = (B, IMG, IMG, 3)
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=16",
]
TOL = 1e-5  # the head, the teacher's step, the chain: relative L2
LOSS_TOL = 1e-5  # relative, before any update
UPDATED_LOSS_TOL = 1e-3  # relative, after an update
WHOLE_TOL = 2e-4  # the whole network's parameters, relative L2
COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
KW = {"grid_steps": N, "ema_decay": MU, "learning_rate": LR}
# case: (mode, teacher order, loss)
CASES = {"cd_heun_l2": ("distill", 2, "l2"), "ct_pseudo_huber": ("train", 2, "pseudo_huber")}
# run: (case, the JAX keys of its two steps, the loss checked on the heads' scale)
RUNS = {
    "cd_heun_l2": ("cd_heun_l2", (2, 8), False),  # transitions n = [3, 1], [2, 1]
    "ct_pseudo_huber": ("ct_pseudo_huber", (2, 8), False),
    # n = [0, 0], [1, 0]: the student's head at σ_max, the level the one-step
    # student samples from. The two heads there are close, so the loss is a
    # small difference of large terms; its check is absolute, on their scale.
    "cd_heun_l2_sigma_max": ("cd_heun_l2", (1, 3), True),
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


@pytest.fixture(scope="module")
def pair():
    """(the port model, the JAX model with the port's weights)."""
    model = DDPM(load_config(YAML, overrides=TINY).model, device="cpu", seed=0)
    jmodel = JDDPM(cfg=j_load_config(YAML, overrides=TINY).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    return model, jmodel


def _images(seed=0):
    return np.random.default_rng(seed).integers(0, 256, SHAPE, dtype=np.uint8)


def _flat(params, net) -> np.ndarray:
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(to_flax_params(params, net))])


def _jflat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(a)) for a in jax.tree.leaves(tree)])


def _levels(cd, seed=2):
    """[B] transitions n and their σ / t (float32), x̂ at σ_hi."""
    rng = np.random.default_rng(seed)
    n = np.asarray([0, N - 2], np.int64)
    sig, t = cd._sig.numpy(), cd._t.numpy()
    x = rng.uniform(-1, 1, SHAPE).astype(np.float32) + sig[n][:, None, None, None] * rng.standard_normal(
        SHAPE).astype(np.float32)
    return n, sig[n], t[n], sig[n + 1], t[n + 1], x


# ----------------------------------------------------------------- the head --
def test_head_and_grids_match_jax(pair):
    """The training grid's σ and times and the head's boundary equal JAX's;
    f(x̂, σ) at per-sample levels and at a scalar level within 1e-5; f(x̂,
    σ_min) = x̂ exactly."""
    model, jmodel = pair
    cd, jcd = ConsistencyDistiller(model, **KW), JConsistencyDistiller(jmodel, **KW)
    for ours, ref in zip(cd._grid_tables(), jcd._grid_tables()):
        np.testing.assert_array_equal(ours, ref)
    assert cd._head._sigma_floor() == jcd._head._sigma_floor()
    n, s_hi, t_hi, _s_lo, _t_lo, x = _levels(cd)
    fn, jfn = model.get_model_fn(training=True), jmodel.get_model_fn()
    head = lambda p, x, s, t: jcd._head.consistency_fn(jfn, p, x, s, t)  # noqa: E731  (eager: no compile)
    with torch.no_grad():
        ours = cd._head.consistency_fn(fn, model.params, torch.from_numpy(x), torch.from_numpy(s_hi)[:, None, None, None],
                                       torch.from_numpy(t_hi))
        scalar = cd._head.consistency_fn(fn, model.params, torch.from_numpy(x), float(s_hi[1]), float(t_hi[1]))
        smin = cd._head._sigma_floor()
        boundary = cd._head.consistency_fn(fn, model.params, torch.from_numpy(x), smin, 0.0)
    ref = head(jmodel.params, jnp.asarray(x), jnp.asarray(s_hi)[:, None, None, None], jnp.asarray(t_hi))
    ref_scalar = head(jmodel.params, jnp.asarray(x), jnp.float32(s_hi[1]), jnp.full((B,), t_hi[1], jnp.float32))
    assert _rel_l2(ours.numpy(), ref) < TOL and _rel_l2(scalar.numpy(), ref_scalar) < TOL
    assert torch.equal(boundary, torch.from_numpy(x))


@pytest.mark.parametrize("order", [1, 2])
def test_teacher_heun_step_matches_jax(pair, order):
    """One per-sample Heun (order 2) or Euler (order 1) step σ_hi → σ_lo."""
    model, jmodel = pair
    cd = ConsistencyDistiller(model, teacher_order=order, **KW)
    jcd = JConsistencyDistiller(jmodel, teacher_order=order, **KW)
    _n, s_hi, t_hi, s_lo, t_lo, x = _levels(cd, seed=3)
    jfn = jmodel.get_model_fn()
    ref = jcd.teacher_heun_step(jfn, jmodel.params, *(jnp.asarray(v) for v in (x, s_hi, t_hi, s_lo, t_lo)))
    with torch.no_grad():
        ours = cd.teacher_heun_step(model.get_model_fn(training=True), model.params,
                                    *(torch.from_numpy(v) for v in (x, s_hi, t_hi, s_lo, t_lo)))
    assert _rel_l2(ours.numpy(), ref) < TOL
    assert _rel_l2(ours.numpy(), x) > 1e-3  # it moved


# ------------------------------------------------------------ the fused step --
def _jax_draws(key):
    """The draws of the JAX step from its key: the flip, n and z."""
    k_pre, k_n, k_z = jax.random.split(key, 3)
    return {"flip": torch.from_numpy(np.array(jax.random.bernoulli(k_pre, 0.5, (B,)))),
            "n": torch.from_numpy(np.array(jax.random.randint(k_n, (B,), 0, N - 1, dtype=jnp.int32))),
            "z": torch.from_numpy(np.array(jax.random.normal(k_z, SHAPE, jnp.float32)))}


@pytest.fixture(scope="module")
def jax_steps(pair):
    """{case: (JAX's distiller, its fused step)}, the steps lowered in turn
    and compiled in threads (XLA compiles concurrently)."""
    _model, jmodel = pair
    lowered = {}
    for case, (mode, order, loss) in CASES.items():
        jcd = JConsistencyDistiller(jmodel, **KW, mode=mode, teacher_order=order, loss=loss)
        params = jax.tree.map(jnp.copy, jmodel.params)
        lowered[case] = (jcd, jcd._build_step().lower(params, params, jcd._tx.init(params), jmodel.params,
                                                      {"image": jnp.asarray(_images())}, jax.random.PRNGKey(0)))
    with ThreadPoolExecutor(len(lowered)) as pool:
        steps = pool.map(lambda low: low.compile(COMPILE), [low for _jcd, low in lowered.values()])
        return {case: (jcd, step) for (case, (jcd, _low)), step in zip(lowered.items(), steps)}


def _head_scale(cd, state, batch, draws) -> float:
    """The mean square of the student's head at the step's inputs (x̂ at
    σ_hi = σ_n): the scale of the two heads whose difference the loss
    squares."""
    x0 = preprocess_batch(batch, "cpu", flip=draws["flip"])["pixel_values"]
    n = draws["n"].long()
    sig = cd._sig.index_select(0, n)[:, None, None, None]
    with torch.no_grad():
        f = cd._head.consistency_fn(cd.model.get_model_fn(training=True), state.student, x0 + sig * draws["z"], sig,
                                    cd._t.index_select(0, n))
    return float(torch.mean(f * f))


@pytest.mark.parametrize("run", list(RUNS))
def test_consistency_step_matches_jax(pair, jax_steps, run):
    """Two updates (CD: the teacher's Heun step; CT: the same-z re-noise;
    the target's head, the student's head and loss, the clip, AdamW, the
    EMA target) against JAX's compiled step on its own draws: the losses,
    the student and the target; captured == eager bit for bit; the target
    after a step is μθ⁻ + (1 − μ)θ of the step's student; the teacher
    untouched. At σ_max the losses are held to JAX's within the same
    tolerances times the heads' mean square, absolute."""
    model, jmodel = pair
    case, key_ids, on_scale = RUNS[run]
    mode, order, loss = CASES[case]
    kw = dict(KW, mode=mode, teacher_order=order, loss=loss)
    jcd, step = jax_steps[case]
    batch = {"image": _images()}
    jbatch = {"image": jnp.asarray(batch["image"])}
    keys = [jax.random.PRNGKey(i) for i in key_ids]
    student, target = jax.tree.map(jnp.copy, jmodel.params), jax.tree.map(jnp.copy, jmodel.params)
    opt = jcd._tx.init(student)
    jlosses = []
    for key in keys:
        student, target, opt, jloss = step(student, target, opt, jmodel.params, jbatch, key)
        jlosses.append(float(jloss))

    cd = ConsistencyDistiller(model, **kw)
    before = {k: v.clone() for k, v in model.params.items()}
    draws = [_jax_draws(k) for k in keys]
    assert (0 in draws[0]["n"].tolist()) is on_scale
    runs, scales = [], []
    for graphs in (True, False):
        state = cd.init_state()
        losses = []
        for d in draws:
            prior = {k: v.clone() for k, v in state.target.items()}
            if graphs:
                scales.append(_head_scale(cd, state, batch, d))
            losses.append(float(cd.train_step(state, batch, d, graphs=graphs)))
            ema = {k: MU * prior[k] + (1.0 - MU) * state.student[k].detach() for k in prior}
            assert all(torch.equal(state.target[k], ema[k]) for k in ema)
        runs.append((state, losses))
    (captured, losses), (eager, eager_losses) = runs
    assert losses == eager_losses and captured.graphs and not eager.graphs
    assert all(torch.equal(captured.student[k], eager.student[k]) and torch.equal(captured.target[k], eager.target[k])
               for k in before)
    assert all(torch.equal(model.params[k], before[k]) for k in before)
    for i, tol in enumerate((LOSS_TOL, UPDATED_LOSS_TOL)):
        if on_scale:
            np.testing.assert_allclose(losses[i], jlosses[i], rtol=0, atol=tol * scales[i])
        else:
            np.testing.assert_allclose(losses[i], jlosses[i], rtol=tol)
    net = model.diffusion_model
    assert _rel_l2(_flat(captured.student, net), _jflat(student)) < WHOLE_TOL
    assert _rel_l2(_flat(captured.target, net), _jflat(target)) < WHOLE_TOL
    assert np.abs(_flat(captured.student, net) - _flat(before, net)).max() > 0.5 * LR


@pytest.mark.parametrize("kwargs", [{"loss": "l1"}, {"teacher_order": 3}, {"grid_steps": 1}, {"mode": "both"}])
def test_validation_matches_jax(pair, kwargs):
    model, jmodel = pair
    with pytest.raises(ValueError) as ours:
        ConsistencyDistiller(model, **kwargs)
    with pytest.raises(ValueError) as ref:
        JConsistencyDistiller(jmodel, **kwargs)
    assert str(ours.value) == str(ref.value)


def test_distill_runs_and_mesh_is_not_ported(pair):
    """``distill`` from the generator (student and target from the teacher,
    the losses logged), its graph released with the run; ``mesh=`` is not
    ported."""
    model, _jmodel = pair
    cd = ConsistencyDistiller(model, mode="train", loss="pseudo_huber", **KW)
    batches = iter([{"image": _images(i)} for i in range(3)])
    params, losses = cd.distill(batches, steps=3, generator=torch.Generator().manual_seed(1), log_every=1, graphs=True)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert [g["name"] for g in cd.graph_log] == ["consistency_step"] and cd.graph_log[0]["replays"] == 2
    assert not all(torch.equal(params[k], model.params[k]) for k in params)
    with pytest.raises(NotImplementedError, match="not ported"):
        ConsistencyDistiller(model, mesh=object())


# -------------------------------------------------------------- the sampler --
@pytest.mark.parametrize("steps", [1, 3])
def test_sampler_chain_matches_jax(pair, steps):
    """``p_sample_loop`` at K = 1 and 3 from JAX's initial image and its
    re-noise draws (one a further level): within 1e-5, frames in [0, 1];
    the captured chain equals the eager one."""
    model, jmodel = pair
    kw = dict(timesteps=T, schedule_name="cosine", sample_steps=steps)
    sampler, jsampler = ConsistencySampler(**kw, device="cpu"), JConsistencySampler(**kw)
    rng = np.random.default_rng(5)
    img = (rng.standard_normal(SHAPE) * sampler._consistency_sigmas()[0][0]).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jfn = jmodel.get_model_fn()
    ref = jsampler.p_sample_loop(jfn, jmodel.params, SHAPE, key, img=jnp.asarray(img))
    key, _init = jax.random.split(key)
    noise = []
    for _ in range(steps - 1):
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.normal(sub, (B, IMG * IMG * 3), jnp.float32)).reshape(SHAPE))
    noise = torch.from_numpy(np.stack(noise)) if noise else None
    fn = model.get_model_fn()
    with torch.inference_mode():
        (out, frames), eager = (sampler.p_sample_loop(fn, model.params, SHAPE, img=torch.from_numpy(img), noise=noise,
                                                      graphs=g, return_frames=f) for g, f in ((True, True), (False, False)))
    assert _rel_l2(out.numpy(), ref) < TOL and torch.equal(out, eager)
    assert frames.shape == (steps, *SHAPE) and torch.equal(frames[-1], out)
    assert float(frames.min()) >= 0.0 and float(frames.max()) <= 1.0
    assert sampler.graphs
    with mock.patch.object(sampler, "_sigma_grid", side_effect=AssertionError("read the schedule")), \
            torch.inference_mode():
        again = sampler.p_sample_loop(fn, model.params, SHAPE, img=torch.from_numpy(img), noise=noise, graphs=True)
        drawn = sampler.p_sample_loop(fn, model.params, SHAPE, torch.Generator().manual_seed(0), graphs=True)
    # a replay reads no schedule on the host (a capture cannot copy it there),
    # nor does a call that draws its initial image at σ_max (a sync a call)
    assert torch.equal(again, out) and drawn.shape == SHAPE and bool(torch.isfinite(drawn).all())
    with pytest.raises(ValueError, match="noise must be"):
        sampler.p_sample_loop(fn, model.params, SHAPE, img=torch.from_numpy(img), noise=torch.zeros((steps, *SHAPE)))


# -------------------------------------------------------------- the student --
def test_student_model_and_its_archive_in_both_packages(pair, tmp_path):
    """``student_model`` writes the ``ConsistencySampler`` at
    ``sample_steps`` (σ_d, ρ, σ bounds carried, DDIM's keys dropped) into
    the teacher's config, as JAX's does; a student archive of either
    package restores in the other with the same sampler and weights, and
    samples with it."""
    model, jmodel = pair
    kw = dict(KW, sigma_data=0.4, rho=5.0, sigma_max=20.0)
    cd, jcd = ConsistencyDistiller(model, **kw), JConsistencyDistiller(jmodel, **kw)
    params = {k: v + 0.01 for k, v in model.params.items()}
    student = cd.student_model(params, sample_steps=2)
    jstudent = jcd.student_model(jax.tree.map(jnp.asarray, to_flax_params(params, model.diffusion_model)), 2)
    assert dict(student.cfg.sampler) == dict(jstudent.cfg["sampler"])
    assert type(student.sampler) is ConsistencySampler and student.sampler.sample_steps == 2
    assert (student.sampler.sigma_data, student.sampler.rho, student.sampler.sigma_max) == (0.4, 5.0, 20.0)
    assert all(torch.equal(student.ema_params[k], params[k]) for k in params)

    jback = j_restore(student.save_to(str(tmp_path / "port.dmn")))
    assert dict(jback.cfg["sampler"]) == dict(jstudent.cfg["sampler"])
    assert type(jback.sampler).__name__ == "ConsistencySampler" and jback.sampler.sample_steps == 2
    restored = from_flax_params(jax.tree.map(np.asarray, jback.params), model.diffusion_model)
    assert all(torch.equal(restored[k], params[k]) for k in params)
    back = restore_model_from_archive(jstudent.save_to(str(tmp_path / "jax.dmn")), use_ema=True, device="cpu")
    assert type(back.sampler) is ConsistencySampler and dict(back.cfg.sampler) == dict(student.cfg.sampler)
    assert all(torch.equal(back.params[k], params[k]) for k in params)
    out = back.sample(2, IMG, generator=torch.Generator().manual_seed(1))
    assert out.shape == (2, IMG, IMG, 3) and bool(torch.isfinite(out).all())


def test_consistency_cli_train_distill_eval(tmp_path):
    """``train_ddpm`` (2 steps) → ``consistency_ddpm`` (2 CD steps on a
    4-level grid, a 2-step student) → ``eval_ddpm`` with the archive's own
    sampler (``use_ddim_sampler=false``); ``devices=2`` refused."""
    _model, trainer = train_ddpm.main([
        "--config-path=examples/configs/ddpm", "--config-name=unet_small.yaml", *TINY, "trainer.accelerator=cpu",
        "trainer.max_steps=2", "model.compute_bpd=false", f"exp_manager.exp_dir={tmp_path / 'exp'}",
        "exp_manager.create_tensorboard_logger=false", f"+model.results_dir={tmp_path / 'results'}"])
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    student, losses = consistency_ddpm.main([
        f"model_path={dmn}", f"output_path={tmp_path / 'cd.dmn'}", "steps=2", "grid_steps=4", "sample_steps=2",
        "batch_size=4", "dataset_name=synthetic", "dataset_length=16", "log_every=1", "device=cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    back = restore_model_from_archive(str(tmp_path / "cd.dmn"), device="cpu")
    assert type(back.sampler) is ConsistencySampler and back.sampler.sample_steps == 2
    assert all(torch.equal(back.params[k], student.params[k]) for k in student.params)
    out = eval_ddpm.main([f"model_path={tmp_path / 'cd.dmn'}", "batch_size=2", "use_ddim_sampler=false",
                          f"output_dir={tmp_path / 'samples'}", "add_timestamp=false", "device=cpu"])
    assert (out / "samples_grid.png").is_file() and len(list(out.glob("sample_*.png"))) == 2
    with pytest.raises(NotImplementedError, match="devices=2"):
        consistency_ddpm.main([f"model_path={dmn}", "devices=2", "device=cpu"])
