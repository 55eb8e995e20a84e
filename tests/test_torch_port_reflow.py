"""The port's reflow (``training/reflow.py``) and the rectified-flow CLIs
on the CPU, against the JAX package where it has the same function.

The teacher is ``examples/configs/rectified_flow/unet_small.yaml`` cut to a
tiny float32 U-Net (dim 8, dim_mults [1, 2], 8 px), its pairs from a grid
of M = 4; the JAX model gets the port's weights. The JAX fused step
(``ReflowTrainer._build_step``) is compiled once and fed the same
latents, with t drawn as JAX draws it (``fold_in(key, 1)``); two rounds
replay the draws of JAX's ``reflow`` loop (z from numpy seeded by the key,
a split a step).

Tolerances: a loss before any update 1e-5 relative (one network call on
the teacher chain's pairs); a loss after updates 1e-3 relative (the
chains'); the student's parameters after the updates 2e-4 relative L2
(the whole network's). A loss after updates is looser because AdamW's
first steps normalize each gradient element: the biases before a
GroupNorm have an analytically zero gradient, and each package's rounding
noise there becomes a step of ±lr (tiny U-Net, lr 1e-3: those biases move
apart by up to 1e-3, and the round-2 losses by 2.2e-4 relative). The
captured step, run eagerly on the CPU, equals the eager step bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import RectifiedFlow as JRectifiedFlow
from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore
from diffusion_model_nemo_tpu.training.reflow import ReflowTrainer as JReflowTrainer
from diffusion_model_nemo_tpu_torch.cli import (eval_rectified_flow, reflow_rectified_flow, test_rectified_flow,
                                                train_rectified_flow)
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import DDPM, RectifiedFlow, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules import RectifiedFlowProcess
from diffusion_model_nemo_tpu_torch.training import ReflowTrainer
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/rectified_flow/unet_small.yaml"
M, IMG, B, LR = 4, 8, 2, 1e-3
SHAPE = (B, IMG, IMG, 3)
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={M}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=16",
]
LOSS_TOL = 1e-5  # relative, before any update
UPDATED_LOSS_TOL = 1e-3  # relative, after updates
WHOLE_TOL = 2e-4  # the whole network's parameters, relative L2


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
    """(the JAX model and trainer with its fused step compiled once, the port model)."""
    model = RectifiedFlow(load_config(YAML, overrides=TINY).model, device="cpu", seed=0)
    jmodel = JRectifiedFlow(cfg=j_load_config(YAML, overrides=TINY).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    jt = JReflowTrainer(jmodel, pair_steps=M, learning_rate=LR)
    student = jax.tree.map(jnp.copy, jmodel.params)
    args = (student, jt._tx.init(student), jmodel.params, jnp.zeros(SHAPE, jnp.float32), jax.random.PRNGKey(0))
    jt._step = jt._build_step().lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})
    return jmodel, jt, model


def _flat(params, net) -> np.ndarray:
    """The port's parameters in the flax tree's leaf order."""
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(to_flax_params(params, net))])


def _jflat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(a)) for a in jax.tree.leaves(tree)])


def _jax_time(key) -> torch.Tensor:
    """t's uniform draw as the JAX step takes it: ``fold_in(key, 1)``."""
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 1), (B,), jnp.float32)))


def test_fused_step_matches_jax(pair):
    """One step from the same z (the teacher's 4-step chain, the path
    point, the student's MSE, the clip, AdamW) against JAX's compiled
    ``_build_step``: the loss and the student after the update; the captured
    step equals the eager one bit for bit; the teacher is untouched."""
    jmodel, jt, model = pair
    z = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(9)
    student = jax.tree.map(jnp.copy, jmodel.params)
    jstudent, _opt, jloss = jt._step(student, jt._tx.init(student), jmodel.params, jnp.asarray(z), key)
    rt = ReflowTrainer(model, pair_steps=M, learning_rate=LR)
    before = {k: v.clone() for k, v in model.params.items()}
    states = [rt.init_state(model.params) for _ in range(2)]
    losses = [rt.train_step(s, torch.from_numpy(z), _jax_time(key), graphs=g) for s, g in zip(states, (True, False))]
    assert torch.equal(losses[0], losses[1])
    assert all(torch.equal(states[0].student[k], states[1].student[k]) for k in before)
    assert all(torch.equal(model.params[k], before[k]) for k in before)
    assert states[0].opt_state["count"] == 1 and rt.graphs
    np.testing.assert_allclose(float(losses[0]), float(jloss), rtol=LOSS_TOL)
    ours = _flat(states[0].student, model.diffusion_model)
    assert _rel_l2(ours, _jflat(jstudent)) < WHOLE_TOL
    moved = ours - _flat(before, model.diffusion_model)
    assert np.abs(moved).max() > 0.5 * LR  # an AdamW step of lr moved the student


def _jax_reflow_draws(key, rounds, steps):
    """The JAX ``reflow`` loop's (z, t draw) a step: z from numpy seeded
    by the key's last word, t from ``fold_in`` of the step's split."""
    rng = np.random.default_rng(int(jax.random.key_data(key).ravel()[-1]))
    out = []
    for _ in range(rounds * steps):
        key, sub = jax.random.split(key)
        out.append((torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)), _jax_time(sub)))
    return out


def test_two_rounds_match_jax_and_round_two_learns_from_round_one(pair):
    """Two rounds of two steps against JAX's ``reflow`` with its draws: the
    losses and the last student; round 2's teacher is round 1's student (a
    round run by hand from it gives the same student bit for bit, one from
    the first teacher does not)."""
    jmodel, jt, model = pair
    key = jax.random.PRNGKey(3)
    jparams, jlosses = jt.reflow(steps=2, batch_size=B, key=key, rounds=2, log_every=1)
    draws = _jax_reflow_draws(key, 2, 2)
    rt = ReflowTrainer(model, pair_steps=M, learning_rate=LR)
    params, losses = rt.reflow(steps=2, batch_size=B, rounds=2, log_every=1, draws=draws)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=LOSS_TOL)
    np.testing.assert_allclose(losses, jlosses, rtol=UPDATED_LOSS_TOL)
    assert _rel_l2(_flat(params, model.diffusion_model), _jflat(jparams)) < WHOLE_TOL

    def one_round(teacher, pairs):
        state = rt.init_state(teacher)
        for z, u in pairs:
            rt.train_step(state, z, u, graphs=False)
        return {k: v.detach() for k, v in state.student.items()}

    first = one_round(model.params, draws[:2])
    second, from_first_teacher = one_round(first, draws[2:]), one_round(model.params, draws[2:])
    assert all(torch.equal(second[k], params[k]) for k in params)
    assert not all(torch.equal(from_first_teacher[k], params[k]) for k in params)


class _AnalyticModel:
    """The surface ``ReflowTrainer`` uses, with the exact single-point field
    v(x, t) = (x − x0*)/t (tests/test_reflow.py)."""

    def __init__(self, x0_star):
        self.sampler = RectifiedFlowProcess(sample_steps=6, device="cpu")
        self.image_size, self.channels, self.device = IMG, 1, torch.device("cpu")
        self.diffusion_model = None
        self._x0s = torch.as_tensor(x0_star)
        self.params = {"w": torch.zeros(())}

    def train_model_fn(self, params, x, t_net):
        t = (t_net / self.sampler.time_scale).reshape((-1,) + (1,) * (x.ndim - 1))
        return (x - self._x0s) / torch.clamp_min(t, 1e-6) + 0.0 * params["w"]


def test_reflow_loss_is_zero_on_the_analytic_field():
    """On the single-point field the pairs are exact and the field is the
    regression's minimizer: the fused step's loss is ~0 (lr 0), captured
    and eager."""
    model = _AnalyticModel(np.full((1, IMG, IMG, 1), 0.3, np.float32))
    for graphs in (True, False):
        _p, losses = ReflowTrainer(model, learning_rate=0.0).reflow(steps=2, batch_size=4, log_every=1,
                                                                     graphs=graphs)
        assert len(losses) == 2 and max(losses) < 1e-6, losses


def test_student_model_and_its_archive_in_both_packages(pair, tmp_path):
    """``student_model`` writes ``sample_steps`` into the config and gives
    the student's weights to both ``params`` and ``ema_params``; its archive
    restores in both packages as a one-step ``RectifiedFlow``; ``mesh=`` is
    not ported."""
    _jmodel, _jt, model = pair
    rt = ReflowTrainer(model, pair_steps=2, learning_rate=LR)
    params, _ = rt.reflow(steps=1, batch_size=B, generator=torch.Generator().manual_seed(0), log_every=0)
    student = rt.student_model(params, sample_steps=1)
    assert student.sampler.sample_steps == 1 and student.cfg.sampler.sample_steps == 1
    assert model.sampler.sample_steps == M and model.cfg.sampler.sample_steps == M
    assert all(torch.equal(student.params[k], params[k]) and torch.equal(student.ema_params[k], params[k])
               for k in params)
    path = student.save_to(str(tmp_path / "rf1.dmn"))
    back = restore_model_from_archive(path, use_ema=True, device="cpu")
    assert type(back) is RectifiedFlow and back.sampler.sample_steps == 1
    jback = j_restore(path)
    assert type(jback).__name__ == "RectifiedFlow" and jback.sampler.sample_steps == 1
    restored = from_flax_params(jax.tree.map(np.asarray, jback.params), model.diffusion_model)
    assert all(torch.equal(restored[k], params[k]) for k in params)
    out = back.sample(2, IMG, generator=torch.Generator().manual_seed(4))
    assert out.shape == (2, IMG, IMG, 3) and bool(torch.isfinite(out).all())
    with pytest.raises(NotImplementedError, match="not ported"):
        ReflowTrainer(model, mesh=object())


def test_rectified_flow_clis_train_eval_test_and_reflow(tmp_path):
    """``train_rectified_flow`` (2 steps, a sample dump and bits/dim at step
    2, the archive), ``eval_rectified_flow`` (the solver and grid swaps,
    the trajectory's GIF), ``test_rectified_flow`` (the loss, the exact
    bits/dim, NFE M) and ``reflow_rectified_flow`` (two rounds into a
    one-step archive; other families' archives and ``devices=2`` refused)."""
    model, trainer = train_rectified_flow.main([
        *TINY, "trainer.accelerator=cpu", "trainer.max_steps=2", "model.save_every=2", "model.compute_bpd=true",
        f"+model.results_dir={tmp_path / 'results'}", f"exp_manager.exp_dir={tmp_path / 'exp'}",
        "exp_manager.create_tensorboard_logger=false"])
    assert type(model) is RectifiedFlow and all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    assert (tmp_path / "results" / "sample-1-1.png").is_file()
    (dmn,) = (tmp_path / "exp").glob("*/*/RectifiedFlow-UNet.dmn")

    out = eval_rectified_flow.main([f"model_path={dmn}", "batch_size=4", "device=cpu", "solver=heun", "num_steps=3",
                                    "show_diffusion=true", f"output_dir={tmp_path / 'samples'}",
                                    "add_timestamp=false"])
    assert sorted(p.name for p in out.iterdir()) == ["diffusion.gif", *(f"sample_{i}.png" for i in range(4)),
                                                     "samples_grid.png"]
    result = test_rectified_flow.main([f"model_path={dmn}", "batch_size=4", "limit_test_batches=1", "device=cpu",
                                       "dataset_name=synthetic"])
    assert sorted(result) == ["avg_num_forward_evaluations", "test_fm_loss", "test_total_bpd"]
    assert result["avg_num_forward_evaluations"] == M and np.isfinite(result["test_total_bpd"])

    student, losses = reflow_rectified_flow.main([
        f"model_path={dmn}", f"output_path={tmp_path / 'rf1.dmn'}", "steps=2", "rounds=2", "batch_size=2",
        "pair_steps=2", "log_every=1", "device=cpu"])
    assert len(losses) == 4 and np.isfinite(losses).all()
    back = RectifiedFlow.restore_from(str(tmp_path / "rf1.dmn"), device="cpu")
    assert back.sampler.sample_steps == 1 and all(torch.equal(back.params[k], student.params[k])
                                                  for k in student.params)
    ddpm = DDPM(load_config(REPO / "examples/configs/ddpm/unet_small.yaml", overrides=TINY).model, device="cpu")
    with pytest.raises(ValueError, match="RectifiedFlow archives"):
        reflow_rectified_flow.main([f"model_path={ddpm.save_to(str(tmp_path / 'ddpm.dmn'))}", "device=cpu"])
    with pytest.raises(NotImplementedError, match="devices=2"):
        reflow_rectified_flow.main([f"model_path={dmn}", "devices=2", "device=cpu"])
