"""The port's training step as a CUDA graph and ``steps_per_execution``, on
the CPU (``graphs=True`` on the CPU runs the captured step function
eagerly, its batch and draws staged into static buffers).

- The optimizer's and the EMA's per-step scalars read from rows of float32
  tables give the bits of the Python-float update; the tables grow past
  ``init_state``'s ``max_steps`` as the steps go on.
- ``steps_per_execution = K`` equals single steps bit for bit, logs where
  the JAX trainer's ``_crossed`` rule logs, groups batches as the JAX
  trainer does, and places the loader as its fast-forward rule does.
- A replay of the training step bumps the versions of what it writes; the
  state holds its graph.

The sampling loops' graphs are tests/test_torch_port_graphs.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.training.trainer import Trainer as JTrainer
from diffusion_model_nemo_tpu_torch import DDPM, Trainer
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.data import hf_vision_data as TD
from diffusion_model_nemo_tpu_torch.training import build_optimizer, ema_decay_table, ema_update
from diffusion_model_nemo_tpu_torch.training.ema import ema_decay_at

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/ddpm/unet_small.yaml"
TINY = [
    "model.image_size=8", "model.timesteps=10", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=16",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0):
    return DDPM(load_config(YAML, overrides=TINY).model, device="cpu", seed=seed)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------- optimizer and EMA tables --
def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "b.weight": (2, 2, 3, 3)}
    return {k: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)) for k, s in shapes.items()}


def _python_float_adam(opt, p, g, mu, nu, count):
    """The update as the port computed it with Python-float scalars before
    the tables (clip, moments, bias corrections, AdamW decay, -lr)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(g.values()))))
    keep, one = norm < opt.grad_clip, torch.ones_like(norm)
    div, mul = torch.where(keep, one, norm), torch.where(keep, one, torch.full_like(norm, opt.grad_clip))
    keys = list(p)
    gs = torch._foreach_mul(torch._foreach_div([g[k] for k in keys], div), mul)
    ps, ms, vs = [p[k] for k in keys], [mu[k] for k in keys], [nu[k] for k in keys]
    lr = opt.schedule(count)
    torch._foreach_mul_(ms, opt.b1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - opt.b1))
    torch._foreach_mul_(vs, opt.b2)
    torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - opt.b2))
    m_hat = torch._foreach_div(ms, 1.0 - opt.b1 ** (count + 1))
    v_hat = torch._foreach_div(vs, 1.0 - opt.b2 ** (count + 1))
    upd = torch._foreach_div(m_hat, torch._foreach_add(torch._foreach_sqrt(v_hat), opt.eps))
    if opt.weight_decay:
        torch._foreach_add_(upd, torch._foreach_mul(ps, opt.weight_decay))
    torch._foreach_add_(ps, torch._foreach_mul(upd, -lr))


_OPTIMS = {
    "unet_small": load_config(YAML).model.optim,
    "warmup_cosine": dict(name="adamw", lr=2e-3, weight_decay=0.01,
                          sched=dict(name="CosineAnnealing", warmup_steps=2, min_lr=1e-5)),
    "constant_adam": dict(name="adam", lr=3e-4, sched=None),
}


@pytest.mark.parametrize("name", sorted(_OPTIMS))
def test_tabled_optimizer_scalars_give_the_python_float_update(name):
    """Six updates with -lr and the bias corrections read from rows of the
    float32 table, against the Python-float arithmetic:
    parameters and moments bit for bit (the CPU divides by the tabled
    correction as by the Python float; chip_smoke checks the card, where
    the table holds the reciprocal). Exact."""
    opt, _ = build_optimizer(_OPTIMS[name], 6, grad_clip=1.0)
    p_ref, p_tab = _leaves(3), _leaves(3)
    mu = {k: torch.zeros_like(v) for k, v in p_ref.items()}
    nu = {k: torch.zeros_like(v) for k, v in p_ref.items()}
    state = opt.init(p_tab)
    table = opt.table(5, "cpu")
    for i in range(6):
        g = _leaves(100 + i, scale=0.4 if i % 2 else 0.05)
        _python_float_adam(opt, p_ref, g, mu, nu, i)
        opt.step(p_tab, g, state, scalars=table[i])
        for k in p_ref:
            assert torch.equal(p_ref[k], p_tab[k]) and torch.equal(mu[k], state["mu"][k]), (i, k)
            assert torch.equal(nu[k], state["nu"][k]), (i, k)
    assert state["count"] == 0  # the optimizer leaves the host count to the caller


def test_tabled_ema_decay_gives_the_python_float_update():
    """The EMA with (d, 1 - d) read from a row of ``ema_decay_table``
    against the Python floats of ``ema_decay_at``, six steps from the
    warm-up (d = 0.1) on. Exact."""
    ema_ref, ema_tab = _leaves(4), _leaves(4)
    table = ema_decay_table(0.9999, 6, "cpu")
    for step in range(6):
        params = _leaves(50 + step)
        d = ema_decay_at(0.9999, step)
        ref = [ema_ref[k] for k in ema_ref]
        torch._foreach_mul_(ref, d)
        torch._foreach_add_(ref, torch._foreach_mul([params[k] for k in ema_ref],
                                                    float(np.float32(1.0) - np.float32(d))))
        ema_update(ema_tab, params, table[step])
        assert float(table[step, 0]) == d
        assert all(torch.equal(ema_ref[k], ema_tab[k]) for k in ema_ref), step


# ------------------------------------------------------ steps_per_execution --
def _crossed_steps(max_steps, k, cadence):
    """The logged global_steps of the JAX trainer's rule
    (``diffusion_model_nemo_tpu/training/trainer.py``: a group of k steps, or
    a tail of single steps, then ``_crossed(log_every_n_steps)`` or the last
    step)."""
    out, step = [], 0
    while step < max_steps:
        prev = step
        step = prev + k if prev + k <= max_steps else max_steps
        if (cadence > 0 and step // cadence > prev // cadence) or step == max_steps:
            out.append(step)
    return out


def _fit(spe, max_steps=5, log_every=2, graphs=None):
    model = _model()
    trainer = Trainer(max_steps=max_steps, log_every_n_steps=log_every, devices=1, steps_per_execution=spe)
    states = []
    init = trainer.init_state
    trainer.init_state = lambda m, n: states.append(init(m, n)) or states[-1]
    trainer.fit(model, graphs=graphs)
    return model, trainer, states[0]


def _same_run(a, b):
    (ma, _ta, sa), (mb, _tb, sb) = a, b
    assert all(torch.equal(ma.params[k], mb.params[k]) for k in ma.params)
    assert all(torch.equal(ma.ema_params[k], mb.ema_params[k]) for k in ma.ema_params)
    for key in ("mu", "nu"):
        assert all(torch.equal(sa.opt_state[key][k], sb.opt_state[key][k]) for k in sa.opt_state[key])
    assert sa.step == sb.step == sa.opt_state["count"] == sb.opt_state["count"]


@pytest.mark.parametrize("k,max_steps,log_every", [(2, 5, 2), (2, 5, 3), (4, 10, 3)])
def test_steps_per_execution_equals_single_steps(k, max_steps, log_every):
    """K steps between host syncs (4 batches an epoch: no group is
    dropped): the parameters, EMA and optimizer state of single steps bit
    for bit, and the logged global_steps of the JAX rule. Exact."""
    single, multi = _fit(1, max_steps, log_every), _fit(k, max_steps, log_every)
    _same_run(single, multi)
    assert [m["global_step"] for m in multi[1].logged] == _crossed_steps(max_steps, k, log_every)
    assert [m["global_step"] for m in single[1].logged] == _crossed_steps(max_steps, 1, log_every)


def test_fit_replays_equal_the_eager_fit():
    """``fit(graphs=True)`` on the CPU (each step a "replay" of the staged
    step: batch and draws copied into static buffers) against eager steps.
    Exact."""
    _same_run(_fit(2, 5, 2, graphs=True), _fit(2, 5, 2, graphs=False))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_grouping_matches_the_jax_trainer(k):
    """An epoch of 5 batches k at a time: the JAX trainer's grouping (a
    trailing incomplete group dropped)."""
    batches = [{"image": np.full((2, 1), i, np.uint8)} for i in range(5)]
    ours = [[int(b["image"][0, 0]) for b in g] for g in Trainer._grouped(batches, k)]
    ref = [list(g["image"][:, 0, 0]) if k > 1 else [int(g["image"][0, 0])]
           for g in JTrainer._accumulated(batches, k)]
    assert ours == ref


def test_checkpoint_data_position_follows_the_groups():
    """The loader position after n steps taken k at a time (the JAX
    trainer's fast-forward: n // k groups, an epoch of len // k groups)."""
    state = Trainer(max_steps=1).init_state(_model(), 1)
    for step, k, spe_epoch, expect in ((6, 1, 4, [1, 2]), (8, 3, 10, [0, 6]), (9, 3, 10, [1, 0]), (4, 2, 4, [1, 0])):
        state.step = step
        assert Trainer.checkpoint_state(state, _gen(), spe_epoch, k)["data_position"] == expect


def test_replays_bump_the_versions_of_what_they_write():
    """A training replay writes the parameters and the EMA in place: their
    ``_version`` moves on (as an eager update's would) and the graph's own
    entry follows, so the next step replays and does not capture again.
    The graph is the state's."""
    model = _model()
    trainer = Trainer(max_steps=3, devices=1)
    state = trainer.init_state(model, 3)
    loader = TD.build_dataloader(dict(model.cfg.train_ds), mode="train")
    batch = next(iter(loader))
    versions = []
    for _ in range(3):
        draws = model.draw_training_inputs(batch["image"].shape, _gen())
        trainer.train_step(model, state, batch, draws, graphs=True)
        versions.append(next(iter(state.params.values()))._version)
    (graph,) = state.graphs.values()
    assert graph.info["name"] == "train_step" and graph.info["replays"] == 2
    assert versions[0] < versions[1] < versions[2]


@pytest.mark.parametrize("graphs", [True, False], ids=["replayed", "eager"])
def test_train_step_runs_past_init_states_max_steps(graphs):
    """A state whose schedule and tables are for 1 step takes 6: the scalar
    tables are built anew over twice the count when a step passes their
    end (twice here: at steps 2 and 5), the graph is not captured again (it
    reads only its static rows), and the run equals one whose tables were
    built over 10 steps up front, bit for bit. Exact."""
    runs = []
    for grown in (True, False):
        model = _model()
        trainer = Trainer(max_steps=6, devices=1)
        state = trainer.init_state(model, 1)
        if not grown:
            trainer._tables = trainer._build_tables(10, model.device)
        loader = TD.build_dataloader(dict(model.cfg.train_ds), mode="train")
        batch, gen = next(iter(loader)), _gen()
        for _ in range(6):
            trainer.train_step(model, state, batch, model.draw_training_inputs(batch["image"].shape, gen),
                               graphs=graphs)
        runs.append((state, trainer._tables[0].shape[0]))
    (grown, rows), (full, _) = runs
    assert rows == 11  # steps 0 … 1, then 0 … 4, then 0 … 10
    if graphs:
        (graph,) = grown.graphs.values()
        assert graph.info["replays"] == 5
    for name in ("params", "ema_params"):
        a, b = getattr(grown, name), getattr(full, name)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(grown.opt_state["mu"][k], full.opt_state["mu"][k]) for k in grown.params)
