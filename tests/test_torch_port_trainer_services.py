"""The port's Trainer services against the JAX package, on the CPU: gradient
accumulation, post-hoc EMA (its online update, its reconstruction, its
snapshots both ways and ``reconstruct_ema``), the threaded prefetcher and the
``profile_dir`` trace.

The model is examples/configs/ddpm/unet_small.yaml cut to a tiny float32
U-Net (dim 8, one level, 4 GroupNorm groups, 8 px, T = 20). Accumulation is held to JAX's
own ``Trainer._build_update_fn`` with ``accumulate_grad_batches = 2``: the
step function it scans reads the injected draws (flip, t, noise) from the
stacked batch dict, so that the scan slices them per micro-batch as it
slices the images, and the port's stacked step takes the same draws.

Tolerances: accumulated training as the lockstep run of
tests/test_torch_port_training.py (losses rtol 1e-4 / atol 1e-6, parameters
and EMA atol 5e-4 / rtol 5e-3: Adam divides by √v̂); the post-hoc EMA's
host arithmetic (float64) 1e-6 relative, its float32 online update 1e-6;
reconstructions from the same snapshots 1e-6; everything within the port
(resume, prefetched batches) bit for bit.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.data.prefetch import ThreadedPrefetcher as JPrefetcher
from diffusion_model_nemo_tpu.models import DDPM as JDDPM
from diffusion_model_nemo_tpu.training import posthoc_ema as JP
from diffusion_model_nemo_tpu.training.optim import build_optimizer as j_build_optimizer
from diffusion_model_nemo_tpu.training.trainer import Trainer as JTrainer
from diffusion_model_nemo_tpu_torch import DDPM, Trainer
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.data import hf_vision_data as TD
from diffusion_model_nemo_tpu_torch.data.prefetch import ThreadedPrefetcher
from diffusion_model_nemo_tpu_torch.tools import reconstruct_ema
from diffusion_model_nemo_tpu_torch.tools.profiling import EmptyTraceError, WindowTrace
from diffusion_model_nemo_tpu_torch.training import posthoc_ema as TP
from diffusion_model_nemo_tpu_torch.utils import msgpack
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/ddpm/unet_small.yaml"
T, IMG, B, K = 20, 8, 4, 2
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1]", "model.diffusion_model.dtype=float32",
    # 2 channels a group: a conv bias before a 1-channel group has a zero gradient, which Adam turns into noise
    "model.diffusion_model.resnet_block_groups=4",
    "model.train_ds.name=synthetic", f"model.train_ds.batch_size={B}", "+model.train_ds.length=20",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0):
    return DDPM(load_config(YAML, overrides=TINY).model, device="cpu", seed=seed)


def _flat(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


# ------------------------------------------------------------- accumulation --
@pytest.fixture(scope="module")
def accumulated():
    """Three optimizer steps of K = 2 micro-batches of B = 4 through both
    trainers from the same weights and draws."""
    steps = 3
    model = _model()
    jmodel = JDDPM(cfg=j_load_config(YAML, overrides=TINY).model)
    start = to_flax_params(model.params, model.diffusion_model)
    jparams = jax.tree.map(jnp.asarray, start)

    def j_train_step(params, batch, key, step):  # DDPM.training_step with the draws from the batch
        x = batch["image"].astype(jnp.float32) / 127.5 - 1.0
        x0 = jnp.where(batch["flip"][:, None, None, None], x[:, :, ::-1, :], x)
        x_t = jmodel.sampler.q_sample(x_start=x0, t=batch["t"], noise=batch["noise"])
        loss = jmodel.loss(input=jmodel.model_fn(params, x_t, batch["t"]), target=batch["noise"])
        return loss, {"train_loss": loss}

    jt = JTrainer.__new__(JTrainer)
    jt.accumulate_grad_batches, jt.ema_decay = K, 0.9999
    tx, _ = j_build_optimizer(jmodel.cfg.optim, steps, grad_clip=1.0)
    update = jt._build_update_fn(j_train_step, tx)

    trainer = Trainer(max_steps=steps, accumulate_grad_batches=K, gradient_clip_val=1.0, ema_decay=0.9999)
    state = trainer.init_state(model, steps)
    ds = TD.SyntheticVisionDataset(image_size=IMG, channels=3, length=steps * K * B, seed=1)
    gen = torch.Generator().manual_seed(5)
    j_state = (jparams, tx.init(jparams), jax.tree.map(jnp.copy, jparams), jnp.asarray(0, jnp.int32))
    out = {"ours": [], "ref": [], "steps": []}
    for i in range(steps):
        images = np.stack([np.stack([ds[(i * K + k) * B + j]["image"] for j in range(B)]) for k in range(K)])
        draws = trainer.stack_draws([model.draw_training_inputs((B, IMG, IMG, 3), gen) for _ in range(K)])
        metrics = trainer.train_step(model, state, {"image": images}, draws, graphs=True)
        out["ours"].append(float(metrics["train_loss"]))
        jbatch = {"image": jnp.asarray(images), **{k: jnp.asarray(v.numpy()) for k, v in draws.items()}}
        args = (*j_state[:3], jbatch, jax.random.PRNGKey(0), j_state[3])
        if i == 0:  # XLA's backend optimization level 0: the same program, compiled in half the time
            update = update.lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})
        p, o, e, s, m = update(*args)
        j_state = (p, o, e, s)
        out["ref"].append(float(m["train_loss"]))
        out["steps"].append((state.step, int(s)))
    net = model.diffusion_model
    out["params"] = (to_flax_params(state.params, net), jax.tree.map(np.asarray, j_state[0]))
    out["ema"] = (to_flax_params(state.ema_params, net), jax.tree.map(np.asarray, j_state[2]))
    out["start"] = start
    out["count"] = state.opt_state["count"]
    return out


def test_accumulated_steps_match_the_jax_update(accumulated):
    """Losses (the micro-batches' mean), step counts and optimizer count
    against JAX's scan over the micro-batches."""
    r = accumulated
    np.testing.assert_allclose(r["ours"], r["ref"], rtol=1e-4, atol=1e-6)
    assert r["steps"] == [(1, 1), (2, 2), (3, 3)] and r["count"] == 3


@pytest.mark.parametrize("which", ["params", "ema"])
def test_accumulated_params_and_ema_match_the_jax_update(accumulated, which):
    ours, ref = accumulated[which]
    flat_ours, flat_ref = _flat(ours), _flat(ref)
    assert flat_ours.keys() == flat_ref.keys()
    for path, leaf in flat_ref.items():
        np.testing.assert_allclose(flat_ours[path], leaf, atol=5e-4, rtol=5e-3, err_msg=str(path))
    moved = max(float(np.abs(flat_ours[p] - v).max()) for p, v in _flat(accumulated["start"]).items())
    assert moved > 1e-4


def test_accumulated_groups_stack_as_jax_does():
    """An epoch of 5 batches, K = 2: two stacked [2, B, ...] groups, the
    trailing batch dropped, equal to the JAX trainer's ``_accumulated``."""
    from diffusion_model_nemo_tpu_torch.training.trainer import _Groups

    loader = [{"image": np.full((B, 1), i, np.uint8), "label": np.full((B,), i, np.int32)} for i in range(5)]
    ours, ref = list(_Groups(loader, K, stack=True)), list(JTrainer._accumulated(loader, K))
    assert len(ours) == len(ref) == 2 and len(_Groups(loader, K, stack=True)) == 2
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        assert a["image"].shape == (K, B, 1)


def test_fit_counts_optimizer_steps_under_accumulation():
    """5 batches an epoch at K = 2: 2 optimizer steps an epoch (the JAX
    trainer's ``steps_per_epoch``), ``max_epochs = 2`` is 4 steps; every
    micro-batch of each group reaches the step and the fifth batch never
    does; logging counts optimizer steps and samples count micro-batches."""
    model = _model()
    seen = []
    step_fn = model.training_step

    def recording(params, batch, draws):
        seen.append(int(np.asarray(batch["image"])[0, 0, 0, 0]))
        return step_fn(params, batch, draws)

    model.training_step = recording
    trainer = Trainer(max_epochs=2, log_every_n_steps=2, devices=1, accumulate_grad_batches=K)
    trainer.fit(model, graphs=False)
    assert trainer.global_step == 4 and [m["global_step"] for m in trainer.logged] == [2, 4]
    loader = model._train_dl
    loader.set_position(0, 0)
    epochs = [[int(b["image"][0, 0, 0, 0]) for b in loader] for _ in range(2)]
    assert seen == [v for e in epochs for v in e[:4]]


# ------------------------------------------------------------ post-hoc EMA --
SIGMAS = (0.05, 0.10)


def test_power_ema_beta_and_update_match_jax():
    """beta(t) in float32 at small and large t (1 − 1/t would round to 1 at
    t ~ 1e7), and one update of a parameter tree, against JAX."""
    t = np.asarray([1, 2, 3, 10, 1000, 123457, 10_000_000], np.int32)
    rng = np.random.default_rng(0)
    for s in SIGMAS:
        g = TP.sigma_rel_to_gamma(s)
        ours = TP.power_ema_beta(g, torch.from_numpy(t)).numpy()
        ref = np.asarray(JP.power_ema_beta(g, jnp.asarray(t)))
        assert ours.dtype == np.float32 and ours[0] == 0.0
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
        ema = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
        params = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
        mine = TP.power_ema_update({"w": torch.from_numpy(ema["w"].copy())}, {"w": torch.from_numpy(params["w"])},
                                   g, torch.tensor(7))
        ref = JP.power_ema_update(ema, params, g, jnp.asarray(7))
        np.testing.assert_allclose(mine["w"].numpy(), np.asarray(ref["w"]), rtol=1e-6, atol=1e-7)


def test_profiles_and_weights_match_jax():
    """σ_rel ↔ γ, the profile inner products and the least-squares weights
    of a snapshot grid (float64 host numpy in both)."""
    for s in (0.01, 0.05, 0.1, 0.2):
        g = TP.sigma_rel_to_gamma(s)
        np.testing.assert_allclose(g, JP.sigma_rel_to_gamma(s), rtol=1e-6)
        np.testing.assert_allclose(TP.gamma_to_sigma_rel(g), s, rtol=1e-6)
    with pytest.raises(ValueError):
        TP.sigma_rel_to_gamma(0.5)
    ts = np.asarray([256, 512, 768, 1024] * 2, np.float64)
    gs = np.asarray([TP.sigma_rel_to_gamma(s) for s in SIGMAS for _ in range(4)])
    np.testing.assert_allclose(TP.profile_dot(ts[:, None], gs[:, None], ts[None], gs[None]),
                               JP.profile_dot(ts[:, None], gs[:, None], ts[None], gs[None]), rtol=1e-6)
    for target in (0.07, 0.15):
        np.testing.assert_allclose(TP.solve_posthoc_weights(ts, gs, 1024, TP.sigma_rel_to_gamma(target)),
                                   JP.solve_posthoc_weights(ts, gs, 1024, JP.sigma_rel_to_gamma(target)), rtol=1e-6)


class _Hooks:
    """exp_manager's hooks as the trainer calls them: the checkpoint at step
    2 and the final state kept (on the CPU, copied)."""

    def __init__(self, log_dir):
        self.log_dir, self.saved, self.final = Path(log_dir), {}, None

    def log_metrics(self, metrics, step):
        pass

    def should_checkpoint(self, step):
        return step == 2

    def maybe_checkpoint(self, step, state, metrics=None):
        self.saved[step] = copy.deepcopy(state)

    def finalize(self, model, state):
        self.final = copy.deepcopy(state)


def _phema_fit(tmp, resume=None):
    model = _model()
    trainer = Trainer(max_steps=4, log_every_n_steps=0, devices=1, posthoc_ema_sigma_rels=list(SIGMAS),
                      posthoc_ema_every_n_steps=2)
    trainer.exp_manager_hooks = _Hooks(tmp)
    trainer.fit(model, resume_state=resume)
    return model, trainer


@pytest.fixture(scope="module")
def phema_runs(tmp_path_factory):
    """Post-hoc EMA over 4 steps, snapshots every 2: straight, and resumed
    from the straight run's checkpoint at step 2 (in another directory)."""
    root = tmp_path_factory.mktemp("phema")
    straight = _phema_fit(root / "straight")
    resumed = _phema_fit(root / "resumed", resume=straight[1].exp_manager_hooks.saved[2])
    return root, straight, resumed


def test_a_resume_with_posthoc_ema_is_bit_identical(phema_runs):
    """The checkpoint carries the averages: the resumed run's parameters,
    EMA, averages and last snapshots equal the straight run's bit for bit."""
    root, (m1, t1), (m2, t2) = phema_runs
    assert len(t1.exp_manager_hooks.saved[2]["phema"]) == 2
    assert all(torch.equal(m1.params[k], m2.params[k]) for k in m1.params)
    assert all(torch.equal(m1.ema_params[k], m2.ema_params[k]) for k in m1.ema_params)
    a, b = t1.exp_manager_hooks.final["phema"], t2.exp_manager_hooks.final["phema"]
    assert len(a) == len(b) == 2 and all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not all(torch.equal(a[0][k], a[1][k]) for k in a[0])  # two profiles, two averages
    names = sorted(p.name for p in (root / "straight" / "phema").iterdir())
    last = sorted(p.name for p in (root / "resumed" / "phema").iterdir())
    assert len(names) == 4 and len(last) == 2 and set(last) < set(names)
    for n in last:
        assert (root / "straight" / "phema" / n).read_bytes() == (root / "resumed" / "phema" / n).read_bytes()


def test_snapshots_read_both_ways(phema_runs, tmp_path):
    """JAX's ``reconstruct`` reads the port's snapshots and the port's reads
    JAX's (written by JAX's ``PostHocEMA.snapshot`` from the same trees):
    the same reconstruction, at the last t and at an earlier one."""
    root, (model, trainer), _ = phema_runs
    ours_dir = root / "straight" / "phema"
    jax_dir = tmp_path / "jax_phema"
    jp = JP.PostHocEMA(str(jax_dir), SIGMAS, every_n_steps=2)
    for t in (2, 4):
        trees = [msgpack.unpackb((ours_dir / f"phema-{g:.6f}-{t:010d}.msgpack").read_bytes()) for g in jp.gammas]
        jp.snapshot([jax.tree.map(jnp.asarray, tr) for tr in trees], t)
    assert sorted(p.name for p in jax_dir.iterdir()) == sorted(p.name for p in ours_dir.iterdir())
    for kw in (dict(sigma_rel=0.08), dict(gamma=5.0, t=3)):
        ours_of_jax = _flat(TP.reconstruct(str(jax_dir), **kw))
        jax_of_ours = _flat(JP.reconstruct(str(ours_dir), **kw))
        ours = _flat(TP.reconstruct(str(ours_dir), **kw))
        assert ours.keys() == jax_of_ours.keys() == ours_of_jax.keys()
        for k in ours:
            np.testing.assert_allclose(ours_of_jax[k], jax_of_ours[k], rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ours[k], jax_of_ours[k], rtol=1e-6, atol=1e-7)


def test_reconstruct_ema_writes_an_archive_both_packages_restore(phema_runs, tmp_path):
    """``tools/reconstruct_ema.py`` of the port: the base archive's weights,
    the reconstruction as the EMA, restored by both packages."""
    root, (model, _trainer), _ = phema_runs
    base = model.save_to(str(tmp_path / "base.dmn"))
    out = reconstruct_ema.main(["--archive", base, "--snapshots", str(root / "straight" / "phema"),
                                "--sigma_rel", "0.08", "--output", str(tmp_path / "sr008.dmn")])
    want = _flat(JP.reconstruct(str(root / "straight" / "phema"), sigma_rel=0.08))
    restored = DDPM.restore_from(out, device="cpu")
    ours = _flat(to_flax_params(restored.ema_params, restored.diffusion_model))
    jmodel = JDDPM.restore_from(out)  # params and EMA, as the archive holds them
    theirs = _flat(jax.tree.map(np.asarray, jmodel.ema_params))
    assert ours.keys() == want.keys() == theirs.keys()
    for k in want:
        np.testing.assert_allclose(ours[k], want[k], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(theirs[k], ours[k])
    assert all(torch.equal(restored.params[k], model.params[k]) for k in model.params)


# --------------------------------------------------------------- prefetcher --
def test_prefetcher_yields_the_loaders_batches_in_order():
    """Two epochs of the synthetic loader through the port's prefetcher, the
    JAX package's and none: the same batches in the same order; a consumer
    that stops early stops the thread."""
    def loader():
        return TD.DataLoader(TD.SyntheticVisionDataset(image_size=IMG, length=40, seed=2), batch_size=8,
                             shuffle=True, seed=4)

    ours, ref, plain = ThreadedPrefetcher(loader(), depth=2), JPrefetcher(loader(), depth=2), loader()
    assert len(ours) == len(plain) == 5
    for _epoch in range(2):
        for a, b, c in zip(ours, ref, plain, strict=True):
            assert all(np.array_equal(a[k], c[k]) and np.array_equal(b[k], c[k]) for k in c)
    it = iter(ThreadedPrefetcher(loader(), depth=1))
    next(it)
    it.close()  # the thread is joined, not left blocked on a full queue


def test_prefetcher_raises_the_threads_exception():
    def broken():
        yield {"image": np.zeros((1,))}
        raise OSError("disk gone")

    class Loader:
        def __iter__(self):
            return broken()

        def __len__(self):
            return 2

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for batch in ThreadedPrefetcher(Loader(), depth=2):
            got.append(batch)
    assert len(got) == 1


# --------------------------------------------------------------- profile_dir --
def test_profile_dir_writes_a_trace_of_the_window(tmp_path):
    """Steps 1 … 3 of a 4-step fit traced (the JAX trainer's window: start
    before step ``profile_start_step``, stop before step start + num) into
    ``profile_dir`` as a Chrome trace; an empty window raises and writes
    nothing."""
    model = _model()
    trainer = Trainer(max_steps=4, log_every_n_steps=0, devices=1, profile_dir=str(tmp_path / "trace"),
                      profile_start_step=1, profile_num_steps=2)
    trainer.fit(model)
    files = sorted(p.name for p in (tmp_path / "trace").iterdir())
    assert files == ["trace-steps-1-3.json"]
    events = json.loads((tmp_path / "trace" / files[0]).read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    empty = WindowTrace(torch.device("cpu"))
    empty.start()
    empty.prof.events = lambda: []  # a trace that kept nothing
    with pytest.raises(EmptyTraceError):
        empty.stop(str(tmp_path / "empty.json"))
    assert not (tmp_path / "empty.json").exists()

