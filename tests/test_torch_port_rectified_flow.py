"""The port's rectified-flow family (``RectifiedFlowProcess``,
``RectifiedFlow``) against the JAX package on the CPU.

The model is the shipped ``examples/configs/rectified_flow/unet_small.yaml``
cut to a tiny float32 U-Net (dim 8, dim_mults [1, 2], 8 px) with a grid of
M = 4; the JAX model gets the port's weights (``utils/weights.py``), no
flax init. Inputs are numpy-seeded; the port is fed the JAX draws: the
time draws (uniform, or the normal of ``logit_normal``), the noise, the
flip and the Hutchinson probes (Rademacher and Gaussian).

Tolerances (those of tests/test_torch_port_edm.py): the host grid tables
bit for bit; the process's float32 pieces and the loss 1e-5; the training
step's whole gradient and the held-out loss 2e-4 (the network); the
chains, frames, encode and interpolation 1e-3; bits/dim 1e-4 relative.
The captured loops run eagerly on the CPU (``graphs=True``) and equal the
Python loops bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import RectifiedFlow as JRectifiedFlow
from diffusion_model_nemo_tpu.modules import RectifiedFlowProcess as JProcess
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import SR3, RectifiedFlow, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules import RectifiedFlowProcess
from diffusion_model_nemo_tpu_torch.pipelines import CascadePipeline, stage_generator
from diffusion_model_nemo_tpu_torch.serving import serve
from diffusion_model_nemo_tpu_torch.training.trainer import param_grads
from diffusion_model_nemo_tpu_torch.utils.image import to_uint8_tensor
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/rectified_flow/unet_small.yaml"
M, IMG, B = 4, 8, 2
SHAPE = (B, IMG, IMG, 3)
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={M}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=16",
]
OP_TOL = 1e-5  # float32 ops
WHOLE_TOL = 2e-4  # whole float32 network
CHAIN_TOL = 1e-3  # a chain of network calls
BPD_TOL = 1e-4  # bits/dim, relative
CHAINS = [("euler", 1), ("euler", 4), ("heun", 1), ("heun", 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _model(extra=()):
    return RectifiedFlow(load_config(YAML, overrides=[*TINY, *extra]).model, device="cpu", seed=0)


def _jax_of(model, extra=()):
    """The JAX model with the port's weights."""
    jmodel = JRectifiedFlow(cfg=j_load_config(YAML, overrides=[*TINY, *extra]).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    jmodel.ema_params = jmodel.params
    return jmodel


@pytest.fixture(scope="module")
def pair():
    model = _model()
    return _jax_of(model), model


def jit0(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimization level 0."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _x(seed=1, shape=SHAPE, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _counted(fn):
    """``fn`` with a count of its calls (the NFE of an eager loop)."""
    def counted(*args, **kwargs):
        counted.calls += 1
        return fn(*args, **kwargs)

    counted.calls = 0
    return counted


# ------------------------------------------------------------ the process --
def test_process_pieces_match_jax():
    """q_sample ([B] and 0-d t), the target, the network time, and the
    training times from the JAX draws: u itself, σ(mean + std·z)."""
    ours, ref = RectifiedFlowProcess(device="cpu"), JProcess()
    x0, eps = _x(2), _x(3)
    t = np.asarray([0.1, 0.75], np.float32)
    np.testing.assert_allclose(
        ours.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(eps)).numpy(),
        np.asarray(ref.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))), rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_allclose(ours.q_sample(torch.from_numpy(x0), torch.tensor(0.25), torch.from_numpy(eps)).numpy(),
                               np.asarray(ref.q_sample(jnp.asarray(x0), jnp.asarray(0.25), jnp.asarray(eps))),
                               rtol=OP_TOL, atol=OP_TOL)
    assert np.array_equal(ours.v_target(torch.from_numpy(x0), torch.from_numpy(eps)).numpy(),
                          np.asarray(ref.v_target(jnp.asarray(x0), jnp.asarray(eps))))
    assert np.array_equal(ours.model_time(torch.from_numpy(t)).numpy(), np.asarray(ref.model_time(jnp.asarray(t))))
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (8,), jnp.float32))
    assert np.array_equal(ours.sample_times(torch.from_numpy(u)).numpy(), np.asarray(ref.sample_times(key, 8)))
    kw = dict(time_sampling="logit_normal", logit_mean=0.3, logit_std=1.4)
    z = np.asarray(jax.random.normal(key, (8,), jnp.float32))
    np.testing.assert_allclose(RectifiedFlowProcess(device="cpu", **kw).sample_times(torch.from_numpy(z)).numpy(),
                               np.asarray(JProcess(**kw).sample_times(key, 8)), rtol=OP_TOL)


@pytest.mark.parametrize("steps", [1, 4, 7])
def test_grid_tables_equal_jax(steps):
    """t, t_next and dt of both directions bit for bit: the float64 grid,
    cast once (dt is not float32(t_next) − float32(t))."""
    ours, ref = RectifiedFlowProcess(device="cpu", sample_steps=steps), JProcess(sample_steps=steps)
    for reverse in (False, True):
        a, b = ours._grid(None, reverse), ref._grid(None, reverse)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == np.float32 and np.array_equal(a[k], np.asarray(b[k])), (reverse, k)
        table = ours._table(steps, reverse)
        assert np.array_equal(table.numpy(), np.stack([a["t"], a["t_next"], a["dt"]], axis=1))


def test_argument_checks_match_jax():
    for kw, match in ((dict(solver="rk4"), "solver"), (dict(time_sampling="beta"), "time_sampling"),
                      (dict(sample_steps=0), "sample_steps")):
        with pytest.raises(ValueError, match=match):
            JProcess(**kw)
        with pytest.raises(ValueError, match=match):
            RectifiedFlowProcess(device="cpu", **kw)
    with pytest.raises(ValueError, match="num_steps"):
        RectifiedFlowProcess(device="cpu")._grid(-1, False)


@pytest.fixture(scope="module")
def jax_chains(pair):
    """The four JAX chains with frames from one image, one compile."""
    jmodel, _model_ = pair
    fn, img = jmodel.get_model_fn(), jnp.asarray(_x(9))
    procs = {s: JProcess(sample_steps=M, solver=s) for s in ("euler", "heun")}

    def run(p, img):
        return {f"{s}-{n}": procs[s].p_sample_loop(fn, p, SHAPE, jax.random.PRNGKey(0), img=img, num_steps=n,
                                                   return_frames=True) for s, n in CHAINS}

    return jit0(run, jmodel.params, img)


@pytest.mark.parametrize("solver,steps", CHAINS, ids=[f"{s}-{n}" for s, n in CHAINS])
def test_chain_and_frames_match_jax(pair, jax_chains, solver, steps):
    """Euler (M steps) and Heun (M − 1 corrected steps, then one Euler step:
    NFE 2M − 1; Heun-1 is Euler-1) from the same x_1: the images and every
    frame within 1e-3; the captured steps, run eagerly, equal the Python
    loop bit for bit."""
    _jmodel, model = pair
    proc = RectifiedFlowProcess(device="cpu", sample_steps=M, solver=solver)
    img = torch.from_numpy(_x(9))
    fn = _counted(model.get_model_fn())
    with torch.inference_mode():
        outs = [proc.p_sample_loop(fn, model.params, SHAPE, img=img, num_steps=steps, return_frames=True, graphs=g)
                for g in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    ref, ref_frames = jax_chains[f"{solver}-{steps}"]
    out, frames = outs[0]
    assert frames.shape == (steps, *SHAPE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    np.testing.assert_allclose(frames.numpy(), np.asarray(ref_frames), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    assert torch.equal(frames[-1], out)
    nfe = 2 * steps - 1 if solver == "heun" else steps
    assert fn.calls == 2 * nfe  # the captured loop's warm-up, capture and eager calls on the CPU, then the Python loop's


@pytest.mark.parametrize("solver,steps", [("euler", 1), ("heun", 5)])
def test_single_point_field_is_solved_exactly(solver, steps):
    """On the single-point field v(x, t) = (x − x0*)/t the trajectory is a
    straight line: one Euler step, and Heun with its Euler tail, land on
    x0* (tests/test_rectified_flow.py:101)."""
    x0s = torch.full((1, IMG, IMG, 1), 0.3)

    def field(params, x, t_net):
        t = (t_net / 1000.0).reshape((-1, 1, 1, 1))
        return (x - x0s) / torch.clamp_min(t, 1e-6)

    proc = RectifiedFlowProcess(device="cpu", sample_steps=steps, solver=solver)
    out = proc.p_sample_loop(field, None, (4, IMG, IMG, 1), torch.Generator().manual_seed(1), unnormalize=False)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(x0s.numpy(), (4, IMG, IMG, 1)), atol=1e-4)


def test_encode_and_interpolate_match_jax(pair):
    """``encode`` (Euler up the grid 0 → 1) and ``interpolate`` (encode,
    slerp, decode) from the same images, within 1e-3; captured == eager."""
    jmodel, model = pair
    x1, x2 = (np.clip(_x(s) * 0.3 + 0.5, 0.0, 1.0) for s in (10, 11))
    fn, proc = jmodel.get_model_fn(), jmodel.sampler
    ref_z, ref = jit0(lambda p, a, b: (proc.encode(fn, p, a * 2.0 - 1.0),
                                       proc.interpolate(fn, p, a, b, jax.random.PRNGKey(0), lambd=0.3)),
                      jmodel.params, jnp.asarray(x1), jnp.asarray(x2))
    z = model.encode(torch.from_numpy(x1 * 2 - 1))
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    assert torch.equal(z, model.encode(torch.from_numpy(x1 * 2 - 1), graphs=False))
    out = model.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), lambd=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    assert torch.equal(out, model.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), lambd=0.3, graphs=False))


LIKELIHOODS = [("euler", "rademacher"), ("heun", "gaussian")]


@pytest.fixture(scope="module")
def jax_likelihoods(pair):
    jmodel, _model_ = pair
    fn, x = jmodel.get_model_fn(), jnp.asarray(np.clip(_x(12) * 0.4, -1.0, 1.0))
    procs = {s: JProcess(sample_steps=M, solver=s) for s, _h in LIKELIHOODS}
    return jit0(lambda p, x: {f"{s}-{h}": procs[s].likelihood(fn, p, x, jax.random.PRNGKey(7), hutchinson_type=h)
                              for s, h in LIKELIHOODS}, jmodel.params, x)


@pytest.mark.parametrize("solver,probe", LIKELIHOODS, ids=[f"{s}-{h}" for s, h in LIKELIHOODS])
def test_likelihood_matches_jax(pair, jax_likelihoods, solver, probe):
    """Bits/dim, the latent and the NFE (Heun on all M transitions: 2M;
    Euler M) with the JAX probe; the captured step (forward and vjp)
    equals the Python loop bit for bit."""
    _jmodel, model = pair
    x = np.clip(_x(12) * 0.4, -1.0, 1.0)
    key = jax.random.PRNGKey(7)
    if probe == "gaussian":
        eps = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
    else:
        eps = np.asarray(jax.random.randint(key, SHAPE, 0, 2), np.float32) * 2.0 - 1.0
    proc = RectifiedFlowProcess(device="cpu", sample_steps=M, solver=solver)
    runs = [proc.likelihood(model.train_model_fn, model.params, torch.from_numpy(x), hutchinson_type=probe,
                            epsilon=torch.from_numpy(eps), graphs=g) for g in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    bpd, z, nfe = runs[0]
    ref_bpd, ref_z, ref_nfe = jax_likelihoods[f"{solver}-{probe}"]
    np.testing.assert_allclose(bpd.numpy(), np.asarray(ref_bpd), rtol=BPD_TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    assert float(nfe) == float(ref_nfe) == (2 * M if solver == "heun" else M)
    with pytest.raises(ValueError, match="hutchinson_type"):
        proc.likelihood(model.train_model_fn, model.params, torch.from_numpy(x), hutchinson_type="sphere")


# ---------------------------------------------------------------- the model --
@pytest.mark.parametrize("sampling", ["uniform", "logit_normal"])
def test_training_step_matches_jax(sampling):
    """The port's step fed the JAX step's draws (the flip, the time draw,
    the noise) against the JAX ``training_step``: the loss (1e-5) and the
    whole gradient (2e-4)."""
    extra = [f"model.sampler.time_sampling={sampling}", "model.sampler.logit_mean=0.2"]
    model = _model(extra)
    jmodel = _jax_of(model, extra)
    batch = {"image": np.random.default_rng(3).integers(0, 256, (4, IMG, IMG, 3), dtype=np.uint8)}
    key = jax.random.PRNGKey(11)
    b = jax.tree.map(jnp.asarray, batch)
    lowered = jax.jit(jax.value_and_grad(lambda p: jmodel.training_step(p, b, key, 0)[0])).lower(jmodel.params)
    jloss, jgrads = lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(jmodel.params)
    k_pre, k_t, k_noise, _k_drop = jax.random.split(key, 4)
    shape = (4, IMG, IMG, 3)
    time = (jax.random.normal(k_t, (4,), jnp.float32) if sampling == "logit_normal"
            else jax.random.uniform(k_t, (4,), jnp.float32))
    draws = {"flip": jax.random.bernoulli(k_pre, 0.5, (4,)), "time": time,
             "noise": jax.random.normal(k_noise, shape, jnp.float32)}
    drawn = model.draw_training_inputs(shape, torch.Generator().manual_seed(0))
    assert sorted(drawn) == sorted(draws) and drawn["time"].shape == (4,)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, metrics = model.training_step(params, batch, draws)
    grads = param_grads(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=OP_TOL)
    ours = to_flax_params({k: g.detach() for k, g in grads.items()}, model.diffusion_model)
    flat = lambda tree: np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])  # noqa: E731
    assert _rel_l2(flat(ours), flat(jax.tree.map(np.asarray, jgrads))) < WHOLE_TOL
    assert metrics["train_loss"] is loss


def test_test_step_and_epoch_end_match_jax(pair):
    """The held-out loss and the exact bits/dim of one batch with the draws
    of the JAX step's ``PRNGKey(batch_nb)``, against JAX's; ``test_epoch_end``
    reports JAX's keys and values; ``compute_nll: false`` drops the NLL."""
    jmodel, model = pair
    batch = {"image": np.random.default_rng(4).integers(0, 256, SHAPE, dtype=np.uint8)}
    ref = jmodel.test_step(batch, 1)
    k_loss, k_nll = jax.random.split(jax.random.PRNGKey(1))
    k_t, k_noise = jax.random.split(k_loss)
    inject = {"time": jax.random.uniform(k_t, (B,), jnp.float32),
              "noise": jax.random.normal(k_noise, SHAPE, jnp.float32),
              "epsilon": jax.random.randint(k_nll, SHAPE, 0, 2).astype(jnp.float32) * 2.0 - 1.0}
    ours = model.test_step(batch, 1, **{k: torch.from_numpy(np.array(v)) for k, v in inject.items()})
    np.testing.assert_allclose(float(ours["fm_loss_sum"]), float(ref["fm_loss_sum"]), rtol=WHOLE_TOL)
    np.testing.assert_allclose(float(ours["bpds"]), float(ref["bpds"]), rtol=BPD_TOL)
    assert float(ours["nfe"]) == float(ref["nfe"]) == M
    a, b = model.test_epoch_end([ours, ours]), jmodel.test_epoch_end([ref, ref])
    assert sorted(a) == sorted(b) == ["avg_num_forward_evaluations", "test_fm_loss", "test_total_bpd"]
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=WHOLE_TOL)
    model.cfg["compute_nll"] = False
    try:
        plain = model.test_step(batch, 1)
    finally:
        model.cfg["compute_nll"] = True
    assert sorted(plain) == ["fm_loss_sum", "num_samples"] and list(model.test_epoch_end([plain])) == ["test_fm_loss"]


def test_bits_per_dimension_refuses_foreign_params_as_jax(pair):
    """Both packages' ``calculate_bits_per_dimension`` take the model's own
    weights only (JAX ``models/rectified_flow.py:151-155``); with them it is
    the likelihood's bits/dim under ``total_bpd``."""
    jmodel, model = pair
    x = np.clip(_x(14), -1.0, 1.0)
    with pytest.raises(NotImplementedError, match="own params"):
        jmodel.calculate_bits_per_dimension(jnp.asarray(x), params=jmodel.ema_params | {})
    with pytest.raises(NotImplementedError, match="own params"):
        model.calculate_bits_per_dimension(torch.from_numpy(x), params=model.ema_params)
    out = model.calculate_bits_per_dimension(torch.from_numpy(x), params=model.params)
    bpd, _z, _nfe = model.likelihood(torch.from_numpy(x))
    assert torch.equal(out["total_bpd"], bpd) and float(out["nfe"]) == M


def test_parallel_sampling_is_not_ported(pair):
    _jmodel, model = pair
    for kw in (dict(mesh=object()), dict(shard_axis="height")):
        with pytest.raises(NotImplementedError, match="not ported"):
            model.sample(1, IMG, **kw)
    assert float(model._example_time()) == 500.0


# -------------------------------------------------------- archives, serving --
def test_archive_restores_across_packages(pair, tmp_path):
    """An archive of either package restores in the other as
    ``RectifiedFlow`` (``extra.yaml``'s model class), with the same weights
    bit for bit and the same sampler."""
    jmodel, model = pair
    from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore

    jback = j_restore(model.save_to(str(tmp_path / "port.dmn")))
    assert type(jback).__name__ == "RectifiedFlow" and jback.sampler.sample_steps == M
    for a, b in zip(jax.tree.leaves(jback.params), jax.tree.leaves(jmodel.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back = restore_model_from_archive(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    assert type(back) is RectifiedFlow and back.sampler.sample_steps == M
    assert all(torch.equal(back.params[k], model.params[k]) for k in model.params)
    outs = [m.sample(2, IMG, generator=torch.Generator().manual_seed(3)) for m in (back, model)]
    assert torch.equal(outs[0], outs[1])


def test_server_serves_the_flow_and_refuses_swaps_and_edit(pair):
    """``RectifiedFlowProcess`` has no schedule table: every DDIM / DPM /
    UniPC / Karras swap is refused, as the JAX server refuses it
    (``serving/server.py:919-927``); ``/sample`` answers with the archive's
    own ODE sampler, the seeded batch equal to ``RectifiedFlow.sample``;
    ``/edit`` is refused (no ``edit``)."""
    _jmodel, model = pair
    assert not hasattr(model.sampler, "constants") and not hasattr(model, "edit")
    for flags in (dict(), dict(use_dpm_solver=True), dict(use_unipc=True), dict(use_karras_sampler=True)):
        with pytest.raises(ValueError, match="use their own ODE sampler"):
            serve(model, port=0, **flags)
    srv = serve(model, port=0, use_ddim_sampler=False, max_batch=2)
    try:
        out = srv.batcher.submit(2, seed=4)
        ref = model.sample(2, IMG, generator=torch.Generator().manual_seed(4), use_ema=True)
        assert np.array_equal(out, to_uint8_tensor(ref).numpy())
        with pytest.raises(ValueError, match="no edit surface"):
            srv.batcher.submit_edit(np.zeros((1, IMG, IMG, 3), np.uint8), strength=0.5)
    finally:
        srv.shutdown()


def test_cascade_takes_a_flow_base():
    """A flow base (4 px) before an SR3 upscaler (4 → 8): the cascade's
    first stage is the flow's ``sample`` with the stage's generator."""
    base = RectifiedFlow(load_config(YAML, overrides=[*TINY[1:], "model.image_size=4"]).model, device="cpu")
    up = SR3(load_config(REPO / "examples/configs/sr3/unet_small.yaml", overrides=[
        "model.image_size=8", "model.timesteps=3", "model.diffusion_model.dim=8",
        "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
        "model.scale_factor=2"]).model, device="cpu", seed=1)
    stages = CascadePipeline(base, [up]).sample(2, seed=5, return_stages=True)
    assert [tuple(s.shape) for s in stages] == [(2, 4, 4, 3), (2, 8, 8, 3)]
    assert torch.equal(stages[0], base.sample(2, 4, generator=stage_generator(5, 0, "cpu")))
