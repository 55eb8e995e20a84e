"""The port's LatentDiffusion against the JAX package on the CPU.

The model is the shipped ``examples/configs/latent_diffusion/latent_ddpm.yaml``
cut to ``tests/test_latent_diffusion.py``'s tiny size (T = 6; a U-Net of
dim 8, [1, 2], 4 groups on the 8×8×4 latent of a 16 px image), float32,
over a first stage restored from an autoencoder archive the port writes
(``tests/test_torch_port_autoencoder.py``'s tiny AE, factor 2), which both
packages read. The JAX model gets the port's U-Net weights. Draws are
numpy- or torch-seeded and fed to both, or the JAX step's own, fed to the
port injected.

What is held:
- the geometry and the JAX checks (channels, divisibility, a missing or
  empty ``first_stage``);
- ``calibrate_scale_factor`` (the population std) against JAX (1e-5);
- ``training_step`` with the posterior draw and with the mode (loss 1e-5,
  gradient 2e-4 relative L2); the first stage frozen, outside the
  optimizer's, the EMA's and the checkpoint's state;
- the ancestral chain and DDIM-3 (a swap) with their decode (1e-3), each
  captured chain equal to its eager loop; the latent x̂₀ clip pinned;
- ``interpolate`` (1e-3) and ``test_step`` / ``test_epoch_end`` (1e-5);
  the refusals (``return_frames``, ``inpaint``, ``mesh``, ``edit``, which
  JAX's inherited method fails at, and pixel bits/dim);
- a changed scale factor reaching the next captured sample, nothing
  captured anew;
- the self-contained archive both ways and through
  ``restore_model_from_archive``, the autoencoder file gone;
- the three CLIs end to end at B = 4; ``/sample`` from a latent archive.
"""

import json
import shutil
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import LatentDiffusion as JLD
from diffusion_model_nemo_tpu.modules.generalized_gaussian_diffusion import (
    GeneralizedGaussianDiffusion as JGeneralized,
)
from diffusion_model_nemo_tpu_torch.cli import eval_latent_ddpm, train_autoencoder_kl, train_latent_ddpm
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import AutoencoderKLModel, LatentDiffusion, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.serving import serve
from diffusion_model_nemo_tpu_torch.training import Trainer
from diffusion_model_nemo_tpu_torch.training.trainer import param_grads
from diffusion_model_nemo_tpu_torch.utils.image import to_uint8_tensor
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/latent_diffusion/latent_ddpm.yaml"
AE_YAML = REPO / "examples/configs/latent_diffusion/autoencoder_kl.yaml"
IMG, Z, T, B = 16, 4, 6, 2
AE_TINY = [
    f"model.image_size={IMG}", "model.diffusion_model.dim=8", "model.diffusion_model.dim_mults=[1,2]",
    "model.diffusion_model.resnet_block_groups=4", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=8",
]
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.resnet_block_groups=4",
    f"model.diffusion_model.input_dim={IMG // 2}", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=8",
    "model.save_every=0", "model.scale_factor=0.8",
]
SHAPE, ZSHAPE = (B, IMG, IMG, 3), (B, IMG // 2, IMG // 2, Z)
DDIM = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
OP_TOL, WHOLE_TOL, CHAIN_TOL = 1e-5, 2e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jit0(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimization level 0."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(a)) for a in jax.tree.leaves(tree)])


def _uniform(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _batch(seed=3, n=B):
    return {"image": np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)}


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def ae_archive(tmp_path_factory):
    """A tiny first stage written by the port (its weights random, seed 5)."""
    ae = AutoencoderKLModel(load_config(AE_YAML, overrides=AE_TINY).model, device="cpu", seed=5)
    return ae.save_to(str(tmp_path_factory.mktemp("ae") / "ae.dmn"))


def _overrides(ae_path, extra=()):
    return [*TINY, f"model.first_stage.restore_from={ae_path}", *extra]


def _model(ae_path, extra=()):
    return LatentDiffusion(load_config(YAML, overrides=_overrides(ae_path, extra)).model, device="cpu", seed=0)


def _jax_of(model, ae_path, extra=()):
    jmodel = JLD(cfg=j_load_config(YAML, overrides=_overrides(ae_path, extra)).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    jmodel.ema_params = jmodel.params
    return jmodel


@pytest.fixture(scope="module")
def pair(ae_archive):
    model = _model(ae_archive)
    model.base_sampler = dict(model.cfg.sampler)
    return _jax_of(model, ae_archive), model


# ------------------------------------------------------------ construction --
def test_geometry_and_the_jax_checks(pair, ae_archive):
    jmodel, model = pair
    assert (model.latent_size, model.latent_channels) == (jmodel.latent_size, jmodel.latent_channels) == (8, Z)
    assert model._example_spatial_size() == jmodel._example_spatial_size() == 8
    assert model.diffusion_model.init_conv.weight.shape[1] == Z  # the U-Net is built on the latent
    assert model.scale_factor == pytest.approx(0.8) and jmodel.scale_factor == 0.8
    assert all(not v.requires_grad for v in model.first_stage_params.values())
    for extra, match in ((["model.diffusion_model.channels=5"], "z_channels"),
                         (["model.image_size=17"], "not divisible")):
        for build in (lambda: _model(ae_archive, extra),
                      lambda: JLD(cfg=j_load_config(YAML, overrides=_overrides(ae_archive, extra)).model)):
            with pytest.raises(ValueError, match=match):
                build()
    cfg = load_config(YAML, overrides=_overrides(ae_archive)).model
    cfg["first_stage"] = {"use_ema": True}
    with pytest.raises(ValueError, match="restore_from: <path> or autoencoder"):
        LatentDiffusion(cfg, device="cpu")
    del cfg["first_stage"]
    with pytest.raises(ValueError, match="requires cfg.first_stage"):
        LatentDiffusion(cfg, device="cpu")


def test_calibrate_scale_factor_matches_jax(ae_archive):
    """1 / the population std of one batch's posterior means, into ``cfg``
    and the factor's buffer."""
    model = _model(ae_archive)
    jmodel = _jax_of(model, ae_archive)
    batch = _batch(4, 8)
    ours, ref = model.calibrate_scale_factor(batch), jmodel.calibrate_scale_factor(batch)
    np.testing.assert_allclose(ours, ref, rtol=OP_TOL)
    assert model.cfg["scale_factor"] == ours and model.scale_factor == pytest.approx(ours, rel=1e-7)
    mean = model.encode_to_latent(torch.from_numpy(batch["image"]).float() / 127.5 - 1.0) / model._scale
    np.testing.assert_allclose(ours, 1.0 / np.std(mean.numpy().astype(np.float64)), rtol=OP_TOL)


# --------------------------------------------------------------- training --
@pytest.mark.parametrize("posterior", [True, False])
def test_training_step_matches_jax(ae_archive, posterior):
    """The JAX step's loss and whole gradient, the port fed its flip,
    posterior ε, t and noise (its key split as the JAX step splits it); the
    gradient has the U-Net's keys only."""
    extra = [f"model.posterior_sample={str(posterior).lower()}"]
    model = _model(ae_archive, extra)
    jmodel = _jax_of(model, ae_archive, extra)
    batch = _batch(6)
    key = jax.random.PRNGKey(11)

    def step(p):
        loss, _ = jmodel.training_step(p, jax.tree.map(jnp.asarray, batch), key, 0)
        k_pre, k_enc, k_t, k_noise, _k_drop = jax.random.split(key, 5)
        draws = {"flip": jax.random.bernoulli(k_pre, 0.5, (B,)),
                 "t": jax.random.randint(k_t, (B,), 0, T, dtype=jnp.int32),
                 "noise": jax.random.normal(k_noise, ZSHAPE, jnp.float32)}
        if posterior:
            draws["posterior"] = jax.random.normal(k_enc, ZSHAPE, jnp.float32)
        return loss, draws

    lowered = jax.jit(jax.value_and_grad(step, has_aux=True)).lower(jmodel.params)
    (jloss, jdraws), jgrads = lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(jmodel.params)
    drawn = model.draw_training_inputs(SHAPE, _gen(0))
    assert set(drawn) == set(jdraws) and tuple(drawn["noise"].shape) == ZSHAPE
    draws = {k: torch.from_numpy(np.array(v)) for k, v in jdraws.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, metrics = model.training_step(params, batch, draws)
    grads = param_grads(loss, params)
    assert set(metrics) == {"train_loss"} and set(grads) == set(model.diffusion_model.state_dict())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=OP_TOL)
    ours = to_flax_params({k: g.detach() for k, g in grads.items()}, model.diffusion_model)
    assert _rel_l2(_flat(ours), _flat(jgrads)) < WHOLE_TOL


def test_the_first_stage_stays_out_of_the_trained_state(ae_archive, tmp_path):
    """Two fitted steps: the optimizer's moments, the EMA and the
    checkpoint hold the U-Net's tensors only; the first stage is unchanged
    and the step's graph is held to it (``frozen_tensors``)."""
    model = _model(ae_archive)
    before = {k: v.clone() for k, v in model.first_stage_params.items()}
    trainer = Trainer(max_steps=2, log_every_n_steps=1)
    state = trainer.init_state(model, 2)
    unet = set(model.diffusion_model.state_dict())
    moments = [set(d) for d in state.opt_state.values() if isinstance(d, dict)]
    assert moments and all(m == unet for m in moments) and set(state.ema_params) == unet == set(state.params)
    ckpt = Trainer.checkpoint_state(state, _gen(), 4)
    assert set(ckpt["params"]) == set(ckpt["ema_params"]) == unet
    trainer.fit(model, graphs=True)
    assert [m["global_step"] for m in trainer.logged] == [1, 2]
    assert all(torch.equal(model.first_stage_params[k], v) for k, v in before.items())
    assert model.frozen_tensors() and all(not t.requires_grad for t in model.frozen_tensors())


# ----------------------------------------------------------------- chains --
def _decode_ref(jmodel, z):
    return np.clip((np.asarray(jit0(jmodel.decode_from_latent, jmodel.first_stage_params, jnp.asarray(z))) + 1.0)
                   * 0.5, 0.0, 1.0)


def test_ancestral_and_ddim_chains_with_decode_match_jax(pair):
    """``sample`` through the captured-step loop (eager on the CPU) equal to
    its eager loop, and to the JAX steps fed the same x_T and noise, then
    JAX's decode; DDIM-3 (eta 0) after a swap against JAX's scan from the
    same x_T."""
    jmodel, model = pair
    model.change_sampler(model.base_sampler)
    ours = model.sample(B, IMG, generator=_gen(), graphs=True)
    assert torch.equal(ours, model.sample(B, IMG, generator=_gen(), graphs=False))
    model_fn = jmodel.get_model_fn()
    step = jax.jit(lambda p, x, t: tuple(jmodel.sampler.p_mean_variance(model_fn, p, x, t))[::2])
    gen = _gen()
    x = jnp.asarray(torch.randn(ZSHAPE, generator=gen).numpy())
    for t in range(T - 1, -1, -1):
        mean, log_var = step(jmodel.params, x, jnp.int32(t))
        x = mean + (jnp.exp(0.5 * log_var) * jnp.asarray(torch.randn(ZSHAPE, generator=gen).numpy()) if t else 0.0)
    assert ours.shape == SHAPE
    np.testing.assert_allclose(ours.numpy(), _decode_ref(jmodel, x), atol=CHAIN_TOL, rtol=CHAIN_TOL)

    model.change_sampler(dict(model.base_sampler, _target_=DDIM, eta=0.0, ddim_timesteps=3))
    try:
        ours = model.sample(B, IMG, generator=_gen(), graphs=True)
        assert torch.equal(ours, model.sample(B, IMG, generator=_gen(), graphs=False))
        x_T = torch.randn(ZSHAPE, generator=_gen()).numpy()
        ddim = JGeneralized(timesteps=T, schedule_name="cosine", eta=0.0, ddim_timesteps=3)
        z = jit0(lambda p, img: ddim.p_sample_loop(model_fn, p, ZSHAPE, jax.random.PRNGKey(0), img=img,
                                                    unnormalize=False), jmodel.params, jnp.asarray(x_T))
        np.testing.assert_allclose(ours.numpy(), _decode_ref(jmodel, z), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    finally:
        model.change_sampler(model.base_sampler)


def test_the_latent_x0_clip_is_kept(pair):
    """JAX's ``p_mean_variance`` clips the predicted x̂₀ to [-1, 1]
    whatever the space: here the scaled latent, where values past ±1 are
    common. The port clips as JAX does."""
    jmodel, model = pair
    z_t = _uniform(7, ZSHAPE, -3.0, 3.0)
    t = 1
    out = model.sampler.p_mean_variance(model.get_model_fn(), model.params, torch.from_numpy(z_t), t)
    eps = model.model_fn(model.params, torch.from_numpy(z_t), torch.full((B,), t, dtype=torch.int32))
    raw = model.sampler.predict_start_from_noise(torch.from_numpy(z_t), t, eps)
    assert float(raw.abs().max()) > 1.5 and float(out.pred_x_start.abs().max()) == 1.0
    ref = jit0(lambda p, z: jmodel.sampler.p_mean_variance(jmodel.get_model_fn(), p, z, t).pred_x_start,
               jmodel.params, jnp.asarray(z_t))
    np.testing.assert_allclose(out.pred_x_start.numpy(), np.asarray(ref), atol=WHOLE_TOL)


def test_interpolate_matches_jax(pair):
    """Both endpoints' posterior draws (x1's ε, then x2's), their noise to
    t = 3, the lerp, the last 3 ancestral steps and the decode, each draw
    from one generator fed to JAX's pieces in that order."""
    jmodel, model = pair
    x1, x2 = _uniform(8, SHAPE), _uniform(9, SHAPE)
    tt, lambd = 3, 0.3
    ours = model.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), t=tt, lambd=lambd, generator=_gen(),
                             graphs=True)
    gen = _gen()
    draw = lambda: jnp.asarray(torch.randn(ZSHAPE, generator=gen).numpy())  # noqa: E731
    fs, net, s = jmodel.first_stage_params, jmodel.first_stage, jmodel.scale_factor

    def latent(x, eps):
        mean, logvar = net.apply({"params": fs}, jnp.asarray(x), method="encode")
        return (mean + jnp.exp(0.5 * jnp.clip(logvar, -30.0, 20.0)) * eps) * s

    z1, z2 = latent(x1, draw()), latent(x2, draw())
    t_b = jnp.full((B,), tt, jnp.int32)
    zt1, zt2 = jmodel.sampler.q_sample(z1, t_b, draw()), jmodel.sampler.q_sample(z2, t_b, draw())
    x = (1.0 - lambd) * zt1 + lambd * zt2
    model_fn = jmodel.get_model_fn()
    step = jax.jit(lambda p, x, t: tuple(jmodel.sampler.p_mean_variance(model_fn, p, x, t))[::2])
    for t in range(tt - 1, -1, -1):
        mean, log_var = step(jmodel.params, x, jnp.int32(t))
        x = mean + (jnp.exp(0.5 * log_var) * draw() if t else 0.0)
    np.testing.assert_allclose(ours.numpy(), _decode_ref(jmodel, x), atol=CHAIN_TOL, rtol=CHAIN_TOL)


def test_test_step_and_epoch_end_match_jax(pair):
    """The mode latents' loss at the JAX test step's t and noise
    (``PRNGKey(batch_nb)`` split 3 ways)."""
    jmodel, model = pair
    outs, refs = [], []
    for nb, batch in enumerate([_batch(10, 4), _batch(11, 4)]):
        refs.append(jmodel.test_step(batch, nb))
        _k_enc, k_t, k_noise = jax.random.split(jax.random.PRNGKey(nb), 3)
        n = batch["image"].shape[0]
        t = torch.from_numpy(np.array(jax.random.randint(k_t, (n,), 0, T, dtype=jnp.int32)))
        noise = torch.from_numpy(np.array(jax.random.normal(k_noise, (n, *ZSHAPE[1:]), jnp.float32)))
        outs.append(model.test_step(batch, nb, t=t, noise=noise))
        np.testing.assert_allclose(float(outs[-1]["sum_loss"]), float(refs[-1]["sum_loss"]), rtol=OP_TOL)
    ours, ref = model.test_epoch_end(outs), jmodel.test_epoch_end(refs)
    assert set(ours) == set(ref) == {"test_latent_loss"}
    np.testing.assert_allclose(ours["test_latent_loss"], ref["test_latent_loss"], rtol=OP_TOL)


def test_refusals(pair):
    """``return_frames``, ``inpaint``, ``mesh`` and pixel bits/dim raise as
    in JAX (``mesh``: not ported); ``edit``, which the JAX model inherits
    and fails at (its U-Net takes latents), is refused outright."""
    jmodel, model = pair
    x01 = _uniform(12, SHAPE, 0.0, 1.0)
    with pytest.raises(NotImplementedError, match="latent space"):
        model.sample(B, IMG, return_frames=True)
    with pytest.raises(NotImplementedError):
        jmodel.sample(B, IMG, return_frames=True)
    with pytest.raises(NotImplementedError, match="pixel-space DDPM"):
        model.inpaint(torch.from_numpy(x01), torch.ones(SHAPE))
    with pytest.raises(NotImplementedError, match="not ported"):
        model.sample(B, IMG, mesh=object())
    with pytest.raises(NotImplementedError, match="pixel NLL"):
        model.calculate_bits_per_dimension(torch.from_numpy(x01))
    with pytest.raises(Exception):
        jmodel.edit(jnp.asarray(x01), strength=0.5)
    with pytest.raises(NotImplementedError, match="U-Net takes latents"):
        model.edit(torch.from_numpy(x01), strength=0.5)


def test_a_new_scale_factor_reaches_the_next_captured_sample(pair):
    """A sample captures its graphs; a recalibrated factor (the buffer
    refilled) reaches the next replay, which equals a fresh eager chain
    with that factor bit for bit, and no graph is captured anew."""
    _jmodel, model = pair
    model.change_sampler(model.base_sampler)
    old = model.scale_factor
    first = model.sample(B, IMG, generator=_gen(5), graphs=True)
    graphs = {**model.graphs, **model.sampler.graphs}
    try:
        model.calibrate_scale_factor(_batch(13, 4))
        assert model.scale_factor != old
        again = model.sample(B, IMG, generator=_gen(5), graphs=True)
        assert {**model.graphs, **model.sampler.graphs}.keys() == graphs.keys()
        assert all(({**model.graphs, **model.sampler.graphs})[k] is g for k, g in graphs.items())
        assert torch.equal(again, model.sample(B, IMG, generator=_gen(5), graphs=False))
        assert not torch.equal(again, first)
    finally:
        model._scale.fill_(old)
        model.cfg["scale_factor"] = old


# --------------------------------------------------------------- archives --
def test_self_contained_archive_both_ways(ae_archive, tmp_path):
    """Saved beside a copy of the first stage's archive, which is then
    deleted: the port and JAX restore it, equal weights and scale, the
    port's samples bit for bit; a JAX-written archive restores in the port."""
    ae_copy = shutil.copy(ae_archive, tmp_path / "ae_copy.dmn")
    model = _model(ae_copy)
    model.calibrate_scale_factor(_batch(14, 4))
    path = model.save_to(str(tmp_path / "ld.dmn"))
    jmodel = _jax_of(model, ae_copy)
    jmodel.scale_factor = jmodel.cfg["scale_factor"] = model.scale_factor
    jpath = jmodel.save_to(str(tmp_path / "ld_jax.dmn"))
    Path(ae_copy).unlink()

    imgs = model.sample(B, IMG, generator=_gen(7), graphs=True)
    for back in (LatentDiffusion.restore_from(path, device="cpu"), restore_model_from_archive(path, device="cpu"),
                 LatentDiffusion.restore_from(jpath, device="cpu")):
        assert type(back) is LatentDiffusion
        assert back.scale_factor == pytest.approx(model.scale_factor, rel=1e-7)
        assert all(torch.equal(back.params[k], v) for k, v in model.params.items())
        assert all(torch.equal(back.first_stage_params[k], v) for k, v in model.first_stage_params.items())
        assert torch.equal(back.sample(B, IMG, generator=_gen(7), graphs=True), imgs)
    jback = JLD.restore_from(path)
    assert jback.scale_factor == pytest.approx(model.scale_factor, rel=1e-7)
    assert _rel_l2(_flat(jback.params), _flat(jmodel.params)) == 0.0
    assert _rel_l2(_flat(jback.first_stage_params), _flat(jmodel.first_stage_params)) == 0.0


# ------------------------------------------------------ the CLIs, serving --
def test_latent_clis_train_calibrate_evaluate(tmp_path):
    """``train_autoencoder_kl`` (2 steps, the archive), ``train_latent_ddpm``
    on it (calibrated on the first batch, 2 steps, a self-contained
    archive) and ``eval_latent_ddpm`` with DDIM and DPM-Solver++ at B = 4."""
    common = ["trainer.accelerator=cpu", "trainer.max_steps=2", "model.train_ds.name=synthetic",
              "model.train_ds.batch_size=4", "+model.train_ds.length=8", f"exp_manager.exp_dir={tmp_path / 'exp'}",
              "exp_manager.create_tensorboard_logger=false", "model.save_every=0"]
    ae, ae_trainer = train_autoencoder_kl.main([*AE_TINY[:4], *common])
    assert type(ae) is AutoencoderKLModel and all(np.isfinite(m["train_loss"]) for m in ae_trainer.logged)
    (ae_dmn,) = (tmp_path / "exp").glob("*/*/AutoencoderKL.dmn")
    ld, trainer = train_latent_ddpm.main([*TINY[:7], f"model.first_stage.restore_from={ae_dmn}", *common])
    assert type(ld) is LatentDiffusion and ld.scale_factor != 1.0
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    (dmn,) = (tmp_path / "exp").glob("*/*/LatentDDPM.dmn")
    assert LatentDiffusion.restore_from(str(dmn), device="cpu").scale_factor == pytest.approx(ld.scale_factor)
    for i, swap in enumerate((["ddim_timesteps=3"], ["use_dpm_solver=true", "dpm_steps=3"])):
        out = eval_latent_ddpm.main([f"model_path={dmn}", "batch_size=4", "device=cpu", *swap,
                                     f"output_dir={tmp_path / f'samples{i}'}", "add_timestamp=false"])
        assert sorted(p.name for p in out.iterdir()) == [*(f"sample_{i}.png" for i in range(4)), "samples_grid.png"]


def test_sample_serves_pixels_from_a_latent_archive(pair, tmp_path):
    """``serve`` on a latent archive with DDIM-3: a seeded ``/sample`` batch
    equals ``LatentDiffusion.sample`` at that seed, in pixels at
    ``image_size``; the HTTP route answers."""
    _jmodel, model = pair
    path = model.save_to(str(tmp_path / "ld.dmn"))
    srv = serve(path, port=0, device="cpu", use_ddim_sampler=True, ddim_timesteps=3, max_batch=2)
    try:
        out = srv.batcher.submit(2, seed=4)
        ref_model = srv.batcher.model
        ref = ref_model.sample(2, IMG, generator=torch.Generator().manual_seed(4), use_ema=True)
        assert out.shape == SHAPE and np.array_equal(out, to_uint8_tensor(ref).numpy())
        srv.start_background()
        req = urllib.request.Request(f"http://{srv.host}:{srv.port}/sample", method="POST",
                                     data=json.dumps({"num_images": 1, "seed": 4, "format": "npy"}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200 and len(resp.read()) >= IMG * IMG * 3
    finally:
        srv.shutdown()
