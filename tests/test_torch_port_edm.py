"""The port's EDM family (``EDMProcess``, ``EDMLoss``, the non-leaky
augmentation and ``EDM``) against the JAX package on the CPU.

The model is the shipped ``examples/configs/edm/unet_small.yaml`` cut to a
tiny float32 U-Net (dim 8, dim_mults [1, 2], 8 px) with a σ grid of M = 4;
the JAX model gets the port's weights (``utils/weights.py``), no flax init.
Inputs are numpy-seeded; the port is fed the JAX draws: the churn noise of
the JAX scan (one split a step after the prior's), the Hutchinson probe,
σ's normal draws, the noise, the flip, the augmentation descriptor and the
dropout masks (read from the JAX step by intercepting
``flax.linen.Dropout.__call__``).

Tolerances: the host tables (σ grid, solver coefficients) bit for bit; the
process's float32 pieces and the loss 1e-5; the network-level denoiser 2e-4
(ROADMAP's north star); the chains, encode, interpolation and frames 1e-3
(the DDIM chain's, tests/test_torch_port_fast_samplers.py); bits/dim 1e-4
relative; the training step's loss 1e-5 and its whole gradient 2e-4
relative L2 (tests/test_torch_export.py:78). The captured loops run eagerly
on the CPU (``graphs=True``) and equal the Python loops bit for bit.
"""

from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.data.augment import apply_augment as j_apply_augment
from diffusion_model_nemo_tpu.data.augment import sample_augment_labels as j_sample_augment_labels
from diffusion_model_nemo_tpu.loss import EDMLoss as JEDMLoss
from diffusion_model_nemo_tpu.models import EDM as JEDM
from diffusion_model_nemo_tpu.modules import EDMProcess as JEDMProcess
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.data.augment import AUGMENT_DIM, apply_augment, augment_pipe
from diffusion_model_nemo_tpu_torch.loss import EDMLoss
from diffusion_model_nemo_tpu_torch.models import EDM, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules import EDMProcess
from diffusion_model_nemo_tpu_torch.serving import serve
from diffusion_model_nemo_tpu_torch.training.trainer import param_grads
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/edm/unet_small.yaml"
M, IMG, B = 4, 8, 2
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={M}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=16",
]
OP_TOL = 1e-5  # float32 ops
WHOLE_TOL = 2e-4  # whole float32 network
CHAIN_TOL = 1e-3  # a chain of network calls (the DDIM chain's)
BPD_TOL = 1e-4  # bits/dim, relative


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
    return EDM(load_config(YAML, overrides=[*TINY, *extra]).model, device="cpu", seed=0)


def _jax_of(model, extra=()):
    """The JAX model with the port's weights."""
    jmodel = JEDM(cfg=j_load_config(YAML, overrides=[*TINY, *extra]).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    jmodel.ema_params = jmodel.params
    return jmodel


@pytest.fixture(scope="module")
def pair():
    model = _model()
    return _jax_of(model), model


def jit0(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimization level 0
    (half the compile time of a U-Net graph on the CPU; the numbers move
    ~1e-8)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _x(seed=1, shape=(B, IMG, IMG, 3), scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jax_churn_noise(key, steps, shape):
    """The JAX scan's churn draws: after the prior's split, one split a step
    (the final Euler step's included), each a flat [B, H·W·C] normal."""
    key, _ = jax.random.split(key)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (shape[0], int(np.prod(shape[1:]))), jnp.float32)))
    return torch.from_numpy(np.stack(out).reshape((steps, *shape)))


# ------------------------------------------------------------ the process --
def test_process_pieces_match_jax():
    """precond, λ, the network time (negative below σ = 1), the training σ
    from the same normal draws, q_sample."""
    ours, ref = EDMProcess(device="cpu"), JEDMProcess()
    sigma = np.asarray([0.002, 0.05, 0.7, 1.0, 3.0, 80.0], np.float32)
    for a, b in zip(ours.precond(torch.from_numpy(sigma)), ref.precond(jnp.asarray(sigma))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=OP_TOL, atol=0)
    for name in ("loss_weight", "model_time"):
        np.testing.assert_allclose(getattr(ours, name)(torch.from_numpy(sigma)).numpy(),
                                   np.asarray(getattr(ref, name)(jnp.asarray(sigma))), rtol=OP_TOL, atol=0)
    assert float(ours.model_time(torch.tensor(0.05))) < 0
    key = jax.random.PRNGKey(3)
    z = np.asarray(jax.random.normal(key, (8,), jnp.float32))
    np.testing.assert_allclose(ours.sigmas_from_normal(torch.from_numpy(z)).numpy(),
                               np.asarray(ref.sample_sigmas(key, 8)), rtol=OP_TOL)
    x0, eps = _x(2), _x(3)
    np.testing.assert_allclose(
        ours.q_sample(torch.from_numpy(x0), torch.from_numpy(sigma[:B]), torch.from_numpy(eps)).numpy(),
        np.asarray(ref.q_sample(jnp.asarray(x0), jnp.asarray(sigma[:B]), jnp.asarray(eps))), rtol=OP_TOL)


@pytest.mark.parametrize("kw", [dict(sample_steps=4), dict(sample_steps=18, s_churn=40.0, s_tmin=0.05, s_tmax=50.0),
                                dict(sample_steps=7, rho=3.0, sigma_min=0.01, sigma_max=20.0, s_churn=1.0,
                                     s_noise=1.007)],
                         ids=["plain", "churn-window", "other-grid"])
def test_sigma_grid_and_solver_coefficients_equal_jax(kw):
    """The host float64 grid and the [M] float32 coefficients bit for bit,
    and encode's ascending grid as the JAX ``encode`` builds it."""
    ours, ref = EDMProcess(device="cpu", **kw), JEDMProcess(**kw)
    assert np.array_equal(ours._sigma_grid(), ref._sigma_grid())
    a, b = ours._solver_coefficients(), ref._solver_coefficients()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == np.float32 and np.array_equal(a[k], b[k]), k
    sig = ref._sigma_grid()[:-1][::-1]
    enc = ours._encode_coefficients()
    assert np.array_equal(enc["sigma_hat"], np.float32(sig[:-1])) and np.array_equal(enc["dt"],
                                                                                        np.float32(sig[1:] - sig[:-1]))


def test_edm_loss_matches_jax_and_the_f_space_identity():
    """Every reduction against JAX (1e-5), λ·c_out² = 1, and the D-space
    loss equal to the F-space unit-weight MSE (1e-5)."""
    proc = EDMProcess(device="cpu")
    sigma = np.asarray([0.01, 2.5], np.float32)
    d, x0, F = _x(4), _x(5), _x(6)
    for red in ("mean", "sum", "none", "batch_mean"):
        ours = EDMLoss(0.5, red)(torch.from_numpy(d), torch.from_numpy(x0), torch.from_numpy(sigma))
        ref = JEDMLoss(0.5, red)(jnp.asarray(d), jnp.asarray(x0), jnp.asarray(sigma))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=OP_TOL)
    s = torch.from_numpy(sigma)
    _c_skip, c_out, _c_in, _ = proc.precond(s)
    np.testing.assert_allclose((EDMLoss().weight(s) * c_out**2).numpy(), 1.0, rtol=1e-6)
    x_sigma = torch.from_numpy(x0) + s[:, None, None, None] * torch.from_numpy(_x(7))
    c_skip, c_out = (c.reshape(-1, 1, 1, 1) for c in proc.precond(s)[:2])
    D = c_skip * x_sigma + c_out * torch.from_numpy(F)
    loss = EDMLoss()
    np.testing.assert_allclose(float(loss.f_space(torch.from_numpy(F), x_sigma, torch.from_numpy(x0), s)),
                               float(loss(D, torch.from_numpy(x0), s)), rtol=OP_TOL)
    with pytest.raises(ValueError, match="reduction"):
        EDMLoss(reduction="median")


def test_denoiser_matches_jax(pair):
    jmodel, model = pair
    x, sigma = _x(8, scale=3.0), np.asarray([0.03, 6.0], np.float32)
    with torch.inference_mode():
        ours = model.sampler.denoise(model.get_model_fn(), model.params, torch.from_numpy(x), torch.from_numpy(sigma))
    ref = jit0(lambda p, x, s: jmodel.sampler.denoise(jmodel.get_model_fn(), p, x, s),
               jmodel.params, jnp.asarray(x), jnp.asarray(sigma))
    assert _rel_l2(ours.numpy(), ref) < WHOLE_TOL


# ----------------------------------------------------------------- chains --
CHAINS = [("heun", 2.0), ("euler", 2.0)]  # the churn-free Heun chain is encode's step and the served chain's


@pytest.mark.parametrize("solver,churn", CHAINS, ids=["heun-churn", "euler-churn"])
def test_chain_and_frames_match_jax(pair, solver, churn):
    """Algorithm 2 from the same x_T (the JAX scan's churn draws injected):
    the images and every frame within 1e-3; the captured step, run eagerly,
    equals the Python loop bit for bit."""
    jmodel, model = pair
    kw = dict(sample_steps=M, solver=solver, s_churn=churn)
    ours_s, ref_s = EDMProcess(device="cpu", **kw), JEDMProcess(**kw)
    shape = (B, IMG, IMG, 3)
    x_T = torch.from_numpy(_x(9, scale=80.0))
    key = jax.random.PRNGKey(5)
    noise = _jax_churn_noise(key, M, shape)
    with torch.inference_mode():
        outs = [ours_s.p_sample_loop(model.get_model_fn(), model.params, shape, img=x_T, graphs=g,
                                     return_frames=True, noise=noise) for g in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    ref, ref_frames = jit0(lambda p, img: ref_s.p_sample_loop(jmodel.get_model_fn(), p, shape, key, img=img,
                                                              return_frames=True),
                           jmodel.params, jnp.asarray(x_T.numpy()))
    out, frames = outs[0]
    assert frames.shape == (M, *shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    np.testing.assert_allclose(frames.numpy(), np.asarray(ref_frames), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    with torch.inference_mode():  # the draws reach the chain
        other = ours_s.p_sample_loop(model.get_model_fn(), model.params, shape, img=x_T, noise=noise * 0)
    assert not torch.equal(other, out)


def test_churn_free_chain_draws_nothing(pair):
    """``s_churn = 0`` draws no churn noise: the generator is left as it was."""
    _jmodel, model = pair
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    with torch.inference_mode():
        model.sampler.p_sample_loop(model.get_model_fn(), model.params, (1, IMG, IMG, 3), g,
                                    img=torch.zeros(1, IMG, IMG, 3))
    assert torch.equal(g.get_state(), state)


def test_encode_and_interpolate_match_jax(pair):
    """``encode`` (Heun up the ascending grid) and ``interpolate`` (encode,
    slerp, decode) from the same images, within 1e-3."""
    jmodel, model = pair
    x1, x2 = (np.clip(_x(s) * 0.3 + 0.5, 0.0, 1.0) for s in (10, 11))
    z = model.encode(torch.from_numpy(x1 * 2 - 1))
    fn, proc = jmodel.get_model_fn(), jmodel.sampler
    ref_z, ref = jit0(lambda p, a, b: (proc.encode(fn, p, a * 2.0 - 1.0),
                                       proc.interpolate(fn, p, a, b, jax.random.PRNGKey(0), lambd=0.3)),
                      jmodel.params, jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    assert torch.equal(z, model.encode(torch.from_numpy(x1 * 2 - 1), graphs=False))
    out = model.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), lambd=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)


def test_likelihood_matches_jax(pair):
    """Bits/dim, the latent and the NFE (2(M − 1) for Heun) of the
    fixed-grid probability-flow NLL with the JAX probe; the captured step
    (forward and backward) equals the Python loop bit for bit."""
    jmodel, model = pair
    x = np.clip(_x(12) * 0.4, -1.0, 1.0)
    key = jax.random.PRNGKey(7)
    fn = jmodel._bind_classes(None)
    ref_bpd, ref_z, ref_nfe = jit0(lambda p, x: jmodel.sampler.likelihood(fn, p, x, key), jmodel.params, jnp.asarray(x))
    eps = torch.from_numpy(np.asarray(jax.random.randint(key, x.shape, 0, 2), np.float32) * 2.0 - 1.0)
    runs = [model.likelihood(torch.from_numpy(x), epsilon=eps, graphs=g) for g in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    bpd, z, nfe = runs[0]
    np.testing.assert_allclose(bpd.numpy(), np.asarray(ref_bpd), rtol=BPD_TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    assert float(nfe) == float(ref_nfe) == 2 * (M - 1)


# ----------------------------------------------------------- augmentation --
def test_apply_augment_matches_jax_and_zero_is_the_identity():
    """Descriptors drawn by the JAX sampler (every transform on, p = 1, both
    flips) resample as in JAX (1e-5); the zero descriptor gives the input
    bit for bit; ``p = 0`` returns the input itself."""
    imgs = _x(13, shape=(4, IMG, 6, 3))
    labels = np.asarray(j_sample_augment_labels(jax.random.PRNGKey(1), 4, 1.0, yflip=True))
    assert labels.shape == (4, AUGMENT_DIM) and (labels[:, :8] != 0).any(axis=0)[[0, 2, 3, 4, 6, 7]].all()
    ours = apply_augment(torch.from_numpy(imgs), torch.from_numpy(labels))
    ref = j_apply_augment(jnp.asarray(imgs), jnp.asarray(labels))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=OP_TOL, atol=OP_TOL)
    zero = apply_augment(torch.from_numpy(imgs), torch.zeros(4, AUGMENT_DIM))
    assert torch.equal(zero, torch.from_numpy(imgs))
    x = torch.from_numpy(imgs)
    same, desc = augment_pipe(x, None, 0.0)
    assert same is x and not desc.any() and desc.shape == (4, AUGMENT_DIM)


# ---------------------------------------------------------- training step --
AUG = ["+model.augment_prob=0.5", "+model.diffusion_model.aug_dim=9", "model.diffusion_model.dropout=0.1"]


def _site(path) -> str:
    """A flax Dropout path as the port's site key (a ResNet block's
    ``<block>/block2``)."""
    key = "/".join(path)
    return key[: -len("/Dropout_0")] if key.endswith("/block2/Dropout_0") else key


def _with_masks(fn):
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


def edm_draws(key, shape, p, label_mask_p=None):
    """The draws of the JAX EDM step's key: the flip, σ's normal draws, the
    noise, the augmentation descriptor (``fold_in(key, "aug")``) and, for
    the conditional family, the label mask."""
    k_pre, k_sig, k_noise, k_drop = jax.random.split(key, 4)
    out = {"flip": jax.random.bernoulli(k_pre, 0.5, (shape[0],)),
           "sigma_z": jax.random.normal(k_sig, (shape[0],), jnp.float32),
           "noise": jax.random.normal(k_noise, shape, jnp.float32)}
    if p:
        out["augment"] = j_sample_augment_labels(jax.random.fold_in(key, 0x617567), shape[0], p)
    if label_mask_p is not None:
        k_mask, _ = jax.random.split(k_drop)
        out["label_mask"] = jax.random.bernoulli(k_mask, label_mask_p, (shape[0],))
    return out


def run_training_step_parity(model, jmodel, draws_of, seed=11):
    """The port's step fed the JAX step's draws and masks against the JAX
    ``training_step``: the loss (1e-5) and the whole gradient (2e-4)."""
    jparams = jmodel.params
    rng = np.random.default_rng(3)
    batch = {"image": rng.integers(0, 256, (4, IMG, IMG, 3), dtype=np.uint8),
             "label": rng.integers(0, 4, 4).astype(np.int32)}
    key = jax.random.PRNGKey(seed)
    b = jax.tree.map(jnp.asarray, batch)
    shape = (4, IMG, IMG, 3)

    def step(p):
        (loss, _metrics), masks = _with_masks(lambda q: jmodel.training_step(q, b, key, 0))(p)
        return loss, (masks, draws_of(key, shape))

    lowered = jax.jit(jax.value_and_grad(step, has_aux=True)).lower(jparams)
    (jloss, (masks, jdraws)), jgrads = lowered.compile(
        compiler_options={"xla_backend_optimization_level": 0})(jparams)
    drawn = model.draw_training_inputs(shape, torch.Generator().manual_seed(0))
    assert {k for k in drawn if not k.startswith("dropout/")} == set(jdraws)
    assert {k[len("dropout/"):]: tuple(v.shape) for k, v in drawn.items() if k.startswith("dropout/")} == \
        {k: tuple(v.shape) for k, v in masks.items()}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in jdraws.items()}
    draws.update({f"dropout/{k}": torch.from_numpy(np.array(v)) for k, v in masks.items()})
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, _ = model.training_step(params, batch, draws)
    grads = param_grads(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=OP_TOL)
    ours = to_flax_params({k: g.detach() for k, g in grads.items()}, model.diffusion_model)
    flat = lambda tree: np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])  # noqa: E731
    assert _rel_l2(flat(ours), flat(jax.tree.map(np.asarray, jgrads))) < WHOLE_TOL
    return model, batch, draws, float(loss.detach())


def test_training_step_with_augmentation_matches_jax():
    """The augmented step (p = 0.5, aug_dim 9, dropout 0.1) against the JAX
    step; the descriptor reaches both the images and the network."""
    model = _model(AUG)
    params = dict(model.params)
    g = torch.Generator().manual_seed(1)
    params["aug_embed.weight"] = torch.randn(params["aug_embed.weight"].shape, generator=g) * 0.3
    model.params = params
    jmodel = _jax_of(model, AUG)
    model, batch, draws, loss = run_training_step_parity(model, jmodel, lambda k, s: edm_draws(k, s, 0.5))
    assert draws["augment"].abs().sum() > 0
    plain = dict(draws, augment=torch.zeros_like(draws["augment"]))
    assert abs(float(model.training_step(model.params, batch, plain)[0]) - loss) > 1e-6


def test_test_step_and_epoch_end_match_jax(pair):
    """The held-out λ-weighted loss of one batch with the draws of the JAX
    step's ``PRNGKey(batch_nb)``, against JAX's; under ``compute_nll`` the
    step adds the likelihood's bits/dim (held to JAX's in
    ``test_likelihood_matches_jax``) and NFE; ``test_epoch_end`` reports
    JAX's keys and values."""
    jmodel, model = pair
    rng = np.random.default_rng(4)
    batch = {"image": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)}
    ref = jmodel.test_step(batch, 1)
    k_loss, k_nll = jax.random.split(jax.random.PRNGKey(1))
    k_sig, k_noise = jax.random.split(k_loss)
    shape = (B, IMG, IMG, 3)
    inject = {"sigma_z": jax.random.normal(k_sig, (B,), jnp.float32),
              "noise": jax.random.normal(k_noise, shape, jnp.float32),
              "epsilon": jax.random.randint(k_nll, shape, 0, 2).astype(jnp.float32) * 2.0 - 1.0}
    inject = {k: torch.from_numpy(np.array(v)) for k, v in inject.items()}
    ours = model.test_step(batch, 1, **inject)
    np.testing.assert_allclose(float(ours["edm_loss_sum"]), float(ref["edm_loss_sum"]), rtol=WHOLE_TOL)
    a, b = model.test_epoch_end([ours]), jmodel.test_epoch_end([ref])
    assert sorted(a) == sorted(b) == ["test_edm_loss"]
    np.testing.assert_allclose(a["test_edm_loss"], b["test_edm_loss"], rtol=WHOLE_TOL)
    model.cfg["compute_nll"] = True
    try:
        nll = model.test_step(batch, 1, **inject)
    finally:
        model.cfg["compute_nll"] = False
    samples = torch.from_numpy(batch["image"]).float() / 127.5 - 1.0
    bpd, _z, nfe = model.likelihood(samples, epsilon=inject["epsilon"])
    assert float(nll["bpds"]) == float(bpd.sum()) and float(nll["nfe"]) == float(nfe) == 2 * (M - 1)
    assert float(nll["edm_loss_sum"]) == float(ours["edm_loss_sum"])
    c = model.test_epoch_end([nll, nll])
    assert sorted(c) == ["avg_num_forward_evaluations", "test_edm_loss", "test_total_bpd"]
    assert c["avg_num_forward_evaluations"] == 2 * (M - 1)


# ------------------------------------------------- kept JAX behaviour, refusals --
def test_bits_per_dimension_refuses_foreign_params_as_jax(pair):
    """Both packages' ``calculate_bits_per_dimension`` take the model's own
    weights only (JAX ``models/edm.py:197-201``); with them it is the
    likelihood's bits/dim under ``total_bpd``, the first 32 images."""
    jmodel, model = pair
    x = np.clip(_x(14), -1.0, 1.0)
    with pytest.raises(NotImplementedError, match="own params"):
        jmodel.calculate_bits_per_dimension(jnp.asarray(x), params=jmodel.ema_params | {})
    with pytest.raises(NotImplementedError, match="own params"):
        model.calculate_bits_per_dimension(torch.from_numpy(x), params=model.ema_params)
    out = model.calculate_bits_per_dimension(torch.from_numpy(x), params=model.params)
    assert out["total_bpd"].shape == (B,) and float(out["nfe"]) == 2 * (M - 1)


def test_misconfigurations_are_refused_as_jax():
    for extra, match in ((["+model.augment_prob=0.1"], "aug_dim"), (["model.loss.sigma_data=0.7"], "must match")):
        cfg = [*TINY, *extra]
        with pytest.raises(ValueError, match=match):
            JEDM(cfg=j_load_config(YAML, overrides=cfg).model)
        with pytest.raises(ValueError, match=match):
            EDM(load_config(YAML, overrides=cfg).model, device="cpu")


# -------------------------------------------------------- archives, serving --
def test_archive_restores_across_packages(pair, tmp_path):
    """An archive of either package restores in the other as ``EDM``
    (``extra.yaml``'s model class), with the same weights bit for bit, so
    the same outputs (the port's restored denoiser equals the original's
    bit for bit; ``test_denoiser_matches_jax`` holds it to JAX's)."""
    jmodel, model = pair
    port_path = model.save_to(str(tmp_path / "port.dmn"))
    from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore

    jback = j_restore(port_path)
    assert type(jback).__name__ == "EDM"
    for a, b in zip(jax.tree.leaves(jback.params), jax.tree.leaves(jmodel.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jax_path = jmodel.save_to(str(tmp_path / "jax.dmn"))
    back = restore_model_from_archive(jax_path, device="cpu")
    assert type(back) is EDM
    assert all(torch.equal(back.params[k], model.params[k]) for k in model.params)
    x, sigma = torch.from_numpy(_x(15)), torch.tensor([0.5, 4.0])
    with torch.inference_mode():
        outs = [m.sampler.denoise(m.get_model_fn(), m.params, x, sigma) for m in (back, model)]
    assert torch.equal(outs[0], outs[1])


def test_server_refuses_sampler_swaps_and_serves_the_archives_sampler(pair):
    """``EDMProcess`` has no schedule table (``constants``): every DDIM / DPM
    / UniPC / Karras swap is refused, as the JAX server refuses it; with
    ``use_ddim_sampler=False`` the server answers with the archive's own
    Algorithm 2, the seeded batch equal to ``EDM.sample``."""
    _jmodel, model = pair
    assert not hasattr(model.sampler, "constants")
    for flags in (dict(), dict(use_dpm_solver=True), dict(use_unipc=True), dict(use_karras_sampler=True)):
        with pytest.raises(ValueError, match="use their own ODE sampler"):
            serve(model, port=0, **flags)
    srv = serve(model, port=0, use_ddim_sampler=False, max_batch=2)
    try:
        out = srv.batcher.submit(2, seed=4)
        ref = model.sample(2, IMG, generator=torch.Generator().manual_seed(4), use_ema=True)
        from diffusion_model_nemo_tpu_torch.utils.image import to_uint8_tensor

        assert np.array_equal(out, to_uint8_tensor(ref).numpy())
    finally:
        srv.shutdown()
