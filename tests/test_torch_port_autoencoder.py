"""The port's KL autoencoder (the latent-diffusion first stage) against the
JAX package on the CPU.

The model is the shipped ``examples/configs/latent_diffusion/autoencoder_kl.yaml``
cut to ``tests/test_latent_diffusion.py``'s tiny size (dim 8, dim_mults
[1, 2], 4 groups, 16 px, z 4; downsample factor 2), float32 unless named.
The JAX model gets the port's weights (``utils/weights.py``: the nested
``encoder/…`` / ``decoder/…`` flax tree). Draws are the JAX step's own
(its key split as the JAX step splits it), fed to the port injected.

What is held:
- ``diagonal_gaussian_sample`` / ``_kl`` with ε injected, logvar past both
  ends of the clip (1e-5), the mode unclipped;
- the encoder, the decoder and the whole autoencoder in float32 (2e-4
  relative L2), and in bf16 (3e-2 relative L2: twice the U-Net's depth);
- the weights both ways, leaf for leaf;
- ``training_step``'s loss, metrics and whole gradient (loss 1e-5, gradient
  2e-4 relative L2), also with dropout (the masks recorded from JAX); ``test_step`` / ``test_epoch_end``; ``reconstruct``,
  ``sample``, ``interpolate`` and ``encode`` (2e-4);
- every service through ``graphs=True`` (the captured call, run eagerly on
  the CPU) equal to ``graphs=False`` bit for bit, a second batch replaying
  the same graph;
- archives both ways; the Trainer's fit with the configured clip and betas.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from torch.func import functional_call

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import AutoencoderKLModel as JAEModel
from diffusion_model_nemo_tpu.modules import autoencoder as JAE
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import AutoencoderKLModel, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.models.autoencoder_kl import first_stage_call
from diffusion_model_nemo_tpu_torch.modules import autoencoder as TAE
from diffusion_model_nemo_tpu_torch.training import Trainer
from diffusion_model_nemo_tpu_torch.training.trainer import param_grads
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params


REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/latent_diffusion/autoencoder_kl.yaml"
IMG, Z, B = 16, 4, 2
TINY = [
    f"model.image_size={IMG}", "model.diffusion_model.dim=8", "model.diffusion_model.dim_mults=[1,2]",
    "model.diffusion_model.resnet_block_groups=4", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=8",
    "model.save_every=0",
]
SHAPE, ZSHAPE = (B, IMG, IMG, 3), (B, IMG // 2, IMG // 2, Z)
OP_TOL, WHOLE_TOL = 1e-5, 2e-4
# The encoder and the decoder in bf16 round about twice the U-Net test's ~40
# intermediates to bf16 (4e-3 relative each, at points that differ between
# torch and XLA): the reconstruction is held to chip_smoke's bf16-forward
# gate, 3e-2 relative L2.
BF16_REL_L2 = 3e-2


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


def _model(extra=()):
    return AutoencoderKLModel(load_config(YAML, overrides=[*TINY, *extra]).model, device="cpu", seed=0)


def _jax_of(model, extra=()):
    jmodel = JAEModel(cfg=j_load_config(YAML, overrides=[*TINY, *extra]).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    jmodel.ema_params = jmodel.params
    return jmodel


@pytest.fixture(scope="module")
def pair():
    model = _model()
    return _jax_of(model), model


def _uniform(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _batch(seed=3, n=B):
    return {"image": np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)}


# ---------------------------------------------------------- the posterior --
def test_gaussian_sample_and_kl_match_jax():
    """logvar in [-40, 30] (past both ends of [-30, 20]); ε is JAX's draw."""
    rng = np.random.default_rng(0)
    mean = rng.standard_normal((3, 4, 4, Z)).astype(np.float32)
    logvar = rng.uniform(-40.0, 30.0, (3, 4, 4, Z)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(key, mean.shape, jnp.float32))
    ref = np.asarray(JAE.diagonal_gaussian_sample(jnp.asarray(mean), jnp.asarray(logvar), key))
    ours = TAE.diagonal_gaussian_sample(torch.from_numpy(mean), torch.from_numpy(logvar), torch.tensor(eps))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=OP_TOL, atol=OP_TOL)
    mode = TAE.diagonal_gaussian_sample(torch.from_numpy(mean), torch.from_numpy(logvar), None)
    assert torch.equal(mode, torch.from_numpy(mean))  # the mode: the mean itself, nothing clipped
    kl_ref = np.asarray(JAE.diagonal_gaussian_kl(jnp.asarray(mean), jnp.asarray(logvar)))
    kl = TAE.diagonal_gaussian_kl(torch.from_numpy(mean), torch.from_numpy(logvar))
    assert kl.shape == (3,)
    np.testing.assert_allclose(kl.numpy(), kl_ref, rtol=OP_TOL)
    assert TAE.LOGVAR_CLIP == JAE.LOGVAR_CLIP


# ------------------------------------------------------------- the network --
def test_networks_match_jax_float32(pair):
    """encode, decode and the whole pass (the draw with JAX's ε)."""
    jmodel, model = pair
    jnet, params = jmodel.diffusion_model, jmodel.params
    x, z = _uniform(1, SHAPE), _uniform(2, ZSHAPE, -2.0, 2.0)
    key = jax.random.PRNGKey(9)

    def ref_fn(p, x, z):
        mean, logvar = jnet.apply({"params": p}, x, method="encode")
        rec, m2, lv2 = jnet.apply({"params": p}, x, key)
        return mean, logvar, jnet.apply({"params": p}, z, method="decode"), rec

    mean_r, logvar_r, dec_r, rec_r = jit0(ref_fn, params, jnp.asarray(x), jnp.asarray(z))
    net, sd = model.diffusion_model, model.params
    with torch.no_grad():
        mean, logvar = first_stage_call(net, sd, "encode", torch.from_numpy(x))
        dec = model.decode(torch.from_numpy(z), graphs=False)
        eps = torch.from_numpy(np.array(jax.random.normal(key, ZSHAPE, jnp.float32)))
        rec, m_full, _ = functional_call(net, sd, (torch.from_numpy(x), eps))
    assert mean.dtype == logvar.dtype == dec.dtype == torch.float32
    for ours, ref in ((mean, mean_r), (logvar, logvar_r), (dec, dec_r), (rec, rec_r)):
        assert tuple(ours.shape) == ref.shape
        assert _rel_l2(ours.numpy(), ref) < WHOLE_TOL
    assert torch.equal(m_full, mean)


def test_network_bf16_matches_jax(pair):
    """The same float32 weights with bf16 compute in both packages: the
    reconstruction within 3e-2 relative L2."""
    jmodel, model = pair
    bf = _model(["model.diffusion_model.dtype=bfloat16"])
    bf.params = model.params
    jbf = _jax_of(bf, ["model.diffusion_model.dtype=bfloat16"])
    x = _uniform(4, SHAPE)
    ref = np.asarray(jit0(lambda p, x: jbf.diffusion_model.apply({"params": p}, x, None)[0], jbf.params,
                          jnp.asarray(x)))
    with torch.no_grad():
        rec = bf.decode(bf.encode(torch.from_numpy(x), graphs=False), graphs=False)
    assert _rel_l2(rec.numpy(), ref) < BF16_REL_L2


def test_weights_carry_the_nested_tree_both_ways(pair):
    """A JAX-initialised tree → the port → back, leaf for leaf; the port's
    own state_dict → flax → the port, bit for bit."""
    _jmodel, model = pair
    jnet = JAE.AutoencoderKL(dim=8, dim_mults=(1, 2), z_channels=Z, channels=3, resnet_block_groups=4)
    tree = jax.tree.map(np.asarray, jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))["params"])
    assert set(tree) == {"encoder", "decoder"}
    sd = from_flax_params(tree, model.diffusion_model)
    back = to_flax_params(sd, model.diffusion_model)
    flat_a = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        np.testing.assert_array_equal(flat_b[k], v, err_msg=str(k))
    again = from_flax_params(to_flax_params(model.params, model.diffusion_model), model.diffusion_model)
    assert all(torch.equal(again[k], v) for k, v in model.params.items())


# --------------------------------------------------------------- training --
def test_training_step_matches_jax(pair):
    """The JAX step's loss, metrics and whole gradient, the port fed that
    step's flip and posterior ε (its key split as the JAX step splits it)."""
    jmodel, model = pair
    batch = _batch(6)
    key = jax.random.PRNGKey(11)

    def step(p):
        loss, metrics = jmodel.training_step(p, jax.tree.map(jnp.asarray, batch), key, 0)
        k_pre, k_post, _k_drop = jax.random.split(key, 3)
        draws = {"flip": jax.random.bernoulli(k_pre, 0.5, (B,)),
                 "posterior": jax.random.normal(k_post, ZSHAPE, jnp.float32)}
        return loss, (metrics, draws)

    lowered = jax.jit(jax.value_and_grad(step, has_aux=True)).lower(jmodel.params)
    (jloss, (jmetrics, jdraws)), jgrads = lowered.compile(
        compiler_options={"xla_backend_optimization_level": 0})(jmodel.params)
    drawn = model.draw_training_inputs(SHAPE, torch.Generator().manual_seed(0))
    assert set(drawn) == set(jdraws) and tuple(drawn["posterior"].shape) == ZSHAPE
    draws = {k: torch.from_numpy(np.array(v)) for k, v in jdraws.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, metrics = model.training_step(params, batch, draws)
    grads = param_grads(loss, params)
    assert set(metrics) == {"train_loss", "rec_loss", "kl"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=OP_TOL)
    ours = to_flax_params({k: g.detach() for k, g in grads.items()}, model.diffusion_model)
    assert _rel_l2(_flat(ours), _flat(jgrads)) < WHOLE_TOL


def test_training_step_with_dropout_matches_jax():
    """``dropout: 0.1``: each ResNet block's ``block2`` keep mask recorded
    from the JAX step (the output of its flax Dropout ≠ 0) and injected as
    the port's ``dropout/<site>`` draw; the sites and their shapes are the
    port's ``dropout_shapes``; the loss and whole gradient as above."""
    extra = ["model.diffusion_model.dropout=0.1"]
    model = _model(extra)
    jmodel = _jax_of(model, extra)
    batch = _batch(9)
    key = jax.random.PRNGKey(13)

    def step(p):
        records = {}

        def intercept(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
                records["dropout/" + "/".join(context.module.path[:-1])] = out != 0
            return out

        with nn.intercept_methods(intercept):
            loss, _ = jmodel.training_step(p, jax.tree.map(jnp.asarray, batch), key, 0)
        k_pre, k_post, _k_drop = jax.random.split(key, 3)
        return loss, {"flip": jax.random.bernoulli(k_pre, 0.5, (B,)),
                      "posterior": jax.random.normal(k_post, ZSHAPE, jnp.float32), **records}

    lowered = jax.jit(jax.value_and_grad(step, has_aux=True)).lower(jmodel.params)
    (jloss, jdraws), jgrads = lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(jmodel.params)
    drawn = model.draw_training_inputs(SHAPE, torch.Generator().manual_seed(0))
    assert set(drawn) == set(jdraws) and len(drawn) == 2 + 12  # 6 blocks a half at dim_mults [1, 2]
    assert all(tuple(drawn[k].shape) == jdraws[k].shape for k in drawn)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in jdraws.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, _ = model.training_step(params, batch, draws)
    grads = param_grads(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=OP_TOL)
    ours = to_flax_params({k: g.detach() for k, g in grads.items()}, model.diffusion_model)
    assert _rel_l2(_flat(ours), _flat(jgrads)) < WHOLE_TOL
    no_drop = {k: v for k, v in draws.items() if not k.startswith("dropout/")}
    assert abs(float(model.training_step(model.params, batch, no_drop)[0]) - float(loss.detach())) > 1e-6


def test_test_step_and_epoch_end_match_jax(pair):
    jmodel, model = pair
    batches = [_batch(7, 4), _batch(8, 2)]
    ours = model.test_epoch_end([model.test_step(b, i) for i, b in enumerate(batches)])
    ref = jmodel.test_epoch_end([jmodel.test_step(b, i) for i, b in enumerate(batches)])
    assert set(ours) == set(ref) == {"test_rec_mse", "test_rec_psnr", "test_kl"}
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=WHOLE_TOL)


# --------------------------------------------------------------- services --
def test_services_match_jax(pair):
    """encode (mode; a draw with ε), decode, reconstruct, sample (prior
    draws decoded: the port's z decoded by JAX) and interpolate."""
    jmodel, model = pair
    x01 = _uniform(12, (4, IMG, IMG, 3), 0.0, 1.0)
    key = jax.random.PRNGKey(2)
    eps = np.asarray(jax.random.normal(key, ZSHAPE, jnp.float32))
    x = torch.from_numpy(x01[:B] * 2.0 - 1.0)
    checks = [
        (model.encode(x, graphs=False), jmodel.encode(jnp.asarray(x.numpy()))),
        (model.encode(x, eps=torch.from_numpy(eps), graphs=False), jmodel.encode(jnp.asarray(x.numpy()), key)),
        (model.reconstruct(torch.from_numpy(x01), graphs=False), jmodel.reconstruct(jnp.asarray(x01))),
        (model.interpolate(torch.from_numpy(x01[:B]), torch.from_numpy(x01[B:]), lambd=0.3, graphs=False),
         jmodel.interpolate(jnp.asarray(x01[:B]), jnp.asarray(x01[B:]), lambd=0.3)),
    ]
    for ours, ref in checks:
        assert _rel_l2(ours.numpy(), ref) < WHOLE_TOL
    gen = torch.Generator().manual_seed(4)
    imgs = model.sample(batch_size=B, image_size=IMG, generator=gen, graphs=False)
    z = torch.randn(ZSHAPE, generator=torch.Generator().manual_seed(4))
    ref = np.clip((np.asarray(jmodel.decode(jnp.asarray(z.numpy()))) + 1.0) * 0.5, 0.0, 1.0)
    assert imgs.shape == SHAPE and float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0
    assert _rel_l2(imgs.numpy(), ref) < WHOLE_TOL


def test_captured_services_equal_eager_and_replay(pair):
    """``graphs=True`` (the captured call, eager on the CPU) equals
    ``graphs=False`` bit for bit; a second batch replays the same graphs."""
    _jmodel, model = pair
    model.graphs.clear()
    for seed in (20, 21):
        x01 = torch.from_numpy(_uniform(seed, (4, IMG, IMG, 3), 0.0, 1.0))
        x, z = x01[:B] * 2.0 - 1.0, torch.from_numpy(_uniform(seed + 5, ZSHAPE))
        eps = torch.from_numpy(_uniform(seed + 6, ZSHAPE))
        for fn in (lambda g: model.encode(x, graphs=g), lambda g: model.encode(x, eps=eps, graphs=g),
                   lambda g: model.decode(z, graphs=g), lambda g: model.reconstruct(x01, graphs=g),
                   lambda g: model.interpolate(x01[:B], x01[B:], graphs=g),
                   lambda g: model.sample(B, IMG, generator=torch.Generator().manual_seed(seed), graphs=g)):
            assert torch.equal(fn(True), fn(False))
        if seed == 20:
            graphs = dict(model.graphs)
    assert len(graphs) == 6 and all(model.graphs[k] is g for k, g in graphs.items())
    assert all(g.info["replays"] == 1 for g in graphs.values())


# --------------------------------------------------------------- archives --
def test_archives_both_ways(pair, tmp_path):
    """A port archive restores in JAX and through ``restore_model_from_archive``;
    a JAX archive restores in the port, the weights equal leaf for leaf."""
    jmodel, model = pair
    path = model.save_to(str(tmp_path / "port_ae.dmn"))
    jback = JAEModel.restore_from(path)
    assert _rel_l2(_flat(jback.params), _flat(jmodel.params)) == 0.0
    generic = restore_model_from_archive(path, device="cpu")
    assert type(generic) is AutoencoderKLModel
    assert all(torch.equal(generic.params[k], v) for k, v in model.params.items())
    jpath = jmodel.save_to(str(tmp_path / "jax_ae.dmn"))
    back = AutoencoderKLModel.restore_from(jpath, device="cpu")
    assert all(torch.equal(back.params[k], v) for k, v in model.params.items())
    assert back.kl_weight == jmodel.kl_weight == 1e-6


def test_trainer_fits_the_autoencoder_with_its_configured_optimizer(tmp_path):
    """``Trainer.fit`` on the AE (no timestep): the configured clip 1.0 and
    AdamW betas (0.9, 0.98), the metrics logged, the weights moved, a
    prior-decode dump written."""
    model = _model([f"+model.results_dir={tmp_path}/results", "model.save_every=2"])
    cfg = load_config(YAML, overrides=TINY)
    start = {k: v.clone() for k, v in model.params.items()}
    trainer = Trainer(**dict(cfg.trainer, max_steps=2, log_every_n_steps=1, accelerator="cpu"))
    assert trainer.gradient_clip_val == 1.0 and tuple(cfg.model.optim.betas) == (0.9, 0.98)
    trainer.fit(model)
    assert trainer.optimizer.b1 == 0.9 and trainer.optimizer.b2 == 0.98
    assert [m["global_step"] for m in trainer.logged] == [1, 2]
    assert all({"train_loss", "rec_loss", "kl", "grad_norm"} <= set(m) for m in trainer.logged)
    assert any(not torch.equal(model.params[k], v) for k, v in start.items())
    assert sorted(p.name for p in (tmp_path / "results").glob("*.png")) == ["sample-1-1.png"]
