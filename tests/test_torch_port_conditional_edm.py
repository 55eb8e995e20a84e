"""The port's ``ConditionalEDM`` against the JAX package on the CPU, and the
EDM CLIs (``train_edm``, ``eval_edm``, ``test_edm``) end to end.

The same tiny model as tests/test_torch_port_edm.py with ``num_classes =
4``. What is held:

- the training step (the null-class mask, the augmentation and dropout
  draws of the JAX step's key injected): loss 1e-5, whole gradient 2e-4;
- guided sampling (label 2, w = 3: one 2B network call an evaluation,
  F_u + w·(F_c − F_u)) from the same x_T against the JAX chain, 1e-3; the
  captured chain equals the eager one bit for bit, and a second label and
  scale replay the same graph (nothing captured anew); an unlabelled chain
  is the null class's;
- the test step with the batch's labels bound (the loss, 2e-4);
- an archive of either package restores in the other as ``ConditionalEDM``;
- the server answers labelled and guided ``/sample`` requests with the
  model's own chain;
- the three CLIs: ``train_edm`` picks ``ConditionalEDM`` under
  ``num_classes`` (``EDM`` without), ``eval_edm`` writes guided samples and
  the trajectory's GIF, ``test_edm`` reports the loss and the ODE bits/dim.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import ConditionalEDM as JConditionalEDM
from diffusion_model_nemo_tpu_torch.cli import eval_edm, test_edm, train_edm
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import EDM, ConditionalEDM, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules.gaussian_diffusion import Conditioned
from diffusion_model_nemo_tpu_torch.serving import serve
from diffusion_model_nemo_tpu_torch.utils.image import decode_png, to_uint8_tensor
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params
from test_torch_port_edm import (  # noqa: F401  (the module-scoped fixture)
    AUG, CHAIN_TOL, IMG, M, TINY, WHOLE_TOL, YAML, _one_torch_thread, edm_draws, jit0, run_training_step_parity,
)

REPO = Path(__file__).resolve().parents[1]
COND = ["model.num_classes=4"]
B = 2


def _model(extra=()):
    return ConditionalEDM(load_config(YAML, overrides=[*TINY, *COND, *extra]).model, device="cpu", seed=0)


def _jax_of(model, extra=()):
    jmodel = JConditionalEDM(cfg=j_load_config(YAML, overrides=[*TINY, *COND, *extra]).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    jmodel.ema_params = jmodel.params
    return jmodel


@pytest.fixture(scope="module")
def pair():
    model = _model()
    return _jax_of(model), model


def test_training_step_with_label_mask_matches_jax():
    """The conditional step (null-class mask p = 0.5, augmentation p = 0.5,
    dropout 0.1) against the JAX step; the mask reaches the network."""
    model = _model(AUG)
    jmodel = _jax_of(model, AUG)
    model, batch, draws, loss = run_training_step_parity(
        model, jmodel, lambda k, s: edm_draws(k, s, 0.5, label_mask_p=jmodel.cond_drop_prob), seed=12)
    assert 0 < int(draws["label_mask"].sum()) < 4
    flipped = dict(draws, label_mask=~draws["label_mask"])
    assert abs(float(model.training_step(model.params, batch, flipped)[0]) - loss) > 1e-6


def test_guided_chain_matches_jax_and_one_graph_serves_every_scale(pair):
    jmodel, model = pair
    shape = (B, IMG, IMG, 3)
    x_T = torch.from_numpy((np.random.default_rng(1).standard_normal(shape) * 80.0).astype(np.float32))
    labels = model._label_array(B, 2)
    guided = Conditioned(model._cfg_forward, {"classes": labels, "guidance_scale": torch.tensor(3.0)})
    with torch.inference_mode():
        outs = [model.sampler.p_sample_loop(guided, model.params, shape, img=x_T, graphs=g) for g in (True, False)]
    assert torch.equal(outs[0], outs[1])
    fn = jmodel._cfg_model_fn(jnp.full((B,), 2, jnp.int32), 3.0)
    ref = jit0(lambda p, img: jmodel.sampler.p_sample_loop(fn, p, shape, jax.random.PRNGKey(0), img=img),
               jmodel.params, jnp.asarray(x_T.numpy()))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    # model.sample: one guided graph for every label and scale
    run = lambda label, w: model.sample(B, IMG, generator=torch.Generator().manual_seed(2), label=label,  # noqa: E731
                                        guidance_scale=w, graphs=True)
    first = run(2, 3.0)
    graphs = dict(model.sampler.graphs)
    second = run(1, 1.5)
    assert model.sampler.graphs.keys() == graphs.keys()
    assert all(model.sampler.graphs[k] is graphs[k] for k in graphs)
    assert not torch.equal(first, second)
    assert torch.equal(second, model.sample(B, IMG, generator=torch.Generator().manual_seed(2), label=1,
                                            guidance_scale=1.5, graphs=False))
    # no label: the null class
    null = model.sample(B, IMG, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        explicit = model.sampler.p_sample_loop(
            Conditioned(model.model_fn, {"classes": torch.full((B,), 4, dtype=torch.int32)}), model.params,
            (B, IMG, IMG, 3), torch.Generator().manual_seed(2))
    assert torch.equal(null, explicit)


def test_guidance_and_labels_are_validated_as_jax(pair):
    jmodel, model = pair
    for m in (model, jmodel):
        with pytest.raises(ValueError, match="requires label"):
            m.sample(B, IMG, guidance_scale=2.0)
        with pytest.raises(ValueError, match="label must be in"):
            m.sample(B, IMG, label=4)
    with pytest.raises(ValueError, match="num_classes"):
        ConditionalEDM(load_config(YAML, overrides=TINY).model, device="cpu")


def test_test_step_binds_the_labels_as_jax(pair):
    jmodel, model = pair
    rng = np.random.default_rng(5)
    batch = {"image": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
             "label": rng.integers(0, 4, B).astype(np.int32)}
    ref = jmodel.test_step(batch, 2)
    k_loss, _k_nll = jax.random.split(jax.random.PRNGKey(2))
    k_sig, k_noise = jax.random.split(k_loss)
    ours = model.test_step(batch, 2, sigma_z=torch.from_numpy(np.array(jax.random.normal(k_sig, (B,)))),
                           noise=torch.from_numpy(np.array(jax.random.normal(k_noise, (B, IMG, IMG, 3)))))
    np.testing.assert_allclose(float(ours["edm_loss_sum"]), float(ref["edm_loss_sum"]), rtol=WHOLE_TOL)
    other = model.test_step(dict(batch, label=(batch["label"] + 1) % 4), 2,
                            sigma_z=torch.from_numpy(np.array(jax.random.normal(k_sig, (B,)))),
                            noise=torch.from_numpy(np.array(jax.random.normal(k_noise, (B, IMG, IMG, 3)))))
    assert float(other["edm_loss_sum"]) != float(ours["edm_loss_sum"])


def test_archive_restores_across_packages_as_conditional_edm(pair, tmp_path):
    jmodel, model = pair
    from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore

    jback = j_restore(model.save_to(str(tmp_path / "port.dmn")))
    assert type(jback).__name__ == "ConditionalEDM" and jback.num_classes == 4
    for a, b in zip(jax.tree.leaves(jback.params), jax.tree.leaves(jmodel.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back = restore_model_from_archive(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    assert type(back) is ConditionalEDM and back.num_classes == 4
    assert all(torch.equal(back.params[k], model.params[k]) for k in model.params)
    run = lambda m: m.sample(B, IMG, generator=torch.Generator().manual_seed(3), label=1, guidance_scale=2.0)  # noqa
    assert torch.equal(run(back), run(model))


def test_server_answers_labelled_and_guided_requests(pair):
    _jmodel, model = pair
    srv = serve(model, port=0, use_ddim_sampler=False, max_batch=B)
    try:
        for label, w in ((3, 2.5), (0, None)):
            out = srv.batcher.submit(B, seed=6, label=label, guidance_scale=w)
            ref = model.sample(B, IMG, generator=torch.Generator().manual_seed(6), label=label, guidance_scale=w,
                               use_ema=True)
            assert np.array_equal(out, to_uint8_tensor(ref).numpy())
    finally:
        srv.shutdown()


def test_edm_clis_train_eval_and_test(tmp_path):
    """``train_edm`` (2 steps, a sample dump and bits/dim at step 2, the
    archive), ``eval_edm`` with a label, a guidance scale, churn, another
    grid and the trajectory, ``test_edm`` with the ODE bits/dim."""
    common = ["model.image_size=8", f"model.timesteps={M}", "model.diffusion_model.dim=8",
              "model.diffusion_model.dim_mults=[1,2]", "model.train_ds.name=synthetic",
              "model.train_ds.batch_size=4", "+model.train_ds.length=8", "trainer.accelerator=cpu",
              "exp_manager.create_tensorboard_logger=false", "trainer.max_steps=2", "model.save_every=2",
              "model.compute_bpd=true", f"+model.results_dir={tmp_path / 'results'}"]
    model, trainer = train_edm.main([*common, f"exp_manager.exp_dir={tmp_path / 'cond'}", *COND,
                                     "+model.augment_prob=0.2", "+model.diffusion_model.aug_dim=9"])
    assert type(model) is ConditionalEDM and np.isfinite(trainer.logged[-1]["train_loss"])
    plain, _ = train_edm.main([*common, f"exp_manager.exp_dir={tmp_path / 'plain'}", "trainer.max_steps=1"])
    assert type(plain) is EDM
    (dmn,) = (tmp_path / "cond").glob("*/*/*.dmn")
    out = eval_edm.main([f"model_path={dmn}", "batch_size=3", "device=cpu", f"output_dir={tmp_path / 's'}",
                         "add_timestamp=false", "label=2", "guidance_scale=2.0", "s_churn=1.0", "num_steps=3",
                         "show_diffusion=true", "seed=4"])
    assert sorted(p.name for p in out.iterdir()) == ["diffusion.gif", "sample_0.png", "sample_1.png",
                                                     "sample_2.png", "samples_grid.png"]
    back = restore_model_from_archive(str(dmn), use_ema=True, device="cpu")
    back.change_sampler(dict(back.cfg.sampler, s_churn=1.0))
    ref = back.sample(3, 8, generator=torch.Generator().manual_seed(4), label=2, guidance_scale=2.0, num_steps=3)
    pngs = np.stack([decode_png((out / f"sample_{i}.png").read_bytes()) for i in range(3)])
    assert np.array_equal(pngs, to_uint8_tensor(ref).numpy())
    result = test_edm.main([f"model_path={dmn}", "batch_size=4", "limit_test_batches=1", "device=cpu",
                            "dataset_name=synthetic"])
    assert set(result) == {"test_edm_loss", "test_total_bpd", "avg_num_forward_evaluations"}
    assert result["avg_num_forward_evaluations"] == 2 * (M - 1) and np.isfinite(result["test_total_bpd"])
