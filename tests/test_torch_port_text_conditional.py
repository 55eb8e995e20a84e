"""The port's TextConditionalDDPM (training with caption drop, prompted,
guided, negative-prompted and float-context sampling, archives, /sample with
prompts, the DiT CLIs) and the captioned datasets against the JAX package,
on the CPU.

The model is examples/configs/dit/text_dit_small.yaml cut to a tiny float32
DiT (dim 32, depth 2, 4 heads, patch 2, 8 px, ``context_dim`` 16, byte vocab
257, ``max_text_len`` 8, T = 4, ``cond_drop_prob`` 0.5 so that both branches
of the drop run). The JAX init's all-zero leaves (adaLN-Zero, ``ca_out``,
the biases) are redrawn from a seeded N(0, 0.02²), or the network would
ignore its context, and the tree is carried to the port with
``utils/weights.py``. The training step's draws (flip, t, noise and the
caption drop vector) are re-derived from the JAX step's key as
``TextConditionalDDPM.training_step`` and ``get_model_fn`` split it; the
chains take the port generator's draws (x_T and each step's noise), fed to
the JAX steps in the same order.

Tolerances: 2e-4 relative for a whole network, step or gradient
(tests/test_torch_export.py:78); 1e-3 for a chain (the DDIM chain's bar,
tests/test_torch_port_graphs.py); bit for bit between the port's own
replayed and eager chains.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.data.hf_vision_data import build_dataloader as j_build_dataloader
from diffusion_model_nemo_tpu.models.text_conditional_ddpm import TextConditionalDDPM as JText
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.data import build_dataloader
from diffusion_model_nemo_tpu_torch.models import DDPM, TextConditionalDDPM, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.serving import serve
from diffusion_model_nemo_tpu_torch.serving.server import BatchingSampler
from diffusion_model_nemo_tpu_torch.training.trainer import param_grads
from diffusion_model_nemo_tpu_torch.utils.image import encode_png, to_uint8_tensor
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/dit/text_dit_small.yaml"
T, IMG, B, LEN, CTX = 4, 8, 4, 8, 16
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=32",
    "model.diffusion_model.depth=2", "model.diffusion_model.heads=4", f"model.diffusion_model.context_dim={CTX}",
    "model.diffusion_model.dtype=float32", f"model.max_text_len={LEN}", "model.cond_drop_prob=0.5",
    "model.train_ds.name=synthetic",
]
WHOLE_TOL = 2e-4  # tests/test_torch_export.py:78
CHAIN_TOL = 1e-3  # tests/test_torch_port_graphs.py
DDIM = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
ANCESTRAL = "diffusion_model_nemo.modules.GaussianDiffusion"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port(overrides=()):
    return TextConditionalDDPM(load_config(YAML, overrides=[*TINY, *overrides]).model, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The JAX TextConditionalDDPM and the port's, with the same weights
    (the JAX init, zero leaves redrawn)."""
    jmodel = JText(cfg=j_load_config(YAML, overrides=TINY).model)
    x, t = jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,), jnp.float32)
    tree = jax.jit(jmodel.diffusion_model.init)(jax.random.PRNGKey(0), x, t,
                                                context=jnp.zeros((1, LEN), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: rng.normal(0.0, 0.02, a.shape).astype(np.float32) if not np.any(a)
                        else np.asarray(a), tree)
    jmodel.params = jax.tree.map(jnp.asarray, tree)
    jmodel.ema_params = jmodel.params
    model = _port()
    model._load_flax(tree, None)
    return jmodel, model


# ---------------------------------------------------------------- the family --
def test_family_checks_are_the_jax_ones():
    with pytest.raises(ValueError, match="context_dim > 0"):
        _port(["model.diffusion_model.context_dim=0"])
    with pytest.raises(ValueError, match="context_vocab must be 257"):
        _port(["model.diffusion_model.context_vocab=300"])
    model = _port(["model.diffusion_model.context_vocab=0"])  # outside float contexts only
    assert model.max_text_len == LEN and model.cond_drop_prob == 0.5 and model.tokenizer.vocab_size == 257
    np.testing.assert_array_equal(model._tokens_array(2, "ab").numpy(), np.tile(model.tokenizer.encode("ab"), (2, 1)))
    np.testing.assert_array_equal(model._tokens_array(2, None).numpy(), np.zeros((2, LEN), np.int32))
    with pytest.raises(ValueError, match="3 prompts for batch_size=2"):
        model._tokens_array(2, ["a", "b", "c"])


# --------------------------------------------------------- the training step --
def _jax_draws(key, batch, p):
    """TextConditionalDDPM.training_step's draws from its key: (k_pre,
    k_mask, k_t, k_noise), and the drop vector from ``get_model_fn``'s split
    of k_mask."""
    k_pre, k_mask, k_t, k_noise = jax.random.split(key, 4)
    k_bern, _k_drop = jax.random.split(k_mask)
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {
        "flip": as_t(jax.random.bernoulli(k_pre, 0.5, (batch,))),
        "t": as_t(jax.random.randint(k_t, (batch,), 0, T, dtype=jnp.int32)),
        "noise": as_t(jax.random.normal(k_noise, (batch, IMG, IMG, 3), jnp.float32)),
        "cond_drop": as_t(jax.random.bernoulli(k_bern, p, (batch,))),
    }


def test_training_step_loss_and_gradients_match_jax(pair):
    jmodel, model = pair
    rng = np.random.default_rng(5)
    batch = {"image": rng.integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8),
             "tokens": model.tokenizer.encode_batch([f"a photo of class {i}" for i in range(8)])}
    key = jax.random.PRNGKey(3)
    draws = _jax_draws(key, 8, 0.5)
    assert 0 < int(draws["cond_drop"].sum()) < 8  # both branches run
    b = jax.tree.map(jnp.asarray, batch)
    (ref, _), jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.training_step(p, b, key, 0), has_aux=True))(
        jmodel.params)
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    ours, metrics = model.training_step(params, batch, draws)
    grads = param_grads(ours, params, frozenset())
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=WHOLE_TOL)
    assert set(metrics) == {"train_loss"}
    flat = lambda tree: np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])  # noqa: E731
    ours_tree = to_flax_params({k: g.detach() for k, g in grads.items()}, model.diffusion_model)
    assert _rel_l2(flat(ours_tree), flat(jax.tree.map(np.asarray, jgrads))) < WHOLE_TOL
    kept, _ = model.training_step(model.params, batch, dict(draws, cond_drop=torch.zeros(8, dtype=torch.bool)))
    assert abs(float(kept) - float(ours.detach())) > 1e-6  # the drop vector reaches the network


def test_draws_add_a_bernoulli_drop_vector():
    model = _port()
    d = model.draw_training_inputs((64, IMG, IMG, 3), torch.Generator().manual_seed(0))
    assert set(d) == {"flip", "t", "noise", "cond_drop"} and d["cond_drop"].dtype == torch.bool
    assert 16 < int(d["cond_drop"].sum()) < 48


# ---------------------------------------------------------------- sampling --
def _use(model, jmodel, target, **extra):
    cfg = {k: v for k, v in model.cfg.sampler.items() if k not in ("eta", "ddim_timesteps")}
    model.change_sampler(dict(cfg, _target_=target, **extra))
    jmodel.change_sampler(dict(cfg, _target_=target, **extra))


FLOAT_CTX = np.random.default_rng(8).standard_normal((5, CTX)).astype(np.float32)
CASES = {
    "prompt": dict(text=["a photo of class 1", "cat", "", "héllo"]),
    "guided": dict(text="a photo of class 2", guidance_scale=3.0),
    "negative": dict(text="a photo of class 2", guidance_scale=3.0, negative_text="a photo of class 5"),
    "float": dict(context=FLOAT_CTX, guidance_scale=2.0),
}


def _jax_model_fn(jmodel, kw):
    if "context" in kw:
        ctx = jnp.tile(jnp.asarray(kw["context"])[None], (B, 1, 1))
        return jmodel._cfg_model_fn(ctx, jnp.zeros_like(ctx), kw["guidance_scale"])
    tokens = jmodel._tokens_array(B, kw["text"])
    if kw.get("guidance_scale") is None:
        return lambda p, x, t: jmodel.model_fn(p, x, t, context=tokens)
    return jmodel._cfg_model_fn(tokens, jmodel._tokens_array(B, kw.get("negative_text")), kw["guidance_scale"])


def _jax_ancestral(jmodel, model_fn, gen):
    """The JAX steps fed the port generator's draws: x_T, then each t > 0's
    noise (the mean at t = 0)."""
    step = jax.jit(lambda p, x, t: jmodel.sampler.p_mean_variance(model_fn, p, x, t))
    x = jnp.asarray(torch.randn((B, IMG, IMG, 3), generator=gen).numpy())
    for t in range(T - 1, -1, -1):
        out = step(jmodel.params, x, jnp.int32(t))
        x = out.mean
        if t > 0:
            x = x + jnp.exp(0.5 * out.log_variance) * jnp.asarray(torch.randn((B, IMG, IMG, 3), generator=gen).numpy())
    return np.asarray((x + 1.0) * 0.5)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("sampler", ["ddim", "ancestral"])
def test_sample_matches_jax(pair, sampler, case):
    """DDIM-3 (eta 0) and the ancestral chain at T = 4 from the same draws:
    prompted rows, guided, guided against a negative prompt, and a float
    context guided against zeros; the port's through its (CPU) graph
    replays."""
    jmodel, model = pair
    kw = CASES[case]
    if sampler == "ddim":
        _use(model, jmodel, DDIM, eta=0.0, ddim_timesteps=3)
    else:
        _use(model, jmodel, ANCESTRAL)
    ours = model.sample(B, IMG, generator=torch.Generator().manual_seed(4), graphs=True, **kw).numpy()
    fn = _jax_model_fn(jmodel, kw)
    if sampler == "ddim":
        x_T = torch.randn((B, IMG, IMG, 3), generator=torch.Generator().manual_seed(4))
        loop = jax.jit(lambda p, img: jmodel.sampler.p_sample_loop(fn, p, x_T.shape, jax.random.PRNGKey(0), img=img))
        ref = np.asarray(loop(jmodel.params, jnp.asarray(x_T.numpy())))
    else:
        ref = _jax_ancestral(jmodel, fn, torch.Generator().manual_seed(4))
    assert np.isfinite(ours).all() and ours.std() > 0
    np.testing.assert_allclose(ours, ref, atol=CHAIN_TOL, rtol=CHAIN_TOL)


def test_sample_argument_errors_are_the_jax_ones(pair):
    _, model = pair
    with pytest.raises(ValueError, match="requires a text prompt"):
        model.sample(2, IMG, guidance_scale=2.0)
    with pytest.raises(ValueError, match="negative_text requires guidance_scale"):
        model.sample(2, IMG, text="a", negative_text="b")
    with pytest.raises(ValueError, match="replaces text prompts"):
        model.sample(2, IMG, text="a", context=FLOAT_CTX)
    with pytest.raises(ValueError, match=r"context must be \[B=2"):
        model.sample(2, IMG, context=np.zeros((3, 5, CTX), np.float32))
    with pytest.raises(ValueError, match="context feature dim 7"):
        model.sample(2, IMG, context=np.zeros((5, 7), np.float32))


def test_prompts_and_scales_replay_one_graph_each(pair):
    """The prompt tokens, the anchor and the guidance scale are static
    buffers of the captured chain, refilled before each chain: two prompts
    (and the guided chain at two scales, one with a negative prompt) back to
    back each equal their own eager chain bit for bit; the unguided prompts
    share one graph, and every scale replays one guided graph."""
    jmodel, model = pair
    runs = [dict(text="class 1"), dict(text="class 8"), dict(text="class 8", guidance_scale=2.0),
            dict(text="class 1", guidance_scale=4.0, negative_text="class 3")]
    for target, extra in ((DDIM, dict(eta=0.0, ddim_timesteps=3)), (ANCESTRAL, {})):
        _use(model, jmodel, target, **extra)
        outs = []
        for kw in runs:
            pair_ = [model.sample(B, IMG, generator=torch.Generator().manual_seed(6), graphs=g, **kw)
                     for g in (True, False)]
            assert torch.equal(*pair_), (target, kw)
            outs.append(pair_[0])
        assert len(model.sampler.graphs) == 2  # the unguided graph and one guided graph for every scale
        assert not torch.equal(outs[0], outs[1]) and not torch.equal(outs[2], outs[3])


def test_interpolate_binds_the_prompt(pair):
    jmodel, model = pair
    _use(model, jmodel, ANCESTRAL)
    rng = np.random.default_rng(9)
    x1, x2 = (torch.from_numpy(rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)) for _ in range(2))
    run = lambda text: model.interpolate(x1, x2, t=2, generator=torch.Generator().manual_seed(1), text=text)  # noqa
    a, b, null = run("class 1"), run("class 2"), run(None)
    assert a.shape == (2, IMG, IMG, 3) and not torch.equal(a, b) and not torch.equal(a, null)


# ---------------------------------------------------------------- archives --
def test_archives_restore_both_ways(pair, tmp_path):
    jmodel, model = pair
    restored = restore_model_from_archive(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    assert type(restored) is TextConditionalDDPM and restored.max_text_len == LEN
    rng = np.random.default_rng(4)
    x, t = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32), np.asarray([0, 1, 2, 3], np.int32)
    tokens = model.tokenizer.encode_batch(["a", "bc", "", "class 9"])
    apply = jax.jit(lambda p, x, t, c: jmodel.model_fn(p, x, t, context=c))
    ref = apply(jmodel.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(tokens))
    ours = restored.model_fn(restored.params, torch.from_numpy(x), torch.from_numpy(t),
                             context=torch.from_numpy(tokens))
    assert _rel_l2(ours.numpy(), ref) < WHOLE_TOL
    back = JText.restore_from(model.save_to(str(tmp_path / "port.dmn")))
    assert back.max_text_len == LEN
    assert _rel_l2(np.asarray(apply(back.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(tokens))), ref) < WHOLE_TOL


# ----------------------------------------------------------------- serving --
def test_sample_serves_prompts(pair, tmp_path):
    """``serve`` on a text archive (DDIM-3, max_batch 4): a seeded guided
    request with a negative prompt equals ``sample`` with those prompt rows;
    two unseeded requests with different prompts and one scale coalesce into
    one batch, and neither the second prompt nor a second scale captures a
    graph; prompts to a non-text archive, guidance without a prompt and a
    negative prompt without guidance answer 400."""
    import functools

    _, carried = pair
    served = restore_model_from_archive(carried.save_to(str(tmp_path / "text.dmn")), device="cpu")
    served.sample = functools.partial(served.sample, graphs=True)  # the card's default, on the CPU's static buffers
    srv = serve(served, port=0, ddim_timesteps=3, max_batch=B)
    batcher = srv.batcher
    try:
        out = batcher.submit(B, seed=4, text="class 1", guidance_scale=2.0, negative_text="class 5")
        ref = served.sample(B, IMG, generator=torch.Generator().manual_seed(4), use_ema=True, text=["class 1"] * B,
                            guidance_scale=2.0, negative_text=["class 5"] * B)
        assert np.array_equal(out, to_uint8_tensor(ref).numpy())
        held = dict(served.sampler.graphs)
        assert len(held) == 2  # the warm-up's unguided graph and the guided one
        answers = {}
        with batcher.hold():
            threads = [threading.Thread(target=lambda p=p: answers.__setitem__(p, batcher.submit(
                2, text=p, guidance_scale=3.5, timeout=120))) for p in ("class 2", "class 7")]
            for th in threads:
                th.start()
            while batcher.queued() < 2:
                threading.Event().wait(0.01)
        for th in threads:
            th.join(timeout=120)
        assert set(answers) == {"class 2", "class 7"} and all(a.shape == (2, IMG, IMG, 3) for a in answers.values())
        assert batcher.snapshot_stats()["batches"] == 2  # the seeded batch, then one for both prompts
        assert served.sampler.graphs.keys() == held.keys()  # nothing captured anew
        srv.start_background()

        def post(payload):
            req = urllib.request.Request(f"http://{srv.host}:{srv.port}/sample", method="POST",
                                         data=json.dumps(dict(payload, format="npy")).encode())
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    return resp.status, np.load(io.BytesIO(resp.read()))
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())["error"]

        code, images = post({"num_images": 1, "text": "class 3", "seed": 1})
        assert code == 200 and images.shape == (1, IMG, IMG, 3)
        assert post({"num_images": 1, "guidance_scale": 2.0}) == (400, "ValueError: guidance_scale requires a text "
                                                                        "prompt on this archive")
        assert post({"num_images": 1, "text": "a", "negative_text": "b"})[0] == 400
    finally:
        srv.shutdown()
    cfg = load_config(REPO / "examples/configs/dit/dit_small.yaml", overrides=[*TINY[:5], TINY[6]]).model
    plain = BatchingSampler(DDPM(cfg, device="cpu"), image_size=IMG, max_batch=B)
    with pytest.raises(ValueError, match="not text-conditional"):
        plain.submit(1, text="a")


# -------------------------------------------------------------------- CLIs --
def test_dit_clis_train_and_sample(tmp_path):
    """``train_text_dit`` (2 steps at B = 4 on the synthetic captions, the
    archive), ``sample_text_dit`` from it with a guided prompt and a
    negative prompt, and with ``context_npy`` ([1, L, D], repeated over the
    batch), and ``train_dit`` (dit_small.yaml, 2 steps)."""
    from diffusion_model_nemo_tpu_torch.cli import sample_text_dit, train_dit, train_text_dit

    common = ["trainer.accelerator=cpu", "trainer.max_steps=2", "model.train_ds.batch_size=4",
              "+model.train_ds.length=8", "exp_manager.create_tensorboard_logger=false", "model.save_every=0"]
    model, trainer = train_text_dit.main([*TINY, *common, f"exp_manager.exp_dir={tmp_path / 'exp'}"])
    assert type(model) is TextConditionalDDPM and all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    (dmn,) = (tmp_path / "exp").glob("*/*/*.dmn")
    np.save(tmp_path / "ctx.npy", FLOAT_CTX[None])
    for i, extra in enumerate((["text=a photo of class 1", "guidance_scale=2.0", "negative_text=class 4"],
                               [f"context_npy={tmp_path / 'ctx.npy'}"])):
        out = sample_text_dit.main([f"model_path={dmn}", "batch_size=4", "device=cpu", "use_ddim_sampler=true",
                                    "ddim_timesteps=2", f"output_dir={tmp_path / f'samples{i}'}",
                                    "add_timestamp=false", *extra])
        assert sorted(p.name for p in out.iterdir()) == [*(f"sample_{i}.png" for i in range(4)), "samples_grid.png"]
    dit, dit_trainer = train_dit.main([*TINY[:5], TINY[6], TINY[9], *common, f"exp_manager.exp_dir={tmp_path / 'dit'}"])
    assert type(dit) is DDPM and all(np.isfinite(m["train_loss"]) for m in dit_trainer.logged)


# -------------------------------------------------------------- the datasets --
def test_captioned_datasets_match_jax(tmp_path):
    """``caption_len`` on the synthetic set ("a photo of class {label}")
    and on an image directory's ``captions.txt``: the same tokens, items and
    batches as the JAX loaders; a line count that is not the file count
    raises as in JAX."""
    cfg = {"name": "synthetic", "image_size": 8, "channels": 3, "length": 16, "batch_size": 4, "caption_len": 12}
    ours, ref = next(iter(build_dataloader(cfg, mode="train"))), next(iter(j_build_dataloader(cfg, mode="train")))
    assert set(ours) == set(ref) == {"image", "label", "tokens"}
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])
    d = tmp_path / "images"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        (d / f"{i:02d}.png").write_bytes(encode_png(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)))
    (d / "captions.txt").write_text("a red square\nhéllo\n\nthe last one, cut here\n")
    cfg = {"name": "file", "path": str(d), "batch_size": 4, "shuffle": False, "caption_len": 10}
    ours, ref = next(iter(build_dataloader(cfg, mode="train"))), next(iter(j_build_dataloader(cfg, mode="train")))
    assert ours["tokens"].shape == (4, 10)
    for k in ("image", "tokens"):
        np.testing.assert_array_equal(ours[k], ref[k])
    (d / "captions.txt").write_text("one\ntwo\n")
    for loader in (build_dataloader, j_build_dataloader):
        with pytest.raises(ValueError, match="captions.txt has 2 lines for 4 image files"):
            loader(cfg, mode="train")
