"""The port's class conditioning (U-Net and DiT class embeddings,
ConditionalDDPM's training step, conditional and classifier-free-guided
sampling) against the JAX package, on the CPU.

The models are examples/configs/conditional_ddpm/unet_small.yaml cut to a
tiny float32 U-Net (dim 8, dim_mults [1, 2], 8 px, T = 10, K = 10); the
port's weights are the JAX ``init_params`` carried over with
``utils/weights.py``, the class embedding redrawn from a seeded N(0, 1) so
that no label's row is near zero. Inputs are made with numpy from a seed;
the training step's draws (flip, t, noise and the label mask) are
re-derived from the JAX step's key as ``ConditionalDDPM.training_step`` and
``get_model_fn`` split it; the chains take the port generator's draws (x_T
and each step's noise), fed to the JAX steps in the same order.

Tolerances: 2e-4 relative for a whole network or step
(tests/test_torch_export.py:78); 1e-3 for a 10-step chain (the DDIM chain's
bar, tests/test_torch_port_graphs.py); bit for bit between the port's own
replayed and eager chains.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import ConditionalDDPM as JConditional
from diffusion_model_nemo_tpu.modules.dit import DiT as JDiT
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import ConditionalDDPM, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules.dit import DiT
from diffusion_model_nemo_tpu_torch.modules.gaussian_diffusion import Conditioned
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params
from tests.test_torch_port_improved_ddpm import jax_init

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/conditional_ddpm/unet_small.yaml"
T, IMG, B, K = 10, 8, 4, 10
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", f"model.num_classes={K}",
]
WHOLE_TOL = 2e-4  # tests/test_torch_export.py:78
CHAIN_TOL = 1e-3  # tests/test_torch_port_graphs.py
DDIM = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
ANCESTRAL = "diffusion_model_nemo.modules.GaussianDiffusion"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is as fast
    alone, and does not oversubscribe the cores that the suite's other
    workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port(seed=0):
    return ConditionalDDPM(load_config(YAML, overrides=TINY).model, device="cpu", seed=seed)


@pytest.fixture(scope="module")
def pair():
    jmodel = JConditional(cfg=j_load_config(YAML, overrides=TINY).model)
    jax_init(jmodel, jax.random.PRNGKey(0), classes=jnp.zeros((1,), jnp.int32))
    table = np.random.default_rng(9).standard_normal((K + 1, 8)).astype(np.float32)
    jmodel.params = {**jmodel.params, "class_embed": {"embedding": jnp.asarray(table)}}
    model = _port()
    model._load_flax(jax.tree.map(np.asarray, jmodel.params), None)
    return jmodel, model


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    return x, np.asarray([0, 3, 7, T - 1], np.int32), np.asarray([2, K, 9, 0], np.int32)


def _both(jmodel, model, x, t, classes=None):
    c_j = None if classes is None else jnp.asarray(classes)
    c_t = None if classes is None else torch.from_numpy(classes)
    apply = jax.jit(lambda p, x, t, c: jmodel.model_fn(p, x, t, classes=c))
    ref = np.asarray(apply(jmodel.params, jnp.asarray(x), jnp.asarray(t), c_j))
    ours = model.model_fn(model.params, torch.from_numpy(x), torch.from_numpy(t), c_t).numpy()
    return ours, ref


# ------------------------------------------------------- the class embedding --
def test_unet_labelled_forward_matches_jax(pair):
    jmodel, model = pair
    x, t, classes = _inputs()
    ours, ref = _both(jmodel, model, x, t, classes)
    assert _rel_l2(ours, ref) < WHOLE_TOL
    unlabelled, _ = _both(jmodel, model, x, t)
    assert np.abs(ours - unlabelled).max() > 1e-3  # the labels reach the output


def test_unet_all_null_forward_equals_no_classes(pair):
    jmodel, model = pair
    x, t, _ = _inputs(2)
    null = np.full((B,), K, np.int32)
    ours, ref = _both(jmodel, model, x, t, null)
    assert _rel_l2(ours, ref) < WHOLE_TOL
    none = model.model_fn(model.params, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.array_equal(ours, none)


def test_unet_null_row_stays_zero_after_a_weight_edit(pair):
    """The null row is forced to zero by a ``where`` (torch's padding_idx
    behaviour): editing the table's row K leaves a null forward unchanged,
    in both packages, and editing a label's row does not."""
    jmodel, model = pair
    x, t, classes = _inputs(3)
    before = model.model_fn(model.params, torch.from_numpy(x), torch.from_numpy(t)).numpy()
    for row, moves in ((K, False), (2, True)):
        edited = dict(model.params)
        edited["class_embed.weight"] = model.params["class_embed.weight"].clone()
        edited["class_embed.weight"][row] = 5.0
        after = model.model_fn(edited, torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(np.full((B,), 2 if moves else K, np.int32))).numpy()
        ref_before = model.model_fn(model.params, torch.from_numpy(x), torch.from_numpy(t),
                                    torch.from_numpy(np.full((B,), 2 if moves else K, np.int32))).numpy()
        assert np.array_equal(after, ref_before) is not moves
    jtable = jmodel.params["class_embed"]["embedding"].at[K].set(5.0)
    jp = {**jmodel.params, "class_embed": {"embedding": jtable}}
    jnull = np.asarray(jax.jit(jmodel.model_fn)(jp, jnp.asarray(x), jnp.asarray(t)))
    assert _rel_l2(before, jnull) < WHOLE_TOL


DIT = dict(dim=32, depth=1, heads=2, patch_size=2, channels=3, num_classes=K)


def test_dit_class_embedding_learns_its_null_row():
    """The DiT adds ``class_embed`` to c after ``time_dense1``; its null row
    is learned: a null forward follows the table's row K (unlike the U-Net),
    in both packages alike."""
    jnet = JDiT(**DIT)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)),
                                classes=jnp.zeros((1,), jnp.int32))["params"]
    japply = jax.jit(lambda p, x, t, c: jnet.apply({"params": p}, x, t, classes=c))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: rng.normal(0.0, 0.02, a.shape).astype(np.float32) if not np.any(a)
                          else np.asarray(a), params)  # adaLN-Zero leaves redrawn
    tnet = DiT(**DIT).eval()
    tnet.load_state_dict(from_flax_params(params, tnet))
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    t, classes = np.asarray([1, 5, 900], np.int32), np.asarray([4, K, 0], np.int32)

    def both(p, state, c):
        ref = np.asarray(japply(p, jnp.asarray(x), jnp.asarray(t), None if c is None else jnp.asarray(c)))
        with torch.no_grad():
            tnet.load_state_dict(state)
            ours = tnet(torch.from_numpy(x), torch.from_numpy(t), None if c is None else torch.from_numpy(c)).numpy()
        return ours, ref

    state = from_flax_params(params, tnet)
    ours, ref = both(params, state, classes)
    assert _rel_l2(ours, ref) < WHOLE_TOL
    none, _ = both(params, state, None)
    null, _ = both(params, state, np.full((3,), K, np.int32))
    assert np.array_equal(none, null)
    edited = jax.tree.map(np.array, params)
    edited["class_embed"]["embedding"][K] += 0.5
    ours_e, ref_e = both(edited, from_flax_params(edited, tnet), None)
    assert _rel_l2(ours_e, ref_e) < WHOLE_TOL and np.abs(ours_e - none).max() > 1e-4


# --------------------------------------------------------- the training step --
def _jax_draws(key, batch):
    """ConditionalDDPM.training_step's draws from its key: (k_pre, k_mask,
    k_t, k_noise), and the label mask from ``get_model_fn``'s split of
    k_mask."""
    k_pre, k_mask, k_t, k_noise = jax.random.split(key, 4)
    k_bern, _k_drop = jax.random.split(k_mask)
    as_t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return {
        "flip": as_t(jax.random.bernoulli(k_pre, 0.5, (batch,))),
        "t": as_t(jax.random.randint(k_t, (batch,), 0, T, dtype=jnp.int32)),
        "noise": as_t(jax.random.normal(k_noise, (batch, IMG, IMG, 3), jnp.float32)),
        "label_mask": as_t(jax.random.bernoulli(k_bern, 0.5, (batch,))),
    }


def test_training_step_with_the_jax_mask_matches_jax(pair):
    jmodel, model = pair
    rng = np.random.default_rng(5)
    batch = {"image": rng.integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8),
             "label": rng.integers(0, K, 8).astype(np.int32)}
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, 8)
    assert 0 < int(draws["label_mask"].sum()) < 8  # both branches run
    ref, _ = jax.jit(lambda p, b: jmodel.training_step(p, b, key, 0))(jmodel.params, jax.tree.map(jnp.asarray, batch))
    ours, metrics = model.training_step(model.params, batch, draws)
    np.testing.assert_allclose(float(ours), float(ref), rtol=WHOLE_TOL)
    assert set(metrics) == {"train_loss"}
    unmasked, _ = model.training_step(model.params, batch, dict(draws, label_mask=torch.zeros(8, dtype=torch.bool)))
    assert abs(float(unmasked) - float(ours)) > 1e-6  # the mask reaches the network


def test_draws_add_a_bernoulli_label_mask():
    model = _port()
    d = model.draw_training_inputs((64, IMG, IMG, 3), torch.Generator().manual_seed(0))
    assert set(d) == {"flip", "t", "noise", "label_mask"} and d["label_mask"].dtype == torch.bool
    assert 16 < int(d["label_mask"].sum()) < 48


# ---------------------------------------------------------------- sampling --
def _use(model, jmodel, target, **extra):
    cfg = {k: v for k, v in model.cfg.sampler.items() if k not in ("eta", "ddim_timesteps")}
    model.change_sampler(dict(cfg, _target_=target, **extra))
    jmodel.change_sampler(dict(cfg, _target_=target, **extra))


def _jax_model_fn(jmodel, label, w):
    labels = jnp.full((B,), K if label is None else label, jnp.int32)
    if w is None:
        return lambda p, x, t: jmodel.model_fn(p, x, t, classes=labels)
    return jmodel._cfg_model_fn(labels, w)


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


CASES = [(3, None), (None, None), (3, 1.0), (3, 3.0)]
IDS = ["label", "null", "guided-w1", "guided-w3"]


@pytest.mark.parametrize("label,w", CASES, ids=IDS)
@pytest.mark.parametrize("sampler", ["ddim", "ancestral"])
def test_sample_matches_jax(pair, sampler, label, w):
    """10-step chains (DDIM eta 0 over all 10 steps, or ancestral) from the
    same draws; the port's through its (CPU) graph replays."""
    jmodel, model = pair
    if sampler == "ddim":
        _use(model, jmodel, DDIM, eta=0.0, ddim_timesteps=T)
    else:
        _use(model, jmodel, ANCESTRAL)
    ours = model.sample(B, IMG, generator=torch.Generator().manual_seed(4), label=label, guidance_scale=w,
                        graphs=True).numpy()
    fn = _jax_model_fn(jmodel, label, w)
    if sampler == "ddim":
        x_T = torch.randn((B, IMG, IMG, 3), generator=torch.Generator().manual_seed(4))
        loop = jax.jit(lambda p, img: jmodel.sampler.p_sample_loop(fn, p, x_T.shape, jax.random.PRNGKey(0), img=img))
        ref = np.asarray(loop(jmodel.params, jnp.asarray(x_T.numpy())))
    else:
        ref = _jax_ancestral(jmodel, fn, torch.Generator().manual_seed(4))
    np.testing.assert_allclose(ours, ref, atol=CHAIN_TOL, rtol=CHAIN_TOL)


def test_guidance_one_is_the_conditional_chain(pair):
    """w = 1 is ε_c up to rounding (JAX tests/test_cfg_guidance.py:35);
    w = 3 is not."""
    jmodel, model = pair
    _use(model, jmodel, DDIM, eta=0.0, ddim_timesteps=5)
    run = lambda **kw: model.sample(B, IMG, generator=torch.Generator().manual_seed(2), label=5, **kw)  # noqa: E731
    plain, w1, w3 = run(), run(guidance_scale=1.0), run(guidance_scale=3.0)
    np.testing.assert_allclose(w1.numpy(), plain.numpy(), rtol=0, atol=1e-4)
    assert float((w3 - plain).abs().max()) > 1e-3


def test_guidance_without_a_label_raises(pair):
    _, model = pair
    with pytest.raises(ValueError, match="label"):
        model.sample(2, IMG, guidance_scale=2.0)
    with pytest.raises(ValueError, match=r"\[0, 10\)"):
        model.sample(2, IMG, label=K)


def test_two_labels_back_to_back_through_one_graph_equal_their_eager_chains(pair):
    """The labels and the guidance scale are static buffers of the captured
    chain, refilled before each chain: two labels (and the guided chain at
    two scales) back to back through one sampler each equal their own eager
    chain bit for bit; the unguided labels share one graph, and every scale
    replays one guided graph."""
    jmodel, model = pair
    for target, extra, runs in ((DDIM, dict(eta=0.0, ddim_timesteps=5), [(1, None), (8, None), (8, 2.0), (1, 4.0)]),
                                (ANCESTRAL, {}, [(1, None), (8, None), (8, 2.0)])):
        _use(model, jmodel, target, **extra)
        for label, w in runs:
            out = []
            for graphs in (True, False):
                gen = torch.Generator().manual_seed(6)
                out.append(model.sample(B, IMG, generator=gen, label=label, guidance_scale=w, graphs=graphs))
            assert torch.equal(out[0], out[1]), (target, label, w)
        assert len(model.sampler.graphs) == 2  # the unguided graph and one guided graph for every scale


def test_conditioned_graph_key_holds_no_label_values():
    """Two label tensors of one shape key one graph, and so do two guidance
    scales (0-d tensors); the function keys it."""
    model = _port()
    a = Conditioned(model.model_fn, {"classes": torch.full((B,), 1, dtype=torch.int32)})
    b = Conditioned(model.model_fn, {"classes": torch.full((B,), 7, dtype=torch.int32)})
    g2, g5 = (Conditioned(model._cfg_forward, {"classes": torch.full((B,), 7, dtype=torch.int32),
                                               "guidance_scale": torch.tensor(w)}) for w in (2.0, 5.0))
    assert a.key() == b.key() != g2.key() == g5.key()


def test_served_guidance_scales_replay_one_guided_graph_and_match_jax(pair):
    """/sample at three guidance scales (and a label without one) on a
    DDIM-5 server: one guided graph serves every scale (the scale is a
    static buffer of the chain), and the seeded guided batch is the JAX
    guided chain from the same x_T (within one uint8 step: the chain's
    1e-3 can move a rounding). The server's model samples with
    ``graphs=True`` (on the CPU the captured step functions run eagerly on
    the static buffers, the default on the card)."""
    import functools
    import io
    import json
    import urllib.request

    from diffusion_model_nemo_tpu_torch.serving import serve

    jmodel, carried = pair
    model = _port()
    model._load_flax(jax.tree.map(np.asarray, jmodel.params), None)
    assert all(torch.equal(model.params[k], carried.params[k]) for k in model.params)
    model.sample = functools.partial(model.sample, graphs=True)
    server = serve(model, port=0, max_batch=B, ddim_timesteps=5)
    server.start_background()

    def post(payload):
        req = urllib.request.Request(f"http://{server.host}:{server.port}/sample", method="POST",
                                     data=json.dumps(dict(payload, format="npy")).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            return np.load(io.BytesIO(resp.read()))

    try:
        served = {w: post({"num_images": B, "label": 3, "guidance_scale": w, "seed": 4}) for w in (1.5, 3.0, 4.5)}
        post({"num_images": B, "label": 3, "seed": 4})
    finally:
        server.shutdown()
    funcs = [k for key in model.sampler.graphs for k in key if callable(k)]
    assert len(model.sampler.graphs) == 2 and sorted(f.__name__ for f in funcs) == ["_cfg_forward", "model_fn"]
    assert not np.array_equal(served[1.5], served[4.5])
    _use(model, jmodel, DDIM, eta=0.0, ddim_timesteps=5)
    x_T = torch.randn((B, IMG, IMG, 3), generator=torch.Generator().manual_seed(4))
    fn = _jax_model_fn(jmodel, 3, 4.5)
    ref = jax.jit(lambda p, img: jmodel.sampler.p_sample_loop(fn, p, x_T.shape, jax.random.PRNGKey(0), img=img))(
        jmodel.params, jnp.asarray(x_T.numpy()))
    ref_u8 = np.clip(np.asarray(ref) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    assert np.abs(served[4.5].astype(int) - ref_u8.astype(int)).max() <= 1


def test_change_sampler_keeps_conditioning_and_archives_restore(pair, tmp_path):
    jmodel, model = pair
    _use(model, jmodel, DDIM, eta=0.0, ddim_timesteps=5)
    assert model.sampler.use_class_conditioning
    restored = restore_model_from_archive(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    assert type(restored) is ConditionalDDPM and restored.num_classes == K
    x, t, classes = _inputs(4)
    ours = restored.model_fn(restored.params, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(classes))
    apply = jax.jit(lambda p, x, t, c: jmodel.model_fn(p, x, t, classes=c))  # one network: any model's params
    ref = apply(jmodel.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(classes))
    assert _rel_l2(ours.numpy(), ref) < WHOLE_TOL
    path = model.save_to(str(tmp_path / "port.dmn"))
    back = JConditional.restore_from(path)
    assert back.num_classes == K
    ref_back = apply(back.params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(classes))
    assert _rel_l2(np.asarray(ref_back), ref) < WHOLE_TOL


def test_conditional_ddpm_needs_num_classes():
    with pytest.raises(ValueError, match="num_classes"):
        ConditionalDDPM(load_config(YAML, overrides=[*TINY, "model.num_classes=null",
                                                     "model.diffusion_model.num_classes=null"]).model, device="cpu")


@pytest.mark.parametrize("family", ["improved", "conditional"])
def test_family_fit_replays_with_steps_per_execution_equal_eager_single_steps(family):
    """``Trainer.fit`` of each family through the captured step (on the CPU
    its step function on the static buffers: images, labels and every draw,
    the label mask among them, restaged at each step), at
    ``steps_per_execution`` 2, against eager single steps: the same
    parameters and EMA bit for bit."""
    from diffusion_model_nemo_tpu_torch import Trainer
    from diffusion_model_nemo_tpu_torch.models import ImprovedDDPM

    yaml = REPO / f"examples/configs/{family}_ddpm/unet_small.yaml"
    extra = [f"model.num_classes={K}"] if family == "conditional" else []
    cfg = load_config(yaml, overrides=[*TINY[:-1], *extra, "model.train_ds.batch_size=4",
                                       "+model.train_ds.length=16"]).model
    cls = ConditionalDDPM if family == "conditional" else ImprovedDDPM
    runs = []
    for spe, graphs in ((2, True), (1, False)):
        model = cls(cfg, device="cpu", seed=0)
        trainer = Trainer(max_steps=4, log_every_n_steps=2, devices=1, steps_per_execution=spe)
        trainer.fit(model, graphs=graphs)
        runs.append((model, trainer.logged))
    (a, la), (b, lb) = runs
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert all(torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.ema_params)
    assert [m["train_loss"] for m in la] == [m["train_loss"] for m in lb]
