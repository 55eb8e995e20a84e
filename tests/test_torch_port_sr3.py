"""The port's SR3 super-resolution family against the JAX package on the CPU.

The model is the shipped ``examples/configs/sr3/unet_small.yaml`` cut to a
tiny float32 U-Net (dim 8, dim_mults [1, 2], 8 px HR, scale 2, T = 10);
the JAX model gets the port's weights (``utils/weights.py``: the stem's
[7, 7, 6, 8] kernel, 2C in), no flax init. Inputs are numpy-seeded and the
port is fed the JAX draws (the step's flip, t, noise and conditioning
noise; each chain's x_T and step noise; the bits/dim loop's per-t noise).

What is held:
- ``ops/resize.py`` against ``jax.image.resize``: the four SR3 methods,
  both ``antialias`` settings, scales 2, 3 and 4, shrinking and enlarging
  (1e-5);
- the conditioning (``degrade``, ``upsample``), the conditioned forward,
  the training step with ``cond_aug_std`` (loss, whole gradient), the
  ancestral chain and the DDIM chain after a swap, bits/dim and PSNR
  against JAX at the north star's float32 tolerances;
- two LR batches through one captured-graph owner (ancestral, DDIM,
  DPM-Solver++, and two HR batches through bits/dim), each equal to its
  eager loop, nothing captured anew;
- the refusals (``tests/test_sr3.py``'s), the sample dumps' dataset LRs;
- SR3 archives both ways;
- ``/super_resolve`` and ``submit_sr``: seeded runs, chunks, coalescing,
  uint8 and float inputs, the refusals, the HTTP routes.

Tolerances: ops 1e-5; the network 2e-4; chains 1e-3; bits/dim 1e-4
relative (each term 1e-3, as the DDPM's); the step's loss 1e-5 and its
gradient 2e-4 relative L2.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import SR3 as JSR3
from diffusion_model_nemo_tpu.modules.generalized_gaussian_diffusion import (
    GeneralizedGaussianDiffusion as JGeneralized,
)
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import DDPM, SR3, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.ops.resize import resize
from diffusion_model_nemo_tpu_torch.serving import BatchingSampler, serve
from diffusion_model_nemo_tpu_torch.training.trainer import param_grads
from diffusion_model_nemo_tpu_torch.utils.image import to_uint8_tensor
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/sr3/unet_small.yaml"
IMG, LR, T, B = 8, 4, 10, 2
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.scale_factor=2", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=8",
]
COND_AUG = ["+model.cond_aug_std=0.3"]
DDIM = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
DPM = "diffusion_model_nemo.modules.DPMSolverDiffusion"
OP_TOL, WHOLE_TOL, CHAIN_TOL, BPD_TOL = 1e-5, 2e-4, 1e-3, 1e-4
SHAPE = (B, IMG, IMG, 3)


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


def _model(extra=()):
    return SR3(load_config(YAML, overrides=[*TINY, *extra]).model, device="cpu", seed=0)


def _jax_of(model, extra=()):
    jmodel = JSR3(cfg=j_load_config(YAML, overrides=[*TINY, *extra]).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    jmodel.ema_params = jmodel.params
    return jmodel


@pytest.fixture(scope="module")
def pair():
    model = _model()
    model.base_sampler = dict(model.cfg.sampler)
    return _jax_of(model), model


def _uniform(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


# -------------------------------------------------------------- the resize --
@pytest.mark.parametrize("method", ["bilinear", "bicubic", "lanczos3", "nearest"])
def test_resize_matches_jax_image_resize(method):
    """Both antialias settings, scales 2-4, shrinking [2, 24, 24, 3] and
    enlarging [2, 6, 6, 3] (one axis pair at a time: the batch and channel
    axes are left alone, as JAX leaves an equal axis)."""
    rng = np.random.default_rng(0)
    for antialias in (True, False):
        for s in (2, 3, 4):
            for size, out in ((24, 24 // s), (6, 6 * s)):
                x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
                shape = (2, out, out, 3)
                ref = np.asarray(jax.image.resize(jnp.asarray(x), shape, method=method, antialias=antialias))
                ours = resize(torch.from_numpy(x), shape, method, antialias).numpy()
                np.testing.assert_allclose(ours, ref, atol=OP_TOL, rtol=0, err_msg=f"{method} aa={antialias} s={s}")
    with pytest.raises(ValueError, match="Unknown resize method"):
        resize(torch.zeros(1, 4, 4, 1), (1, 2, 2, 1), "area")


# ---------------------------------------------------------- conditioning --
def test_network_takes_2c_channels_and_the_conditioned_forward_matches_jax(pair):
    jmodel, model = pair
    assert tuple(model.params["init_conv.weight"].shape) == (8, 6, 7, 7)
    assert jmodel.params["init_conv"]["kernel"].shape == (7, 7, 6, 8)
    assert tuple(model.params["final_conv.weight"].shape)[0] == 3
    x, cond = _uniform(1, SHAPE), _uniform(2, SHAPE)
    t = np.asarray([3, 8], np.int32)
    ref = jit0(lambda p, x, t, c: jmodel.get_model_fn(cond=c)(p, x, t), jmodel.params, jnp.asarray(x),
               jnp.asarray(t), jnp.asarray(cond))
    with torch.inference_mode():
        ours = model.get_model_fn(cond=torch.from_numpy(cond))(model.params, torch.from_numpy(x), torch.from_numpy(t))
        other = model.get_model_fn(cond=-torch.from_numpy(cond))(model.params, torch.from_numpy(x),
                                                                  torch.from_numpy(t))
    assert _rel_l2(ours.numpy(), ref) < WHOLE_TOL
    assert float((ours - other).abs().max()) > 1e-4  # the condition reaches the network


def test_degrade_and_upsample_match_jax(pair):
    jmodel, model = pair
    hr = _uniform(4, SHAPE)
    lr = model.degrade(torch.from_numpy(hr))
    assert tuple(lr.shape) == (B, LR, LR, 3)
    np.testing.assert_allclose(lr.numpy(), np.asarray(jmodel.degrade(jnp.asarray(hr))), atol=OP_TOL, rtol=0)
    np.testing.assert_allclose(model._lowres_condition(torch.from_numpy(hr)).numpy(),
                               np.asarray(jmodel._lowres_condition(jnp.asarray(hr))), atol=OP_TOL, rtol=0)
    const = torch.full((1, IMG, IMG, 1), 0.3)
    np.testing.assert_allclose(model._lowres_condition(const).numpy(), 0.3, atol=1e-6)


def test_training_step_with_cond_aug_matches_jax():
    """The step with ``cond_aug_std`` 0.3, fed the JAX step's flip, t,
    noise and the conditioning noise ``normal(fold_in(k_drop, 0x5347))``:
    the loss and the whole gradient; the conditioning noise reaches the
    network, and without ``cond_aug_std`` nothing is drawn for it."""
    model = _model(COND_AUG)
    jmodel = _jax_of(model, COND_AUG)
    rng = np.random.default_rng(3)
    batch = {"image": rng.integers(0, 256, SHAPE, dtype=np.uint8)}
    key = jax.random.PRNGKey(11)

    def step(p):
        loss, _ = jmodel.training_step(p, jax.tree.map(jnp.asarray, batch), key, 0)
        k_pre, k_t, k_noise, k_drop = jax.random.split(key, 4)
        draws = {"flip": jax.random.bernoulli(k_pre, 0.5, (B,)),
                 "t": jax.random.randint(k_t, (B,), 0, T, dtype=jnp.int32),
                 "noise": jax.random.normal(k_noise, SHAPE, jnp.float32),
                 "cond_aug": jax.random.normal(jax.random.fold_in(k_drop, 0x5347), SHAPE, jnp.float32)}
        return loss, draws

    lowered = jax.jit(jax.value_and_grad(step, has_aux=True)).lower(jmodel.params)
    (jloss, jdraws), jgrads = lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(jmodel.params)
    drawn = model.draw_training_inputs(SHAPE, _gen(0))
    assert set(drawn) == set(jdraws) and tuple(drawn["cond_aug"].shape) == SHAPE
    assert "cond_aug" not in _model().draw_training_inputs(SHAPE, _gen(0))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in jdraws.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, _metrics = model.training_step(params, batch, draws)
    grads = param_grads(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=OP_TOL)
    ours = to_flax_params({k: g.detach() for k, g in grads.items()}, model.diffusion_model)
    flat = lambda tree: np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])  # noqa: E731
    assert _rel_l2(flat(ours), flat(jax.tree.map(np.asarray, jgrads))) < WHOLE_TOL
    quiet = dict(draws, cond_aug=torch.zeros(SHAPE))
    assert abs(float(model.training_step(model.params, batch, quiet)[0]) - float(loss.detach())) > 1e-6


# ---------------------------------------------------------------- chains --
def test_ancestral_and_ddim_chains_match_jax(pair):
    """``super_resolve`` (the ancestral chain through the CPU replays) from
    the JAX steps fed the same x_T and noise; then DDIM-5 (eta 0) after a
    swap against the JAX scan from the same x_T, both bound to the same
    upsampled LR."""
    jmodel, model = pair
    model.change_sampler(model.base_sampler)
    lr = _uniform(5, (B, LR, LR, 3), 0.0, 1.0)
    cond = np.asarray(jmodel.upsample(jnp.asarray(lr) * 2.0 - 1.0))
    ours = model.super_resolve(torch.from_numpy(lr), generator=_gen(), graphs=True).numpy()
    step = jax.jit(lambda p, x, t, c: tuple(jmodel.sampler.p_mean_variance(jmodel.get_model_fn(cond=c), p, x, t))[::2])
    gen = _gen()
    x = jnp.asarray(torch.randn(SHAPE, generator=gen).numpy())
    for t in range(T - 1, -1, -1):
        mean, log_var = step(jmodel.params, x, jnp.int32(t), jnp.asarray(cond))
        x = mean + (jnp.exp(0.5 * log_var) * jnp.asarray(torch.randn(SHAPE, generator=gen).numpy()) if t else 0.0)
    np.testing.assert_allclose(ours, np.asarray((x + 1.0) * 0.5), atol=CHAIN_TOL, rtol=CHAIN_TOL)

    model.change_sampler(dict(model.base_sampler, _target_=DDIM, eta=0.0, ddim_timesteps=5))
    ours = model.super_resolve(torch.from_numpy(lr), generator=_gen(), graphs=True).numpy()
    x_T = torch.randn(SHAPE, generator=_gen()).numpy()
    ddim = JGeneralized(timesteps=T, schedule_name="cosine", eta=0.0, ddim_timesteps=5)
    ref = jit0(lambda p, img, c: ddim.p_sample_loop(jmodel.get_model_fn(cond=c), p, SHAPE, jax.random.PRNGKey(0),
                                                    img=img), jmodel.params, jnp.asarray(x_T), jnp.asarray(cond))
    np.testing.assert_allclose(ours, np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    model.change_sampler(model.base_sampler)


@pytest.mark.parametrize("sampler", ["ancestral", "ddim", "dpm"])
def test_two_lr_batches_replay_one_graph_each_equal_to_its_eager_chain(pair, sampler):
    """Two different LR batches back to back through the sampler's graph
    owner: the second replays the first's graph (its condition refilled
    into the static buffer), and each output equals its own eager chain."""
    _jmodel, model = pair
    fields = {"ancestral": {}, "ddim": dict(_target_=DDIM, eta=0.0, ddim_timesteps=5),
              "dpm": dict(_target_=DPM, solver_steps=4)}[sampler]
    model.change_sampler(dict(model.base_sampler, **fields))
    try:
        lrs = [torch.from_numpy(_uniform(s, (B, LR, LR, 3), 0.0, 1.0)) for s in (6, 7)]
        first = model.super_resolve(lrs[0], generator=_gen(), graphs=True)
        graphs = dict(model.sampler.graphs)
        second = model.super_resolve(lrs[1], generator=_gen(), graphs=True)
        assert graphs and model.sampler.graphs.keys() == graphs.keys()
        assert all(model.sampler.graphs[k] is graphs[k] for k in graphs)
        for lr, out in zip(lrs, (first, second)):
            assert torch.equal(out, model.super_resolve(lr, generator=_gen(), graphs=False))
        assert not torch.equal(first, second)
    finally:
        model.change_sampler(model.base_sampler)


def test_bits_per_dimension_matches_jax(pair):
    """Conditional bits/dim, the LR derived from the batch (down → up), fed
    the JAX scan's per-t noise; the captured loop equals the eager one."""
    jmodel, model = pair
    x = np.random.default_rng(8).integers(0, 256, SHAPE).astype(np.float32) / 127.5 - 1.0
    key = jax.random.PRNGKey(11)
    ref = jmodel.calculate_bits_per_dimension(jnp.asarray(x), key=key)
    noise, k = [], key
    for _ in range(T):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, SHAPE, jnp.float32)))
    noise = torch.from_numpy(np.stack(noise))
    ours = model.calculate_bits_per_dimension(torch.from_numpy(x), noise=noise, graphs=True)
    eager = model.calculate_bits_per_dimension(torch.from_numpy(x), noise=noise, graphs=False)
    assert all(torch.equal(ours[k], eager[k]) for k in ours)
    for name in ("total_bpd", "prior_bpd"):
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(ref[name]), rtol=BPD_TOL)
    # each term as tests/test_torch_port_archive.py holds the DDPM's
    np.testing.assert_allclose(ours["terms_bpd"].numpy(), np.asarray(ref["terms_bpd"]), rtol=1e-3, atol=1e-5)


def test_bits_per_dimension_of_two_batches_replays_one_graph_with_each_condition(pair):
    """Two HR batches back to back through the bits/dim graph: one graph,
    each batch's own condition (equal to its eager loop). The JAX package's
    jit is cached on the shape alone and keeps the first batch's condition."""
    _jmodel, model = pair
    xs = [torch.from_numpy(_uniform(s, SHAPE)) for s in (12, 13)]
    first = model.calculate_bits_per_dimension(xs[0], generator=_gen(), graphs=True)
    held = dict(model.sampler.graphs)
    second = model.calculate_bits_per_dimension(xs[1], generator=_gen(), graphs=True)
    assert held and model.sampler.graphs.keys() == held.keys()
    assert all(model.sampler.graphs[k] is held[k] for k in held)
    for x, out in zip(xs, (first, second)):
        assert torch.equal(out["total_bpd"], model.calculate_bits_per_dimension(x, generator=_gen(), graphs=False)[
            "total_bpd"])


def test_psnr_matches_jax(pair):
    jmodel, model = pair
    a, b = _uniform(9, SHAPE, 0.0, 1.0), _uniform(10, SHAPE, 0.0, 1.0)
    np.testing.assert_allclose(model.psnr(torch.from_numpy(a), b).numpy(), np.asarray(jmodel.psnr(a, b)),
                               rtol=OP_TOL)
    assert float(model.psnr(a, a)[0]) == pytest.approx(120.0)  # the 1e-12 floor


# ------------------------------------------------------------- refusals --
@pytest.mark.parametrize("extra,match", [
    (["model.scale_factor=3"], "not divisible"), (["model.scale_factor=1"], "scale_factor must be"),
    (["model.lowres_method=area"], "lowres_method must be"), (["+model.cond_aug_std=-0.1"], "cond_aug_std"),
], ids=["indivisible", "scale-1", "area", "negative-cond-aug"])
def test_invalid_configs_are_refused_as_jax(extra, match):
    for build in (lambda: _model(extra), lambda: JSR3(cfg=j_load_config(YAML, overrides=[*TINY, *extra]).model)):
        with pytest.raises(ValueError, match=match):
            build()


def test_unconditioned_uses_are_refused_as_jax(pair):
    jmodel, model = pair
    with pytest.raises(ValueError, match="needs low-res conditioning"):
        model.get_model_fn()(model.params, torch.zeros(1, IMG, IMG, 3), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs low-res conditioning"):
        jmodel.get_model_fn()(jmodel.params, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)))
    for m in (model, jmodel):
        with pytest.raises(NotImplementedError, match="interpolate is undefined"):
            m.interpolate(None, None)
    bare = _model(["model.train_ds.name=null"])
    with pytest.raises(ValueError, match="needs lr="):
        bare.sample(2, IMG)


def test_sample_dumps_super_resolve_the_first_batch_of_the_loader(pair):
    """Without ``lr`` the dumps' path degrades the loader's first batch
    (kept for later dumps) and super-resolves it."""
    _jmodel, model = pair
    model.setup_test_data(model.cfg.train_ds)  # in order: every iteration reads the same first batch
    from diffusion_model_nemo_tpu_torch.data import preprocess_batch

    out = model.sample(3, IMG, generator=_gen(4))
    hr = preprocess_batch(next(iter(model._test_dl)), "cpu")["pixel_values"]
    ref = model.super_resolve(model.degrade(hr)[:3], generator=_gen(4), data_space=True)
    assert torch.equal(out, ref) and out.shape == (3, IMG, IMG, 3)


def test_archives_restore_across_packages_as_sr3(pair, tmp_path):
    jmodel, model = pair
    from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore

    jback = j_restore(model.save_to(str(tmp_path / "port.dmn")))
    assert type(jback).__name__ == "SR3" and jback.scale_factor == 2
    for a, b in zip(jax.tree.leaves(jback.params), jax.tree.leaves(jmodel.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back = restore_model_from_archive(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    assert type(back) is SR3 and back.scale_factor == 2 and back.lowres_method == "bicubic"
    assert all(torch.equal(back.params[k], model.params[k]) for k in model.params)
    lr = torch.from_numpy(_uniform(11, (B, LR, LR, 3), 0.0, 1.0))
    assert torch.equal(back.super_resolve(lr, generator=_gen()), model.super_resolve(lr, generator=_gen()))


# -------------------------------------------------------------- serving --
def _call(srv, method, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npy_b64(arr) -> str:
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _served_ref(model, lr, seed, max_batch):
    """The seeded batch as the server computes it: the LR padded with zero
    rows to ``max_batch``, EMA weights, quantized to uint8."""
    padded = torch.zeros((max_batch, LR, LR, 3))
    padded[: lr.shape[0]] = torch.as_tensor(lr)
    out = model.super_resolve(padded, generator=torch.Generator().manual_seed(seed), use_ema=True)
    return to_uint8_tensor(out)[: lr.shape[0]].numpy()


def test_submit_sr_seeded_chunked_coalesced_and_refused(pair):
    _jmodel, model = pair
    model.change_sampler(model.base_sampler)
    batcher = BatchingSampler(model, IMG, max_batch=2, linger_ms=1.0).start(warmup=False)
    try:
        lr8 = np.random.default_rng(12).integers(0, 256, (3, LR, LR, 3), dtype=np.uint8)
        out = batcher.submit_sr(lr8, seed=5)
        lr = lr8.astype(np.float32) / 255.0
        assert out.dtype == np.uint8 and out.shape == (3, IMG, IMG, 3)
        np.testing.assert_array_equal(out[:2], _served_ref(model, lr[:2], 5, 2))  # chunk 0: seed 5
        np.testing.assert_array_equal(out[2:], _served_ref(model, lr[2:], 6, 2))  # chunk 1: seed 6
        np.testing.assert_array_equal(batcher.submit_sr(lr, seed=5), out)  # floats in [0, 1] alike
        with batcher.hold():
            before = batcher.snapshot_stats()["batches"]
            got = {}
            threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, batcher.submit_sr(lr[i: i + 1])))
                       for i in range(2)]
            for th in threads:
                th.start()
            while batcher.queued() < 2:
                time.sleep(0.001)
        for th in threads:
            th.join(timeout=120)
        assert batcher.snapshot_stats()["batches"] == before + 1 and all(g.shape == (1, IMG, IMG, 3)
                                                                         for g in got.values())
        for bad, match in (((2, LR + 1, LR, 3), "LR inputs must be"), ((LR, LR, 3), "must be \\[n, h, w, C\\]")):
            with pytest.raises(ValueError, match=match):
                batcher.submit_sr(np.zeros(bad, np.float32))
        with pytest.raises(ValueError, match="must be in \\[0, 1\\]"):
            batcher.submit_sr(np.full((1, LR, LR, 3), 200.0, np.float32))
        with pytest.raises(ValueError, match="/super_resolve"):
            batcher.submit(1)
        with pytest.raises(ValueError, match="generation archive"):
            batcher.submit_edit(np.zeros((1, IMG, IMG, 3), np.float32))
    finally:
        batcher.stop()


def test_super_resolve_route_and_the_other_archives_refusals(pair):
    """/super_resolve answers an SR3 archive (npy and png), /sample on it
    answers 400 naming the route; a DDPM archive answers /super_resolve 400."""
    _jmodel, model = pair
    srv = serve(model, port=0, max_batch=2, ddim_timesteps=5)
    srv.start_background()
    try:
        assert json.loads(_call(srv, "GET", "/healthz")[1])["mode"] == "super_resolve"
        lr8 = np.random.default_rng(13).integers(0, 256, (2, LR, LR, 3), dtype=np.uint8)
        code, body = _call(srv, "POST", "/super_resolve", {"images_npy": _npy_b64(lr8), "seed": 3, "format": "npy"})
        assert code == 200
        out = np.load(io.BytesIO(body))
        assert out.shape == (2, IMG, IMG, 3) and out.dtype == np.uint8
        np.testing.assert_array_equal(out, _served_ref(model, lr8.astype(np.float32) / 255.0, 3, 2))
        code, body = _call(srv, "POST", "/super_resolve", {"images_npy": _npy_b64(lr8), "seed": 3})
        assert code == 200 and len(json.loads(body)["images"]) == 2
        code, body = _call(srv, "POST", "/sample", {"num_images": 1})
        assert code == 400 and b"/super_resolve" in body
        assert _call(srv, "POST", "/super_resolve", {})[0] == 400
    finally:
        srv.shutdown()
        model.change_sampler(model.base_sampler)
    ddpm = DDPM(load_config(YAML, overrides=TINY).model, device="cpu")
    assert not hasattr(ddpm, "super_resolve")
    batcher = BatchingSampler(ddpm, IMG, max_batch=2)
    with pytest.raises(ValueError, match="requires an SR3 archive"):
        batcher.submit_sr(np.zeros((1, LR, LR, 3), np.float32))
