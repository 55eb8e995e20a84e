"""The PyTorch port's training slice against the JAX package, on the CPU.

Loss, data, optimizer, clip, schedule and EMA are held to the JAX package's
pieces (optax underneath) step by step; every kernel's autograd Function to
autograd through its plain version; and 8 full DDPM training steps of a
small U-Net (dim 8, dim_mults [1, 2], 4 groups, 8×8) to the JAX package's
``q_sample`` → ``Unet.apply`` → ``DiffusionLoss`` → ``build_optimizer``
(global-norm clip 1.0 + AdamW, cosine schedule) → ``ema_update``, from the
same weights (weight carrier) and the same injected draws (x0 from the same
uint8 batch, t, noise, flip mask), since the two RNG streams differ.

Tolerances, each with its reason:
- loss values, float32: 1e-6 (the same arithmetic on one element at a time);
- optimizer steps on random leaves: rtol 1e-5 / atol 1e-6 over ten updates
  (optax computes the bias corrections and the schedule in float32, the
  port in float64); clip, global norm and EMA: 1e-6 relative;
- lockstep training, float32: losses rtol 1e-4 / atol 1e-6, parameters and
  EMA atol 5e-4 / rtol 5e-3, as tests/test_torch_parity_training.py (Adam
  divides by √v̂, which amplifies float noise where v̂ is near zero);
- lockstep training, bf16 compute: losses rtol 2e-2 (both packages round
  ~40 intermediates to bf16 at slightly different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_model_nemo_tpu.data import hf_vision_data as JD
from diffusion_model_nemo_tpu.loss.simple_loss import DiffusionLoss as JLoss
from diffusion_model_nemo_tpu.modules.gaussian_diffusion import GaussianDiffusion as JGaussian
from diffusion_model_nemo_tpu.modules.unet import Unet as JUnet
from diffusion_model_nemo_tpu.training.ema import ema_update as j_ema_update
from diffusion_model_nemo_tpu.training.optim import build_lr_schedule as j_schedule
from diffusion_model_nemo_tpu.training.optim import build_optimizer as j_build_optimizer
from diffusion_model_nemo_tpu_torch import DDPM, Trainer
from diffusion_model_nemo_tpu_torch.config import unet_small_model_config
from diffusion_model_nemo_tpu_torch.data import hf_vision_data as TD
from diffusion_model_nemo_tpu_torch.loss import DiffusionLoss
from diffusion_model_nemo_tpu_torch.ops import attention as TA
from diffusion_model_nemo_tpu_torch.ops import norm as TN
from diffusion_model_nemo_tpu_torch.ops.recompute import kernel_call
from diffusion_model_nemo_tpu_torch.training import build_lr_schedule, build_optimizer, ema_decay_table, ema_update
from diffusion_model_nemo_tpu_torch.training.optim import clip_by_global_norm, global_norm
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

STEPS = 8
IMG = 8
BATCH = 4
NET = dict(dim=8, dim_mults=[1, 2], resnet_block_groups=4)


# ------------------------------------------------------------------- loss --
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", "batch_mean"])
@pytest.mark.parametrize("loss_type", ["l1", "l2", "huber"])
def test_diffusion_loss_matches_jax(loss_type, reduction):
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((3, 4, 4, 2)) * 1.5, rng.standard_normal((3, 4, 4, 2))
    ours = DiffusionLoss(loss_type, reduction)(torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32))
    ref = JLoss(loss_type, reduction)(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_diffusion_loss_rejects_unknown_options():
    with pytest.raises(ValueError):
        DiffusionLoss("l3")
    with pytest.raises(ValueError):
        DiffusionLoss("l2", "median")


# ------------------------------------------------------------------- data --
@pytest.mark.parametrize("shuffle", [True, False])
def test_synthetic_batches_are_bit_identical_to_jax(shuffle):
    """Two epochs of the synthetic set through both loaders: the same uint8
    images and labels in the same order."""
    kw = dict(image_size=8, channels=3, num_classes=10, length=40, seed=3)
    ours = TD.DataLoader(TD.SyntheticVisionDataset(**kw), batch_size=8, shuffle=shuffle, seed=5)
    ref = JD.DataLoader(JD.SyntheticVisionDataset(**kw), batch_size=8, shuffle=shuffle, seed=5)
    assert len(ours) == len(ref) == 5
    for _epoch in range(2):
        pairs = list(zip(ours, ref))
        assert len(pairs) == 5
        for a, b in pairs:
            assert a["image"].dtype == np.uint8 and a["image"].shape == (8, 8, 8, 3)
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])


def test_build_dataloader_from_the_train_ds_block():
    cfg = dict(unet_small_model_config()["train_ds"], name="synthetic", batch_size=16, image_size=8)
    dl = TD.build_dataloader(cfg, mode="train")
    assert dl.shuffle and dl.batch_size == 16 and len(dl) == 512 // 16
    with pytest.raises(NotImplementedError, match="datasets"):
        TD.build_dataloader(dict(cfg, name="cifar10"), mode="train")


def test_preprocess_matches_jax_with_the_same_flip():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(6, 8, 8, 3), dtype=np.uint8)
    flip = np.array([True, False, True, True, False, False])
    ours = TD.preprocess_batch({"image": img}, "cpu", flip=torch.from_numpy(flip))["pixel_values"]
    x = jnp.asarray(img).astype(jnp.float32) / 127.5 - 1.0
    ref = jnp.where(jnp.asarray(flip)[:, None, None, None], x[:, :, ::-1, :], x)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # the JAX package's own preprocess without a key is the unflipped batch
    plain = JD.preprocess_batch({"image": jnp.asarray(img)}, None, train=True)["pixel_values"]
    np.testing.assert_array_equal(TD.preprocess_batch({"image": img}, "cpu")["pixel_values"].numpy(), np.asarray(plain))


# -------------------------------------------------------- optimizer pieces --
_SCHEDULES = {
    "unet_small": unet_small_model_config()["optim"],
    "warmup_steps": dict(lr=2e-3, sched=dict(name="CosineAnnealing", warmup_steps=4, min_lr=1e-5)),
    "warmup_ratio": dict(lr=1e-3, sched=dict(name="CosineAnnealing", warmup_ratio=0.25, min_lr=0.0)),
    "constant": dict(lr=3e-4, sched=None),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_lr_schedule_matches_optax(name):
    """Within 1e-6 of the peak lr: optax evaluates the cosine in float32,
    where 1 + cos(π·t/T) cancels near the end of the decay."""
    cfg = _SCHEDULES[name]
    ours, ref = build_lr_schedule(cfg, 20), j_schedule(cfg, 20)
    for step in range(24):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-6 * cfg["lr"], err_msg=str(step))


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "b.weight": (2, 2, 3, 3)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    g = _leaves(2)
    ours = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    ref, _ = optax.clip_by_global_norm(max_norm).update({k: jnp.asarray(v) for k, v in g.items()}, None)
    np.testing.assert_allclose(
        float(global_norm({k: torch.from_numpy(v) for k, v in g.items()})),
        float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6,
    )
    for k in g:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "optim",
    [
        unet_small_model_config()["optim"],
        dict(name="adam", lr=1e-3, betas=[0.9, 0.999], sched=dict(name="CosineAnnealing", warmup_steps=2)),
        dict(name="sgd", lr=1e-2, momentum=0.9),
    ],
    ids=["adamw_unet_small", "adam_warmup", "sgd_momentum"],
)
def test_optimizer_steps_match_optax(optim):
    """Ten updates with the global-norm clip at 1.0 in front, gradients
    large enough that some steps clip and some do not."""
    p = _leaves(3)
    ours_p = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ref_p = {k: jnp.asarray(v) for k, v in p.items()}
    opt, _ = build_optimizer(optim, 10, grad_clip=1.0)
    state, table = opt.init(ours_p), opt.table(9, "cpu")
    tx, _ = j_build_optimizer(optim, 10, grad_clip=1.0)
    ref_state = tx.init(ref_p)
    for i in range(10):
        g = _leaves(100 + i, scale=0.4 if i % 2 else 0.05)
        opt.step(ours_p, {k: torch.from_numpy(v) for k, v in g.items()}, state, scalars=table[i])
        upd, ref_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, ref_state, ref_p)
        ref_p = optax.apply_updates(ref_p, upd)
        for k in p:
            np.testing.assert_allclose(ours_p[k].numpy(), np.asarray(ref_p[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {k}")


def test_ema_matches_jax_step_by_step():
    """The warm-up decay min(decay, (1+step)/(10+step)) from step 0 (d = 0.1)."""
    e, p = _leaves(4), _leaves(5)
    ours = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    ref = {k: jnp.asarray(v) for k, v in e.items()}
    table = ema_decay_table(0.9999, 11, "cpu")
    for step in range(12):
        params = _leaves(50 + step)
        ema_update(ours, {k: torch.from_numpy(v) for k, v in params.items()}, table[step])
        ref = j_ema_update(ref, {k: jnp.asarray(v) for k, v in params.items()}, 0.9999, jnp.int32(step))
        for k in p:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------- autograd of the kernels --
def _no_kernel(*args):
    raise AssertionError("a CPU tensor reached a kernel wrapper")


def _lin_block_args(C=32, N=64, B=2, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    hd = 128

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).requires_grad_(True)

    return [r(B, N, C, scale=0.5).to(dtype).detach().requires_grad_(True),
            (1 + r(C, scale=0.1)).detach().requires_grad_(True), r(C, scale=0.1),
            r(C, 3 * hd, scale=C**-0.5), r(hd, C, scale=hd**-0.5), r(C, scale=0.1),
            (1 + r(C, scale=0.1)).detach().requires_grad_(True), r(C, scale=0.1)]


def _kernel_cases():
    g = torch.Generator().manual_seed(7)

    def r(*s):
        return torch.randn(*s, generator=g).requires_grad_(True)

    gn = [r(2, 4, 4, 16), (1 + 0.1 * torch.randn(16, generator=g)).requires_grad_(True), r(16)]
    film = gn + [r(2, 1, 1, 16), r(2, 1, 1, 16)]
    consts_gn = (4, 1e-5)
    lin = _lin_block_args()
    small = _lin_block_args(C=64, N=16)[:6]
    tok = [r(2, 64, 32), r(32, 384)]
    return {
        "group_norm_silu": (TN.group_norm_silu_reference, gn, consts_gn, ()),
        "group_norm_silu_film": (TN.group_norm_silu_reference, gn, consts_gn, film[3:]),
        "group_norm_silu_bm": (TN.group_norm_silu_reference, film[:3], consts_gn, film[3:]),
        "linear_attention_block": (TA.linear_attention_block_reference, lin, (4, 32, 32**-0.5, 1e-5), ()),
        "linear_attention_block_v1": (TA.linear_attention_block_reference, _lin_block_args(seed=1),
                                      (4, 32, 32**-0.5, 1e-5), ()),
        "linear_attention_tokens": (TA.linear_attention_tokens_reference, tok, (4, 32, 32**-0.5), ()),
        "attention_block_small": (TA.attention_block_reference, small, (4, 32, 32**-0.5, 1e-5), ()),
        "linear_attention_qkv": (TA.linear_attention_qkv_reference, [r(2, 64, 384)], (4, 32, 32**-0.5), ()),
        "attention": (TA.attention_reference, [r(1, 32, 2, 16), r(1, 32, 2, 16), r(1, 32, 2, 16)], (), ()),
    }


@pytest.mark.parametrize("name", sorted(_kernel_cases()))
def test_kernel_function_backward_matches_autograd_through_plain(name):
    """Each kernel's differentiable call (forced through the Function with the
    plain forward, as a CPU tensor runs it) gives the output and the
    gradients of every tensor input, weights included, that autograd gives
    through the plain version directly."""
    plain, tensors, consts, tail = _kernel_cases()[name]
    args = (*tensors, *consts, *tail)
    ours = kernel_call(_no_kernel, plain, *args)
    ref = plain(*args)
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    wrt = [t for t in (*tensors, *tail)]
    cot = torch.randn(ref.shape, generator=torch.Generator().manual_seed(9)).to(ref.dtype)
    g_ours = torch.autograd.grad(ours, wrt, cot)
    g_ref = torch.autograd.grad(ref, wrt, cot)
    assert len(g_ours) == len(wrt) >= 1
    for a, b in zip(g_ours, g_ref):
        assert a is not None and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_kernel_function_skips_inputs_that_need_no_grad():
    x = torch.randn(2, 4, 4, 16, requires_grad=True)
    gamma, beta = torch.ones(16), torch.zeros(16)
    out = kernel_call(_no_kernel, TN.group_norm_silu_reference, x, gamma, beta, 4, 1e-5)
    (gx,) = torch.autograd.grad(out.sum(), [x])
    ref = torch.autograd.grad(TN.group_norm_silu_reference(x, gamma, beta, 4).sum(), [x])[0]
    torch.testing.assert_close(gx, ref, rtol=0, atol=0)
    assert gamma.grad is None and beta.grad is None


# ------------------------------------------------------ lockstep training --
def _small_cfg(dtype: str):
    cfg = unet_small_model_config(image_size=IMG)
    cfg["diffusion_model"].update(NET, input_dim=IMG, dtype=dtype)
    return cfg


def _draws(seed=0):
    """Shared draws: uint8 images from the synthetic set, flip masks, t, noise."""
    ds = TD.SyntheticVisionDataset(image_size=IMG, channels=3, length=64, seed=seed)
    images = np.stack([np.stack([ds[i * BATCH + j]["image"] for j in range(BATCH)]) for i in range(STEPS)])
    rng = np.random.default_rng(seed + 1)
    flips = rng.random((STEPS, BATCH)) < 0.5
    ts = rng.integers(0, 1000, size=(STEPS, BATCH)).astype(np.int32)
    noises = rng.standard_normal((STEPS, BATCH, IMG, IMG, 3)).astype(np.float32)
    return images, flips, ts, noises


def run_lockstep(dtype: str):
    cfg = _small_cfg(dtype)
    jnet = JUnet(**dict(NET, dim_mults=tuple(NET["dim_mults"])), channels=3, use_convnext=False, dtype=dtype)
    init = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,), jnp.float32))
    jparams = jax.tree.map(lambda a: jnp.array(np.asarray(a), copy=True), init["params"])

    model = DDPM(cfg, device="cpu", seed=0)
    model.params = from_flax_params(jax.tree.map(np.asarray, jparams), model.diffusion_model)
    model.ema_params = {k: v.clone() for k, v in model.params.items()}
    trainer = Trainer(gradient_clip_val=1.0, ema_decay=0.9999)
    state = trainer.init_state(model, STEPS)

    proc = JGaussian(**{k: v for k, v in cfg["sampler"].items() if k != "_target_"})
    jloss = JLoss("l2", "mean")
    tx, j_sched = j_build_optimizer(cfg["optim"], STEPS, grad_clip=1.0)

    @jax.jit
    def j_step(params, opt_state, ema, x0, t, noise, step):
        def loss_fn(p):
            x_t = proc.q_sample(x_start=x0, t=t, noise=noise)
            return jloss(jnet.apply({"params": p}, x_t, t), noise)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = j_ema_update(ema, params, 0.9999, step)
        return params, opt_state, ema, loss, optax.global_norm(grads)

    images, flips, ts, noises = _draws()
    j_opt, j_ema = tx.init(jparams), jax.tree.map(jnp.copy, jparams)
    out = {"ours": [], "ref": [], "gnorm": [], "ref_gnorm": [], "lr": [], "ref_lr": []}
    for i in range(STEPS):
        out["lr"].append(trainer.lr_schedule(state.step))
        out["ref_lr"].append(float(j_sched(i)))
        draws = {"flip": torch.from_numpy(flips[i]), "t": torch.from_numpy(ts[i]),
                 "noise": torch.from_numpy(noises[i])}
        metrics = trainer.train_step(model, state, {"image": images[i]}, draws)
        out["ours"].append(float(metrics["train_loss"]))
        out["gnorm"].append(float(metrics["grad_norm"]))
        x = jnp.asarray(images[i]).astype(jnp.float32) / 127.5 - 1.0
        x0 = jnp.where(jnp.asarray(flips[i])[:, None, None, None], x[:, :, ::-1, :], x)
        jparams, j_opt, j_ema, loss, gn = j_step(
            jparams, j_opt, j_ema, x0, jnp.asarray(ts[i]), jnp.asarray(noises[i]), jnp.int32(i)
        )
        out["ref"].append(float(loss))
        out["ref_gnorm"].append(float(gn))
    net = model.diffusion_model
    out["params"] = (to_flax_params(state.params, net), jax.tree.map(np.asarray, jparams))
    out["ema"] = (to_flax_params(state.ema_params, net), jax.tree.map(np.asarray, j_ema))
    out["start"] = jax.tree.map(np.asarray, init["params"])
    return out


@pytest.fixture(scope="module")
def lockstep_f32():
    return run_lockstep("float32")


def test_lockstep_losses_and_lr_match_jax(lockstep_f32):
    r = lockstep_f32
    np.testing.assert_allclose(r["ours"], r["ref"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r["gnorm"], r["ref_gnorm"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r["lr"], r["ref_lr"], rtol=1e-6)
    assert r["lr"][0] == 1e-3  # the first update uses lr(0)


@pytest.mark.parametrize("which", ["params", "ema"])
def test_lockstep_params_and_ema_match_jax(lockstep_f32, which):
    ours, ref = lockstep_f32[which]
    flat_ours = dict(jax.tree_util.tree_leaves_with_path(ours))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat_ours) == len(flat_ref)
    moved = 0.0
    for path, leaf in flat_ref:
        np.testing.assert_allclose(flat_ours[path], leaf, atol=5e-4, rtol=5e-3, err_msg=str(path))
    for path, leaf in jax.tree_util.tree_leaves_with_path(lockstep_f32["start"]):
        moved = max(moved, float(np.abs(flat_ours[path] - leaf).max()))
    assert moved > 1e-4  # the comparison is not vacuous: the leaves moved


def test_lockstep_bf16_losses_match_jax():
    r = run_lockstep("bfloat16")
    assert np.all(np.isfinite(r["ours"]))
    np.testing.assert_allclose(r["ours"], r["ref"], rtol=2e-2)


# ------------------------------------------------------------------- fit --
def _fit_model(**cfg_overrides):
    cfg = _small_cfg("float32")
    cfg["train_ds"].update(name="synthetic", batch_size=4, length=16)
    cfg.update(cfg_overrides)
    return DDPM(cfg, device="cpu", seed=0)


def test_fit_runs_steps_on_the_cpu():
    model = _fit_model()
    before = {k: v.clone() for k, v in model.params.items()}
    trainer = Trainer(max_steps=6, log_every_n_steps=2, devices=1)
    trainer.fit(model)
    assert [m["global_step"] for m in trainer.logged] == [2, 4, 6]
    assert all(np.isfinite(m["train_loss"]) and m["grad_norm"] > 0 for m in trainer.logged)
    assert trainer.logged[-1]["learning_rate"] == pytest.approx(1e-4)  # min_lr at max_steps
    assert any(not torch.equal(before[k], model.params[k]) for k in before)
    assert any(not torch.equal(before[k], model.ema_params[k]) for k in before)
    assert not any(v.requires_grad for v in model.params.values())


def test_fit_by_epochs_counts_the_loader():
    model = _fit_model()
    trainer = Trainer(max_epochs=2, log_every_n_steps=0, devices=1)
    trainer.fit(model)
    assert trainer.global_step == 2 * (16 // 4)
    assert [m["global_step"] for m in trainer.logged] == [8]


@pytest.mark.parametrize(
    "kwargs,match",
    [  # the ids of the cases before accumulation, post-hoc EMA and profile_dir were ported
        pytest.param(dict(strategy="fsdp"), "strategy", id="kwargs4-strategy"),
        pytest.param(dict(devices=2), "strategy", id="kwargs5-strategy"),
        pytest.param(dict(num_nodes=2), "strategy", id="kwargs6-strategy"),
        pytest.param(dict(resume_from_checkpoint="last.ckpt"), "resume", id="kwargs7-resume"),
        pytest.param(dict(enable_checkpointing=True), "checkpoints", id="kwargs9-checkpoints"),
    ],
)
def test_fit_refuses_options_it_does_not_port(kwargs, match):
    model = _fit_model()
    with pytest.raises(NotImplementedError, match=match):
        Trainer(max_steps=2, **kwargs).fit(model)


def test_fit_refuses_a_sample_dump_cadence_inside_max_steps(tmp_path):
    """The ``save_every`` cadence is ported: a cadence inside ``max_steps``
    dumps a 4-image grid (and logs bits/dim of the step's batch under
    ``compute_bpd``) once per crossing, instead of refusing the run."""
    from diffusion_model_nemo_tpu_torch.utils.image import decode_png

    model = _fit_model(save_every=4, compute_bpd=True, timesteps=5, results_dir=str(tmp_path))
    model.change_sampler(dict(model.cfg.sampler, timesteps=5))
    logged = []
    trainer = Trainer(max_steps=6, devices=1)
    trainer._log_metrics = lambda metrics, step: logged.append((step, dict(metrics)))
    trainer.fit(model)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["sample-1-1.png"]
    grid = decode_png((tmp_path / "sample-1-1.png").read_bytes())
    assert grid.shape == (2 + IMG + 2, 4 * (IMG + 2) + 2, 3)
    bpd = [m["total_bits_per_dimension"] for step, m in logged if "total_bits_per_dimension" in m]
    assert [step for step, m in logged if "total_bits_per_dimension" in m] == [4]
    assert len(bpd) == 1 and np.isfinite(bpd[0]) and bpd[0] > 0


@pytest.mark.parametrize("option", ["snr_gamma", "offset_noise_strength", "pred_v", "dropout"])
def test_training_step_takes_each_option(option):
    """Each training option of the JAX package runs (its parity with JAX:
    tests/test_torch_port_training_options.py): it changes the loss of the
    same batch and draws, and switched off (γ unset, s = 0, pred_noise, p =
    0) the step is the base step bit for bit, the extra draws ignored."""
    model = _fit_model()
    batch = {"image": np.random.default_rng(0).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)}
    shape = (2, IMG, IMG, 3)
    t = torch.tensor([10, 700], dtype=torch.int32)  # one SNR above γ = 5, one below
    base_draws = dict(model.draw_training_inputs(shape, torch.Generator().manual_seed(0)), t=t)
    base, _ = model.training_step(model.params, batch, base_draws)
    if option == "pred_v":
        model.sampler.objective = "pred_v"
    elif option == "dropout":
        model.cfg.diffusion_model["dropout"] = 0.1
        model.diffusion_model = model.build_network()
    else:
        model.cfg[option] = 0.1 if option == "offset_noise_strength" else 5.0
    draws = dict(model.draw_training_inputs(shape, torch.Generator().manual_seed(0)), t=t)
    extra = set(draws) - set(base_draws)
    if option == "offset_noise_strength":
        assert extra == {"offset"}
    elif option == "dropout":
        assert len(extra) == 9 and all(k.startswith("dropout/") for k in extra)  # 9 ResNet blocks' block2
    else:
        assert not extra
    on, _ = model.training_step(model.params, batch, draws)
    assert torch.isfinite(on) and abs(float(on) - float(base)) > 1e-6
    if option == "pred_v":
        model.sampler.objective = "pred_noise"
    elif option == "dropout":
        model.cfg.diffusion_model["dropout"] = 0.0
        model.diffusion_model = model.build_network()
    else:
        model.cfg[option] = 0.0
    off, _ = model.training_step(model.params, batch, draws)
    assert torch.equal(off, base)


def test_draws_have_the_step_shapes():
    model = _fit_model()
    d = model.draw_training_inputs((5, IMG, IMG, 3), torch.Generator().manual_seed(0))
    assert d["flip"].dtype == torch.bool and d["flip"].shape == (5,)
    assert d["t"].dtype == torch.int32 and 0 <= int(d["t"].min()) and int(d["t"].max()) < 1000
    assert d["noise"].shape == (5, IMG, IMG, 3) and d["noise"].dtype == torch.float32
