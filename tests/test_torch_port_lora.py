"""The port's LoRA fine-tuning against the JAX package's, on the CPU.

``_walk_kernels`` (the adapted kernels, by flax path and shape) on the full
unet_small and on a MoE DiT-S/2; ``lora_init``'s ranks and refusals;
``merge_adapters`` on a small U-Net (dim 8, [1, 2], 4 groups), whose
kernels cover every leaf kind the merge re-lays (conv, ``Conv1x1``, Dense,
the transposed conv); ``LoRAFinetuner`` for one and then two more updates
(adamw and sgd, the global-norm clip engaged) against the JAX package's
``LoRAFinetuner`` from the same base weights, the same adapters and the
same batches and draws (the JAX model's step reads its draws from the
batch: its key streams differ from the port's generators); the adapter
files each package writes, read by the other; the merged model's archive;
the kernel entry points' gradients through a non-leaf (merged) weight;
``cli/finetune_lora.py`` on a tiny archive.

Tolerances, each with its reason:
- the merge: 1e-6 (one float32 product of rank r and one add per element);
- fine-tuning, float32: losses rtol 1e-5; each adapter leaf 1e-4 relative
  L2, and every entry within 1e-4 (1% of one step of lr = 1e-2): Adam's
  first steps move an entry by lr·g/(|g| + eps), so an entry whose gradient
  is within a few eps of zero moves by a fraction that float noise in g
  decides (a few entries land 1e-5 apart after one step);
- the non-leaf weights: 1e-6 (the recompute is the plain composition).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.loss.simple_loss import DiffusionLoss as JLoss
from diffusion_model_nemo_tpu.modules.dit import DiT as JDiT
from diffusion_model_nemo_tpu.modules.gaussian_diffusion import GaussianDiffusion as JGaussian
from diffusion_model_nemo_tpu.modules.unet import Unet as JUnet
from diffusion_model_nemo_tpu.training import lora as jlora
from diffusion_model_nemo_tpu_torch import DDPM
from diffusion_model_nemo_tpu_torch.config import dit_small_model_config, unet_small_model_config
from diffusion_model_nemo_tpu_torch.config.registry import get_target
from diffusion_model_nemo_tpu_torch.data import SyntheticVisionDataset
from diffusion_model_nemo_tpu_torch.ops import attention as TA
from diffusion_model_nemo_tpu_torch.ops import norm as TN
from diffusion_model_nemo_tpu_torch.training import lora
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

IMG, BATCH = 8, 4
NET = dict(dim=8, dim_mults=[1, 2], resnet_block_groups=4)
MERGE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _net_cfg(cfg):
    net = {k: v for k, v in cfg["diffusion_model"].items() if k != "_target_"}
    if "dim_mults" in net:
        net["dim_mults"] = tuple(net["dim_mults"])
    return net


def _jax_paths(jnet, size):
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jnp.zeros((1,)))
    return [(p, tuple(v.shape)) for p, v in jlora._walk_kernels(shapes["params"])]


@pytest.mark.parametrize("family", ["unet_small", "moe_dit_s2"])
def test_walk_kernels_visits_jax_paths_in_jax_order(family):
    if family == "unet_small":
        cfg = unet_small_model_config()
        jnet = JUnet(**_net_cfg(cfg))
    else:
        cfg = dit_small_model_config()
        cfg["diffusion_model"]["moe_experts"] = 8
        jnet = JDiT(**_net_cfg(cfg))
    net = get_target(cfg["diffusion_model"]["_target_"])(**_net_cfg(cfg))  # shapes only: no init drawn
    ours = [(p, s) for p, _k, s in lora._walk_kernels(net.state_dict(), net)]
    assert ours == _jax_paths(jnet, int(cfg["image_size"]))
    if family == "moe_dit_s2":
        assert "block_0/moe/router/kernel" in dict(ours)
        assert not any("experts" in p for p, _s in ours)  # the stacked experts are no kernel


@pytest.fixture(scope="module")
def small():
    """(port DDPM float32, its flax params, the JAX U-Net)."""
    cfg = unet_small_model_config(image_size=IMG)
    cfg["diffusion_model"].update(NET, input_dim=IMG, dtype="float32")
    model = DDPM(cfg, device="cpu", seed=0)
    jnet = JUnet(**_net_cfg(cfg))
    params = jax.tree.map(np.asarray, jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                                                         jnp.zeros((1,)))["params"])
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.02, a.shape).astype(np.float32) if not a.any() else a, params)
    model.params = from_flax_params(params, model.diffusion_model)
    model.ema_params = {k: v.clone() for k, v in model.params.items()}
    return model, params, jnet


def test_lora_init_ranks_and_refusals(small):
    model, _p, _j = small
    net = model.diffusion_model
    adapters = lora.lora_init(model.params, net, 8, torch.Generator().manual_seed(0))
    walk = lora._walk_kernels(model.params, net)
    assert list(adapters) == [p for p, _k, _s in walk]
    for path, _key, shape in walk:
        fan_in, cout = int(np.prod(shape[:-1])), shape[-1]
        a, b = adapters[path]["a"], adapters[path]["b"]
        r = min(8, fan_in, cout)
        assert tuple(a.shape) == (fan_in, r) and tuple(b.shape) == (r, cout) and not b.any()
    assert any(min(8, int(np.prod(s[:-1])), s[-1]) < 8 for _p, _k, s in walk)  # a clipped rank (the 3-wide head)
    a_all = torch.cat([adapters[p]["a"].flatten() * np.sqrt(adapters[p]["a"].shape[0]) for p in adapters])
    assert abs(float(a_all.std()) - 1.0) < 0.05
    only = lora.lora_init(model.params, net, 2, targets="mid_attn")
    assert only and all("mid_attn" in p for p in only)
    with pytest.raises(ValueError, match="rank must be >= 1"):
        lora.lora_init(model.params, net, 0)
    with pytest.raises(ValueError, match="no kernels match"):
        lora.lora_init(model.params, net, 4, targets="nothing_here")
    assert lora.adapter_param_count(adapters) == sum(int(v.numel()) for ab in adapters.values() for v in ab.values())


def _random_adapters(model, rank, seed):
    """Adapters with A and B both drawn (B = 0 would hide the merge)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, _k, shape in lora._walk_kernels(model.params, model.diffusion_model):
        fan_in, cout = int(np.prod(shape[:-1])), shape[-1]
        r = min(rank, fan_in, cout)
        out[path] = {"a": rng.normal(0, 0.3, (fan_in, r)).astype(np.float32),
                     "b": rng.normal(0, 0.3, (r, cout)).astype(np.float32)}
    return out


def test_merge_adapters_matches_jax_on_every_leaf_kind(small):
    model, params, _j = small
    net = model.diffusion_model
    adapters = _random_adapters(model, 4, 1)
    kinds = {type(net.get_submodule(p.rsplit("/", 1)[0].replace("/", "."))).__name__ for p in adapters}
    assert kinds == {"Conv2d", "Conv1x1", "Dense", "ConvTranspose2d"}
    ref = jax.tree.map(np.asarray, jlora.merge_adapters(params, jax.tree.map(jnp.asarray, adapters), 0.5))
    ours = lora.merge_adapters(model.params, {p: {k: torch.from_numpy(v) for k, v in ab.items()}
                                              for p, ab in adapters.items()}, 0.5, net)
    flat_ours = dict(jax.tree_util.tree_leaves_with_path(to_flax_params(ours, net)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        np.testing.assert_allclose(flat_ours[path], leaf, rtol=MERGE_TOL, atol=MERGE_TOL, err_msg=str(path))
    assert all(ours[k] is model.params[k] for k in model.params if k.endswith("bias"))


class _JModel:
    """The JAX side of the fine-tune: the frozen base and a DDPM step that
    reads the step's draws from the batch (flip, t, noise)."""

    def __init__(self, jnet, params, sampler_cfg):
        self.params = params
        self.jnet = jnet
        self.proc = JGaussian(**{k: v for k, v in sampler_cfg.items() if k != "_target_"})
        self.loss = JLoss("l2", "mean")

    def training_step(self, params, batch, key, step):
        x = batch["image"].astype(jnp.float32) / 127.5 - 1.0
        x0 = jnp.where(batch["flip"][:, None, None, None], x[:, :, ::-1, :], x)
        x_t = self.proc.q_sample(x_start=x0, t=batch["t"], noise=batch["noise"])
        return self.loss(self.jnet.apply({"params": params}, x_t, batch["t"]), batch["noise"]), {}


def _batches(n, seed=2):
    ds = SyntheticVisionDataset(image_size=IMG, channels=3, length=64, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({"image": np.stack([ds[i * BATCH + j]["image"] for j in range(BATCH)]),
                    "flip": rng.random(BATCH) < 0.5, "t": rng.integers(0, 1000, BATCH).astype(np.int32),
                    "noise": rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)})
    return out


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_finetune_matches_jax_lora_finetuner(small, optimizer):
    """One update, then two more (each ``finetune`` call starts a fresh
    optimizer state in both packages), clip at 0.05 (the raw gradient's
    norm is larger: the clip acts), weight decay under adamw."""
    model, params, jnet = small
    kw = dict(rank=4, alpha=8.0, learning_rate=1e-2, grad_clip=0.05, optimizer=optimizer,
              weight_decay=0.01 if optimizer == "adamw" else 0.0)
    start = _random_adapters(model, 4, 3)
    for ab in start.values():
        ab["b"] *= 0.1
    base = {k: v.clone() for k, v in model.params.items()}
    tuner = lora.LoRAFinetuner(model, **kw)
    tuner.adapters = {p: {k: torch.from_numpy(v) for k, v in ab.items()} for p, ab in start.items()}
    jmodel = _JModel(jnet, jax.tree.map(jnp.asarray, params), model.cfg["sampler"])
    jtuner = jlora.LoRAFinetuner(jmodel, key=jax.random.PRNGKey(0), **kw)
    jtuner.adapters = jax.tree.map(jnp.asarray, start)
    batches = _batches(3)
    draws = [{"flip": torch.from_numpy(b["flip"]), "t": torch.from_numpy(b["t"]),
              "noise": torch.from_numpy(b["noise"])} for b in batches]
    leaves = {p: {w: t.clone().requires_grad_(True) for w, t in ab.items()} for p, ab in tuner.adapters.items()}
    flat = {f"{p}::{w}": t for p, ab in leaves.items() for w, t in ab.items()}
    loss0, _ = model.training_step(lora.merge_adapters(model.params, leaves, tuner.scale, model.diffusion_model),
                                   batches[0], draws[0])
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in torch.autograd.grad(loss0, list(flat.values()))]))
    assert float(norm) > 0.05
    # One compile at XLA's backend optimization level 0 (the step's shapes do not change).
    j0 = jax.tree.map(jnp.asarray, batches[0])
    jtuner._step = jtuner._step.lower(jtuner.adapters, jtuner._tx.init(jtuner.adapters), jmodel.params, j0,
                                      jax.random.PRNGKey(0), jnp.int32(0)).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    for chunk in ((0, 1), (1, 3)):
        ours = tuner.finetune(iter(batches[chunk[0]:chunk[1]]), chunk[1] - chunk[0], draws=iter(draws[chunk[0]:]),
                              log_every=1)
        ref = jtuner.finetune(iter(jax.tree.map(jnp.asarray, batches[chunk[0]:chunk[1]])), chunk[1] - chunk[0],
                              jax.random.PRNGKey(1), log_every=1)
        np.testing.assert_allclose(ours, ref, rtol=1e-5)
        for path, ab in jtuner.adapters.items():
            for w in ("a", "b"):
                ours_w, ref_w = tuner.adapters[path][w].detach().numpy(), np.asarray(ab[w])
                np.testing.assert_allclose(ours_w, ref_w, rtol=0, atol=1e-4, err_msg=f"{path}::{w} after {chunk[1]}")
                assert np.linalg.norm(ours_w - ref_w) <= 1e-4 * np.linalg.norm(ref_w), f"{path}::{w}"
    assert any(float((tuner.adapters[p]["b"].detach() - torch.from_numpy(start[p]["b"])).abs().max()) > 1e-4
               for p in start)
    assert all(torch.equal(base[k], v) and not v.requires_grad and v.grad is None for k, v in model.params.items())


def test_adapter_files_move_between_the_packages(small, tmp_path):
    model, _p, _j = small
    adapters = {p: {k: torch.from_numpy(v) for k, v in ab.items()} for p, ab in _random_adapters(model, 2, 4).items()}
    ours_path = lora.save_adapters(str(tmp_path / "ours.npz"), adapters, 2, 3.0, "down|up")
    j_ad, j_rank, j_alpha, j_targets = jlora.load_adapters(ours_path)
    assert (j_rank, j_alpha, j_targets) == (2, 3.0, "down|up") and set(j_ad) == set(adapters)
    for p, ab in adapters.items():
        for w in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(j_ad[p][w]), ab[w].numpy())
    theirs = jlora.save_adapters(str(tmp_path / "theirs.npz"), jax.tree.map(jnp.asarray, j_ad), 2, 3.0, "down|up")
    back, rank, alpha, targets = lora.load_adapters(theirs)
    assert (rank, alpha, targets) == (2, 3.0, "down|up")
    assert all(torch.equal(back[p][w], adapters[p][w]) for p in adapters for w in ("a", "b"))


def test_merged_model_bakes_the_update_into_weights_and_ema_and_restores(small, tmp_path):
    model, _p, _j = small
    adapters = {p: {k: torch.from_numpy(v) for k, v in ab.items()} for p, ab in _random_adapters(model, 2, 5).items()}
    tuner = lora.LoRAFinetuner(model, rank=2)
    tuner.adapters = adapters
    merged = tuner.merged_model()
    assert type(merged) is type(model)
    expect = tuner.merged_params()
    assert all(torch.equal(merged.params[k], v) and torch.equal(merged.ema_params[k], v) for k, v in expect.items())
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, IMG, IMG, 3)).astype(np.float32))
    t = torch.tensor([3, 700])
    back = DDPM.restore_from(merged.save_to(str(tmp_path / "merged.dmn")), device="cpu")
    a = back.forward(x, t)
    b = model.model_fn(lora.merge_adapters(model.params, tuner.adapters, tuner.scale, model.diffusion_model), x, t)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - model.forward(x, t)).abs().max()) > 1e-3


def _nonleaf_cases():
    """(plain version, tensor inputs, constants) for the kernel entry points
    of the U-Net and the DiT, each weight W + A·B (a non-leaf)."""
    g = torch.Generator().manual_seed(11)

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale

    def merged(*s, scale=1.0):
        a = r(s[0], 2, scale=0.1).requires_grad_(True)
        b = r(2, int(np.prod(s[1:])), scale=0.1).requires_grad_(True)
        return r(*s, scale=scale) + (a @ b).reshape(s), (a, b)

    C, hd = 32, 128
    w_qkv, ab1 = merged(C, 3 * hd, scale=C ** -0.5)
    w_out, ab2 = merged(hd, C, scale=hd ** -0.5)
    gamma, ab3 = merged(1, C)
    lin = [r(2, 64, C, scale=0.5), 1 + r(C, scale=0.1), r(C, scale=0.1), w_qkv, w_out, r(C, scale=0.1),
           1 + r(C, scale=0.1), r(C, scale=0.1)]
    w_tok, ab4 = merged(C, 384)
    return {
        "group_norm_silu": (TN.group_norm_silu_reference, [r(2, 4, 4, C), 1 + gamma[0], r(C)], (4, 1e-5), ab3),
        "linear_attention_block": (TA.linear_attention_block_reference, lin, (4, 32, 32 ** -0.5, 1e-5), ab1 + ab2),
        "attention_block_small": (TA.attention_block_reference, lin[:6], (4, 32, 32 ** -0.5, 1e-5), ab1 + ab2),
        "linear_attention_tokens": (TA.linear_attention_tokens_reference, [r(2, 64, C), w_tok], (4, 32, 32 ** -0.5),
                                    ab4),
    }


@pytest.mark.parametrize("name", sorted(_nonleaf_cases()))
def test_kernel_calls_pass_gradients_to_non_leaf_weights(name):
    """A merged weight is no leaf: each kernel entry point's
    differentiable call (the plain forward a CPU tensor runs) gives A and B
    the gradients autograd gives through the plain version directly."""
    from diffusion_model_nemo_tpu_torch.ops.recompute import kernel_call

    plain, tensors, consts, leaves = _nonleaf_cases()[name]

    def fail(*_a):
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    out = kernel_call(fail, plain, *tensors, *consts)
    ref = plain(*tensors, *consts)
    cot = torch.randn(ref.shape, generator=torch.Generator().manual_seed(12))
    ours = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    theirs = torch.autograd.grad(ref, leaves, cot)
    for a, b in zip(ours, theirs):
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_finetune_lora_cli_on_a_tiny_archive(small, tmp_path):
    """``cli/finetune_lora.py``: two steps at batch 2 on the model's
    synthetic ``train_ds``, the adapters and the merged archive written;
    the merged archive restores as its family; ``devices=2`` raises."""
    from diffusion_model_nemo_tpu_torch.cli import finetune_lora
    from diffusion_model_nemo_tpu_torch.models import restore_model_from_archive

    model, _p, _j = small
    model.cfg["train_ds"]["name"] = "synthetic"
    src = model.save_to(str(tmp_path / "base.dmn"))
    out, ad = str(tmp_path / "lora.dmn"), str(tmp_path / "adapters.npz")
    tuner, losses, merged = finetune_lora.main([f"model_path={src}", f"output_path={out}", f"adapters_path={ad}",
                                                "rank=2", "steps=2", "batch_size=2", "dataset_length=8",
                                                "log_every=1", "learning_rate=1e-2", "device=cpu"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert os.path.isfile(out) and os.path.isfile(ad)
    back = restore_model_from_archive(out, device="cpu")
    assert type(back).__name__ == "DDPM"
    assert all(torch.equal(back.params[k], v) for k, v in merged.params.items())
    assert set(lora.load_adapters(ad)[0]) == set(tuner.adapters)
    with pytest.raises(NotImplementedError, match="devices=2"):
        finetune_lora.main([f"model_path={src}", "devices=2", "device=cpu"])
