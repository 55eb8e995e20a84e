"""The port's mixture-of-experts DiT against the JAX package's, on the CPU.

``ExpertChoiceMoE`` alone at capacity factors 0.5, 1 and 2 (float32 and
bf16), and a small MoE DiT (dim 64, depth 2, 4 heads, 4 experts,
``moe_every`` 1 and 2) at 16×16×3: its forward, its DDPM training step
(loss and every gradient) and its dropout sites, from the same weights
(``utils/weights.py``, the stacked experts carried as they are) and the
same numpy inputs and draws. Every all-zero leaf of the JAX init (the
adaLN-Zero kernels, every bias) is redrawn from a seeded N(0, 0.02²) first,
or the comparisons would be vacuous.

Tolerances, each with its reason:
- float32: the selected token sets equal exactly (the router is a float32
  Dense and a softmax in both); outputs 2e-5 (two batched products and
  the combine's float32 sums, in the same expert order in both packages);
  the whole DiT 2e-4 (tests/test_torch_port_dit.py's float32 bar); the
  step's loss 1e-5 relative and each gradient leaf 1e-3 relative L2;
- bf16: relative L2 2e-2 (each package rounds the products, GELU, the
  gates and the combine to bf16 at slightly different points), the DiT
  bar of tests/test_torch_port_dit.py. ``torch.topk`` returns tied scores
  in no fixed order; the combine does not depend on it (only the order of
  an expert's own rows would move, and each row is added once).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.loss.simple_loss import DiffusionLoss as JLoss
from diffusion_model_nemo_tpu.modules.dit import DiT as JDiT
from diffusion_model_nemo_tpu.modules.dit import ExpertChoiceMoE as JMoE
from diffusion_model_nemo_tpu.modules.gaussian_diffusion import GaussianDiffusion as JGaussian
from diffusion_model_nemo_tpu_torch import DDPM, Trainer
from diffusion_model_nemo_tpu_torch.config import dit_small_model_config, load_config
from diffusion_model_nemo_tpu_torch.modules.dit import DiT, ExpertChoiceMoE
from diffusion_model_nemo_tpu_torch.training.trainer import param_grads
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params, to_flax_params

D, H, E = 64, 256, 4
IMG = 16
NET = dict(dim=64, depth=2, heads=4, patch_size=2, channels=3, moe_experts=4)
F32_TOL = 2e-5
DIT_F32_TOL = 2e-4
BF16_REL_L2 = 2e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturb_zero_leaves(params, seed=0, std=0.02):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jax.tree.map(np.asarray, params))
    out = [rng.normal(0.0, std, leaf.shape).astype(np.float32) if not np.any(leaf) else leaf for leaf in leaves]
    return jax.tree_util.tree_unflatten(treedef, out)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def moe_params():
    params = jax.jit(JMoE(D, H, E).init)(jax.random.PRNGKey(0), jnp.zeros((2, 16, D)))["params"]
    return _perturb_zero_leaves(params)


def _moe_pair(params, capacity, dtype):
    jmoe = JMoE(D, H, E, capacity_factor=capacity, dtype=jnp.dtype(dtype))
    tmoe = ExpertChoiceMoE(D, H, E, capacity, dtype=dtype)
    tmoe.load_state_dict(from_flax_params(params, tmoe))
    return jmoe, tmoe


def _jax_routing(params, x, capacity):
    """JAX's (gates, token indices) for tokens x [B, N, D], the router as
    the JAX layer computes it."""
    xt = jnp.asarray(x).reshape(-1, D).astype(jnp.float32)
    r = params["router"]
    scores = jax.nn.softmax(xt @ r["kernel"] + r["bias"], axis=-1)
    C = max(1, int(capacity * xt.shape[0] / E))
    return jax.lax.top_k(scores.T, C)


@pytest.mark.parametrize("capacity", [0.5, 1.0, 2.0])
def test_moe_float32_matches_jax_with_equal_token_sets(moe_params, capacity):
    x = np.random.default_rng(1).standard_normal((2, 16, D)).astype(np.float32)
    jmoe, tmoe = _moe_pair(moe_params, capacity, "float32")
    ref = np.asarray(jmoe.apply({"params": moe_params}, x))
    with torch.no_grad():
        ours = tmoe(torch.from_numpy(x)).numpy()
        gates, idx = tmoe.route(torch.from_numpy(x).reshape(-1, D))
    j_gates, j_idx = _jax_routing(moe_params, x, capacity)
    C = max(1, int(capacity * 32 / E))
    assert tuple(idx.shape) == (E, C)
    for e in range(E):
        assert sorted(idx[e].tolist()) == sorted(np.asarray(j_idx[e]).tolist()), f"expert {e}"
    np.testing.assert_allclose(np.sort(gates.numpy(), axis=1), np.sort(np.asarray(j_gates), axis=1),
                               rtol=F32_TOL, atol=1e-7)
    np.testing.assert_allclose(ours, ref, rtol=F32_TOL, atol=F32_TOL)
    unpicked = np.setdiff1d(np.arange(32), idx.numpy().ravel())
    assert np.all(ours.reshape(32, D)[unpicked] == 0)  # a token no expert took gives zero
    if capacity < 1.0:
        assert len(unpicked) > 0  # half the slots: some tokens are left out


@pytest.mark.parametrize("capacity", [0.5, 1.0, 2.0])
def test_moe_bf16_matches_jax(moe_params, capacity):
    x = np.random.default_rng(2).standard_normal((2, 16, D)).astype(np.float32)
    jmoe, tmoe = _moe_pair(moe_params, capacity, "bfloat16")
    ref = np.asarray(jmoe.apply({"params": moe_params}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        ours = tmoe(torch.from_numpy(x).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    assert _rel(ours.float().numpy(), ref) <= BF16_REL_L2


def test_moe_combine_is_deterministic_and_in_expert_order(moe_params):
    """Two runs on one input are bit-equal (bf16, capacity 2: every token
    taken by two experts on average), and equal to a combine written out
    row by row in expert order."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 16, D)).astype(np.float32)).to(torch.bfloat16)
    _j, tmoe = _moe_pair(moe_params, 2.0, "bfloat16")
    with torch.no_grad():
        a, b = tmoe(x), tmoe(x)
        xt = x.reshape(-1, D)
        gates, idx = tmoe.route(xt)
        dt = torch.bfloat16
        h = torch.nn.functional.gelu(torch.bmm(xt[idx], tmoe.experts_w1.to(dt)) + tmoe.experts_b1[:, None].to(dt),
                                     approximate="tanh")
        ye = torch.bmm(h, tmoe.experts_w2.to(dt)) + tmoe.experts_b2[:, None].to(dt)
        contrib = gates[..., None].to(dt) * ye
        ref = torch.zeros(32, D, dtype=dt)
        for e in range(E):
            for c in range(idx.shape[1]):
                ref[idx[e, c]] = ref[idx[e, c]] + contrib[e, c]
    assert torch.equal(a, b)
    assert torch.equal(a.reshape(32, D), ref)


def test_expert_choice_couples_the_rows_of_a_batch_in_both_packages(moe_params):
    """A row's output depends on its batch-mates (the experts rank every
    token of the batch), in the JAX layer and the port's alike; with the
    same batch-mates it repeats bit for bit."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    other = x.copy()
    other[1] = rng.standard_normal((16, D))
    jmoe, tmoe = _moe_pair(moe_params, 1.0, "float32")
    j = [np.asarray(jmoe.apply({"params": moe_params}, v))[0] for v in (x, other, x)]
    with torch.no_grad():
        t = [tmoe(torch.from_numpy(v))[0].numpy() for v in (x, other, x)]
    for outs in (j, t):
        assert np.abs(outs[0] - outs[1]).max() > 1e-3
        assert np.array_equal(outs[0], outs[2])


# ------------------------------------------------------------ the MoE DiT --
@pytest.fixture(scope="module", params=[1, 2], ids=["moe_every1", "moe_every2"])
def dit_pair(request):
    every = request.param
    jnet = JDiT(**NET, moe_every=every)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)))["params"]
    params = _perturb_zero_leaves(params)
    tnet = DiT(**NET, moe_every=every).eval()
    tnet.load_state_dict(from_flax_params(params, tnet))
    return every, jnet, params, tnet


def _inputs(seed=5, B=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32), rng.integers(0, 1000, (B,)).astype(np.int32)


def test_moe_dit_blocks_and_forward_match_jax(dit_pair):
    every, jnet, params, tnet = dit_pair
    moe_blocks = [i for i in range(2) if hasattr(getattr(tnet, f"block_{i}"), "moe")]
    assert moe_blocks == [i for i in range(2) if i % every == 0]
    assert set(params) >= {f"block_{i}" for i in range(2)}
    assert all("moe" in params[f"block_{i}"] for i in moe_blocks)
    x, t = _inputs()
    ref = np.asarray(jax.jit(lambda p, x, t: jnet.apply({"params": p}, x, t))(params, x, t))
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=DIT_F32_TOL, atol=DIT_F32_TOL)
    back = to_flax_params(tnet.state_dict(), tnet)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(back))[path], leaf)


def _dit_model(every, dtype="float32", dropout=0.0):
    cfg = dit_small_model_config()
    cfg["image_size"] = IMG
    cfg["diffusion_model"].update(NET, input_dim=IMG, moe_every=every, dtype=dtype, dropout=dropout)
    return DDPM(cfg, device="cpu", seed=0)


def test_moe_dit_training_step_matches_jax(dit_pair):
    """The DDPM step (q_sample → the MoE DiT → L2 against the noise) on
    the same weights and draws: the loss and every gradient leaf, the
    router's and the stacked experts' among them."""
    every, jnet, params, _t = dit_pair
    model = _dit_model(every)
    model.params = from_flax_params(params, model.diffusion_model)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (4, IMG, IMG, 3)).astype(np.uint8)
    flip = rng.random(4) < 0.5
    ts = rng.integers(0, 1000, 4).astype(np.int32)
    noise = rng.standard_normal((4, IMG, IMG, 3)).astype(np.float32)
    proc = JGaussian(**{k: v for k, v in model.cfg["sampler"].items() if k != "_target_"})
    jloss = JLoss("l2", "mean")

    def loss_fn(p):
        x = jnp.asarray(images).astype(jnp.float32) / 127.5 - 1.0
        x0 = jnp.where(jnp.asarray(flip)[:, None, None, None], x[:, :, ::-1, :], x)
        x_t = proc.q_sample(x_start=x0, t=jnp.asarray(ts), noise=jnp.asarray(noise))
        return jloss(jnet.apply({"params": p}, x_t, jnp.asarray(ts)), jnp.asarray(noise))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tparams = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    draws = {"flip": torch.from_numpy(flip), "t": torch.from_numpy(ts), "noise": torch.from_numpy(noise)}
    loss, _ = model.training_step(tparams, {"image": images}, draws)
    grads = param_grads(loss, tparams)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    ours = dict(jax.tree_util.tree_leaves_with_path(to_flax_params(grads, model.diffusion_model)))
    ref = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, j_grads))
    assert len(ours) == len(ref)
    for path, leaf in ref:
        if np.linalg.norm(leaf) > 0:
            assert _rel(ours[path], leaf) <= 1e-3, jax.tree_util.keystr(path)
    assert any("experts_w1" in jax.tree_util.keystr(p) and np.linalg.norm(v) > 0 for p, v in ref)


def test_moe_dit_dropout_sites_match_flax():
    """With dropout the MoE block keeps flax's site numbering (the
    self-attention's ``Dropout_0``, the MLP branch's ``Dropout_1``, after
    the MoE): the masks flax draws, fed to the port, give JAX's output."""
    import flax.linen as nn

    jnet = JDiT(**NET, moe_every=1, dropout=0.25)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)))["params"]
    params = _perturb_zero_leaves(params)
    seen = {}
    orig = nn.Dropout.__call__

    def recorder(self, inputs, deterministic=None, rng=None):
        out = orig(self, inputs, deterministic=deterministic, rng=rng)
        seen["/".join(self.scope.path)] = out != 0
        return out

    def run(p, x, t):  # traced once: the masks come out as outputs of the jitted call
        out = jnet.apply({"params": p}, x, t, deterministic=False, rngs={"dropout": jax.random.PRNGKey(3)})
        return out, dict(seen)

    x, t = _inputs(7)
    nn.Dropout.__call__ = recorder
    try:
        ref, masks = jax.jit(run)(params, x, t)
    finally:
        nn.Dropout.__call__ = orig
    ref, seen = np.asarray(ref), {k: np.array(v) for k, v in masks.items()}
    tnet = DiT(**NET, moe_every=1, dropout=0.25).eval()
    tnet.load_state_dict(from_flax_params(params, tnet))
    assert set(seen) == set(tnet.dropout_shapes(x.shape)) == {f"block_{i}/Dropout_{j}" for i in (0, 1)
                                                               for j in (0, 1)}
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x), torch.from_numpy(t),
                    dropout_masks={k: torch.from_numpy(v) for k, v in seen.items()}).numpy()
    np.testing.assert_allclose(ours, ref, rtol=DIT_F32_TOL, atol=DIT_F32_TOL)


def test_moe_dit_bf16_forward_matches_jax(dit_pair):
    every, _jnet, params, _t = dit_pair
    jnet = JDiT(**NET, moe_every=every, dtype="bfloat16")
    tnet = DiT(**NET, moe_every=every, dtype="bfloat16").eval()
    tnet.load_state_dict(from_flax_params(params, tnet))
    x, t = _inputs(8)
    ref = np.asarray(jax.jit(lambda p, x, t: jnet.apply({"params": p}, x, t))(params, x, t))
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert _rel(ours, ref) <= BF16_REL_L2


# ------------------------------------------------------ config, archive, CLI --
def test_dit_small_yaml_moe_keys_build_and_archive_round_trips(tmp_path):
    """``dit/dit_small.yaml`` with ``moe_experts=8`` (through the config
    reader and the registry, narrowed for the CPU) builds the MoE DiT; its
    archive restores with the same weights and forward, and its flax tree
    has the JAX MoE DiT's structure and shapes."""
    cfg = load_config(os.path.join(REPO, "examples/configs/dit/dit_small.yaml"),
                      overrides=[f"model.image_size={IMG}", "model.diffusion_model.moe_experts=8",
                                 "model.diffusion_model.dim=32", "model.diffusion_model.depth=3",
                                 "model.diffusion_model.heads=2"]).model
    model = DDPM(cfg, device="cpu", seed=0)
    net = model.diffusion_model
    assert [hasattr(getattr(net, f"block_{i}"), "moe") for i in range(3)] == [True, False, True]
    assert tuple(net.block_0.moe.experts_w1.shape) == (8, 32, 128)
    path = model.save_to(str(tmp_path / "moe.dmn"))
    back = DDPM.restore_from(path, device="cpu")
    assert all(torch.equal(back.params[k], v) for k, v in model.params.items())
    x, t = _inputs(9)
    assert torch.equal(back.forward(torch.from_numpy(x), torch.from_numpy(t)),
                       model.forward(torch.from_numpy(x), torch.from_numpy(t)))
    jnet = JDiT(dim=32, depth=3, heads=2, patch_size=2, channels=3, moe_experts=8, moe_every=2)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)))
    ours = to_flax_params(model.params, net)
    assert jax.tree.structure(shapes["params"]) == jax.tree.structure(ours)
    assert jax.tree.map(lambda s: tuple(s.shape), shapes["params"]) == jax.tree.map(np.shape, ours)


def test_expert_parallel_strategy_is_refused():
    model = _dit_model(2)
    model.cfg["train_ds"]["name"] = "synthetic"
    with pytest.raises(NotImplementedError, match="strategy='expert_parallel'.*parallelism"):
        Trainer(max_steps=1, strategy="expert_parallel", accelerator="cpu").fit(model)


def test_train_dit_cli_runs_the_moe_example_on_the_cpu(tmp_path):
    """``cli/train_dit.py`` with ``moe_experts=8`` (the script docstring's
    example, narrowed): two steps, finite losses, the archive written."""
    from diffusion_model_nemo_tpu_torch.cli import train_dit

    model, trainer = train_dit.main([
        f"model.image_size={IMG}", "model.diffusion_model.moe_experts=8", "model.diffusion_model.dim=32",
        "model.diffusion_model.depth=2", "model.diffusion_model.heads=2", "model.diffusion_model.dtype=float32",
        "model.train_ds.name=synthetic", "model.train_ds.batch_size=2", "+model.train_ds.length=4",
        "model.save_every=0", "trainer.max_steps=2", "trainer.accelerator=cpu",
        "trainer.log_every_n_steps=1", f"exp_manager.exp_dir={tmp_path}", "exp_manager.create_tensorboard_logger=false",
        "exp_manager.create_checkpoint_callback=false",
    ])
    assert hasattr(model.diffusion_model.block_0, "moe")
    assert trainer.logged and all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    assert list(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
