"""The port's sampling services on the CPU: trajectories, interpolation,
SDEdit and RePaint, against the JAX package on the same weights with the
same draws, and against their own eager loops.

- ``return_frames`` on the ancestral and the DDIM chain; ``interpolate``
  (ancestral for DDPM, ImprovedDDPM's learned variance and ConditionalDDPM
  with a label; DDIM's from a latent): within the chains' 1e-3
  (tests/test_torch_port_graphs.py). The JAX side runs its own
  ``p_mean_variance`` / ``q_sample`` step by step on the port's draws (the
  two packages' random streams differ), or its scan where nothing is drawn.
- ``DDPM.edit`` at strengths 0, 0.5 and 1, on an ancestral and a
  DDIM-configured model (which still runs the ancestral partial chain).
- ``repaint_schedule`` equals JAX's; ``inpaint`` against the JAX scan with
  the JAX scan's own draws injected, 1e-3; the known region exact.
- Every new loop's ``graphs=True`` (the captured steps run eagerly on the
  CPU) equals its eager loop bit for bit, generator state included.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import ConditionalDDPM as JConditionalDDPM
from diffusion_model_nemo_tpu.models import DDPM as JDDPM
from diffusion_model_nemo_tpu.models import ImprovedDDPM as JImprovedDDPM
from diffusion_model_nemo_tpu.modules.generalized_gaussian_diffusion import (
    GeneralizedGaussianDiffusion as JGeneralized,
)
from diffusion_model_nemo_tpu.modules.repaint import repaint_loop as j_repaint_loop
from diffusion_model_nemo_tpu.modules.repaint import repaint_schedule as j_repaint_schedule
from diffusion_model_nemo_tpu_torch import ConditionalDDPM, DDPM, ImprovedDDPM
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.modules import repaint_schedule
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAMLS = {"ddpm": REPO / "examples/configs/ddpm/unet_small.yaml",
         "improved": REPO / "examples/configs/improved_ddpm/unet_small.yaml",
         "conditional": REPO / "examples/configs/ddpm/unet_small.yaml"}
CLASSES = {"ddpm": (DDPM, JDDPM), "improved": (ImprovedDDPM, JImprovedDDPM),
           "conditional": (ConditionalDDPM, JConditionalDDPM)}
T, IMG, B = 10, 8, 3
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=16",
]
EXTRA = {"conditional": ["model.num_classes=4"]}
CHAIN_TOL = 1e-3
DDIM = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
SHAPE = (B, IMG, IMG, 3)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is as fast
    alone, and does not oversubscribe the cores that the suite's other
    workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _pair(family):
    """The port's model (seed 0) and the JAX model with its weights."""
    cls, jcls = CLASSES[family]
    overrides = [*TINY, *EXTRA.get(family, [])]
    model = cls(load_config(YAMLS[family], overrides=overrides).model, device="cpu", seed=0)
    jmodel = jcls(cfg=j_load_config(YAMLS[family], overrides=overrides).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    model.base_sampler = dict(model.cfg.sampler)
    return model, jmodel


@pytest.fixture(scope="module")
def ddpm():
    return _pair("ddpm")


@pytest.fixture(scope="module")
def jax_steps(ddpm):
    """The ddpm pair's JAX steps, one jit a sampler for the module: the
    ancestral one and DDIM's (the sampler a DDIM-configured edit uses)."""
    _, jmodel = ddpm
    ddim = JGeneralized(timesteps=T, schedule_name="cosine", eta=0.0, ddim_timesteps=5)
    return {"ancestral": JaxSteps(jmodel.sampler, jmodel.model_fn, jmodel.params),
            "ddim": JaxSteps(ddim, jmodel.model_fn, jmodel.params)}


def _use_ddim(model, steps=5):
    cfg = {k: v for k, v in model.base_sampler.items() if k not in ("eta", "ddim_timesteps")}
    model.change_sampler(dict(cfg, _target_=DDIM, eta=0.0, ddim_timesteps=steps))


def _images(seed, lo=-1.0, hi=1.0, shape=SHAPE):
    return torch.from_numpy(np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32))


class JaxSteps:
    """The JAX process's ancestral steps on given draws, one jitted
    ``p_mean_variance`` (``sampler`` the JAX one: its own
    ``p_mean_variance`` dispatch, DDIM's on a DDIM sampler)."""

    def __init__(self, sampler, model_fn, params):
        self.sampler, self.params = sampler, params
        self.pmv = jax.jit(lambda p, x, t: tuple(sampler.p_mean_variance(model_fn, p, x, t))[::2])

    def chain(self, x, ts, draw, frames=None):
        """x through ancestral steps at ``ts``; ``draw()`` gives each t > 0's
        noise (a torch tensor)."""
        x = jnp.asarray(np.asarray(x))
        for t in ts:
            mean, log_var = self.pmv(self.params, x, jnp.int32(t))
            x = mean + (jnp.exp(0.5 * log_var) * jnp.asarray(draw().numpy()) if t > 0 else 0.0)
            if frames is not None:
                frames.append(np.asarray((x + 1.0) * 0.5))
        return x


# --------------------------------------------------------- trajectories --
def test_ancestral_frames_match_jax(ddpm, jax_steps):
    """``DDPM.sample(return_frames=True)`` on the ancestral chain through the
    replays: [T, B, H, W, C] frames in [0, 1], the last the output, each
    against the JAX steps fed the same draws."""
    model, jmodel = ddpm
    model.change_sampler(model.base_sampler)
    out, frames = model.sample(B, IMG, generator=_gen(), graphs=True, return_frames=True)
    assert frames.shape == (T, *SHAPE) and torch.equal(frames[-1], out)
    gen = _gen()
    ref_frames = []
    x_T = torch.randn(SHAPE, generator=gen)
    jax_steps["ancestral"].chain(x_T, range(T - 1, -1, -1), lambda: torch.randn(SHAPE, generator=gen), ref_frames)
    np.testing.assert_allclose(frames.numpy(), np.stack(ref_frames), atol=CHAIN_TOL, rtol=CHAIN_TOL)


def test_ddim_frames_match_jax(ddpm):
    """The DDIM chain's frames [M, B, H, W, C] against the JAX scan's
    ``return_frames`` from the same x_T."""
    model, jmodel = ddpm
    _use_ddim(model)
    out, frames = model.sample(B, IMG, generator=_gen(), graphs=True, return_frames=True)
    x_T = torch.randn(SHAPE, generator=_gen())
    ref, ref_frames = JGeneralized(timesteps=T, schedule_name="cosine", eta=0.0, ddim_timesteps=5).p_sample_loop(
        jmodel.model_fn, jmodel.params, SHAPE, jax.random.PRNGKey(0), img=jnp.asarray(x_T.numpy()),
        return_frames=True)
    assert frames.shape == (5, *SHAPE) and torch.equal(frames[-1], out)
    np.testing.assert_allclose(frames.numpy(), np.asarray(ref_frames), atol=CHAIN_TOL, rtol=CHAIN_TOL)


@pytest.mark.parametrize("sampler", ["ancestral", "ddim"])
def test_frames_replays_equal_the_eager_loop(ddpm, sampler):
    model, _ = ddpm
    model.change_sampler(model.base_sampler) if sampler == "ancestral" else _use_ddim(model)
    outs = []
    for g in (True, False):
        gen = _gen()
        outs.append((*model.sample(B, IMG, generator=gen, graphs=g, return_frames=True), gen.get_state()))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# --------------------------------------------------------- interpolation --
@pytest.mark.parametrize("family", ["ddpm", "improved", "conditional"])
def test_ancestral_interpolation_matches_jax(family):
    """``interpolate``: both endpoints noised to t with the generator's first
    two draws, lerped, then the chain's last t steps (t − 1 … 0): against
    the JAX process fed the same draws (the learned variance for
    ImprovedDDPM, the label bound for ConditionalDDPM)."""
    model, jmodel = _pair(family)
    x1, x2, t, lambd = _images(1), _images(2), 6, 0.3
    kw = {"label": 2} if family == "conditional" else {}
    out = model.interpolate(x1, x2, t=t, lambd=lambd, generator=_gen(), graphs=True, **kw)
    gen = _gen()
    t_b = jnp.full((B,), t, jnp.int32)
    js = jmodel.sampler
    xt1 = js.q_sample(jnp.asarray(x1.numpy()), t_b, jnp.asarray(torch.randn(SHAPE, generator=gen).numpy()))
    xt2 = js.q_sample(jnp.asarray(x2.numpy()), t_b, jnp.asarray(torch.randn(SHAPE, generator=gen).numpy()))
    fn = jmodel.model_fn
    if family == "conditional":
        labels = jnp.full((B,), 2, jnp.int32)
        fn = lambda p, x, tt: jmodel.model_fn(p, x, tt, classes=labels)  # noqa: E731
    x = JaxSteps(js, fn, jmodel.params).chain((1.0 - lambd) * xt1 + lambd * xt2, range(t - 1, -1, -1),
                                              lambda: torch.randn(SHAPE, generator=gen))
    np.testing.assert_allclose(out.numpy(), np.asarray((x + 1.0) * 0.5), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    ours = [model.interpolate(x1, x2, t=t, lambd=lambd, generator=g, graphs=flag, **kw)
            for g, flag in ((_gen(), True), (_gen(), False))]
    assert torch.equal(ours[0], ours[1]) and torch.equal(ours[0], out)


def test_ddim_interpolation_matches_jax(ddpm):
    """DDIM's ``interpolate`` runs the strided chain from the latent x1 (no
    draw at η = 0): against the JAX ``interpolate``, and the replays equal
    the eager loop."""
    model, jmodel = ddpm
    _use_ddim(model)
    z = torch.randn(SHAPE, generator=_gen())
    ours = [model.interpolate(z, z, graphs=g) for g in (True, False)]
    ref = JGeneralized(timesteps=T, schedule_name="cosine", eta=0.0, ddim_timesteps=5).interpolate(
        jmodel.model_fn, jmodel.params, jnp.asarray(z.numpy()))
    assert torch.equal(ours[0], ours[1])
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)


def test_interpolation_refuses_a_t_past_the_schedule(ddpm):
    model, _ = ddpm
    model.change_sampler(model.base_sampler)
    with pytest.raises(ValueError, match="must be <"):
        model.interpolate(_images(1), _images(2), t=T)


# ---------------------------------------------------------------- SDEdit --
@pytest.mark.parametrize("strength", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("configured", ["ancestral", "ddim"])
def test_edit_matches_jax(ddpm, jax_steps, strength, configured):
    """SDEdit: q_sample to t0 = round(s·(T − 1)) with the generator's first
    draw, then the ancestral partial chain (the base class's even on a
    DDIM-configured sampler, with that sampler's ``p_mean_variance``, as in
    JAX), against the JAX steps on the same draws; the replays equal the
    eager loop, generator state included."""
    model, _ = ddpm
    _use_ddim(model) if configured == "ddim" else model.change_sampler(model.base_sampler)
    steps = jax_steps[configured]
    js = steps.sampler
    src = _images(4, 0.0, 1.0)
    outs = []
    for g in (True, False):
        gen = _gen()
        outs.append((model.edit(src, strength, generator=gen, graphs=g), gen.get_state()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    t0 = int(round(strength * (T - 1)))
    gen = _gen()
    x = js.q_sample(jnp.asarray(src.numpy()) * 2.0 - 1.0, jnp.full((B,), t0, jnp.int32),
                    jnp.asarray(torch.randn(SHAPE, generator=gen).numpy()))
    x = steps.chain(x, range(t0 - 1, -1, -1), lambda: torch.randn(SHAPE, generator=gen))
    np.testing.assert_allclose(outs[0][0].numpy(), np.asarray((x + 1.0) * 0.5), atol=CHAIN_TOL, rtol=CHAIN_TOL)


def test_partial_chains_of_any_length_replay_one_graph(ddpm):
    """The ancestral graph's key holds no chain length: SDEdit at every
    strength and interpolation at any t replay the one graph (a graph, and
    on the card a memory pool, per strength would grow without a bound on
    a server that sees many strengths), each chain equal to its eager loop."""
    model, _ = ddpm
    model.change_sampler(model.base_sampler)
    src = _images(4, 0.0, 1.0)
    for strength in (0.3, 0.6, 1.0):
        a, b = (model.edit(src, strength, generator=_gen(), graphs=g) for g in (True, False))
        assert torch.equal(a, b)
    a, b = (model.interpolate(_images(1), _images(2), t=4, generator=_gen(), graphs=g) for g in (True, False))
    assert torch.equal(a, b)
    assert [g.info["name"] for g in model.sampler.graphs.values()] == ["ancestral"]


def test_edit_refuses_a_strength_outside_0_1(ddpm):
    model, _ = ddpm
    with pytest.raises(ValueError, match="strength"):
        model.edit(_images(4, 0.0, 1.0), 1.5)


# --------------------------------------------------------------- RePaint --
@pytest.mark.parametrize("timesteps,jump_length,jump_n_sample",
                         [(1000, 10, 10), (10, 2, 3), (10, 3, 2), (10, 10, 10), (10, 0, 5), (10, 4, 1)])
def test_repaint_schedule_equals_jax(timesteps, jump_length, jump_n_sample):
    ours, ref = repaint_schedule(timesteps, jump_length, jump_n_sample), j_repaint_schedule(
        timesteps, jump_length, jump_n_sample)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(ours, ref))
    if (timesteps, jump_length, jump_n_sample) == (1000, 10, 10):
        assert int(ours[1].sum()) == 9910


def _jax_repaint_draws(key, t_op, is_rev, shape):
    """The JAX RePaint scan's draws: x_T from the first split, then each
    entry's three-way split: the step's noise, then (reverse) the known
    region's, flat [B, H·W·C] normals."""
    flat = (shape[0], int(np.prod(shape[1:])))
    key, init_key = jax.random.split(key)
    img = np.asarray(jax.random.normal(init_key, shape, jnp.float32))
    noise = np.zeros((len(t_op), 2, *shape), np.float32)
    for i in range(len(t_op)):
        key, k_step, k_known = jax.random.split(key, 3)
        noise[i, 0] = np.asarray(jax.random.normal(k_step, flat, jnp.float32)).reshape(shape)
        if is_rev[i]:
            noise[i, 1] = np.asarray(jax.random.normal(k_known, flat, jnp.float32)).reshape(shape)
    return torch.from_numpy(img.copy()), torch.from_numpy(noise)


@pytest.mark.parametrize("family", ["ddpm", "improved"])
def test_inpaint_matches_jax_and_keeps_the_known_region(family):
    """``inpaint`` (jumps 2 x 3 at T = 10) with the JAX scan's own draws
    injected against ``repaint_loop`` of the JAX package: 1e-3; the known
    region of the result is the input exactly; replays == eager loop."""
    model, jmodel = _pair(family)
    known = _images(5, 0.0, 1.0)
    mask = torch.ones((1, IMG, IMG, 1))
    mask[:, 2:6, 1:5] = 0.0
    t_op, is_rev = repaint_schedule(T, 2, 3)
    key = jax.random.PRNGKey(9)
    img, noise = _jax_repaint_draws(key, t_op, is_rev, SHAPE)
    sampler = model.sampler
    with torch.inference_mode():
        from diffusion_model_nemo_tpu_torch.modules import repaint_loop

        out = repaint_loop(sampler, model.get_model_fn(), model.params, known * 2.0 - 1.0, mask, img=img,
                           jump_length=2, jump_n_sample=3, noise=noise, graphs=True)
    ref = j_repaint_loop(jmodel.sampler, jmodel.model_fn, jmodel.params, jnp.asarray(known.numpy()) * 2.0 - 1.0,
                         jnp.asarray(mask.numpy()), key, jump_length=2, jump_n_sample=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    keep = mask.expand(SHAPE) > 0
    assert torch.equal(out[keep], (((known * 2.0 - 1.0) + 1.0) * 0.5)[keep])
    outs = []
    for g in (True, False):
        gen = _gen()
        outs.append((model.inpaint(known, mask, generator=gen, jump_length=2, jump_n_sample=3, graphs=g),
                     gen.get_state()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][0][keep], out[keep])
    names = sorted(g.info["name"] for g in model.sampler.graphs.values())
    assert names == ["repaint_forward", "repaint_reverse"], names


def test_inpaint_needs_an_ancestral_family_sampler(ddpm):
    """A DDIM-configured model inpaints too (GeneralizedGaussianDiffusion is
    of the GaussianDiffusion family, as in JAX)."""
    model, _ = ddpm
    _use_ddim(model)
    out = model.inpaint(_images(5, 0.0, 1.0), torch.ones((1, IMG, IMG, 1)), generator=_gen(), jump_length=2,
                        jump_n_sample=2)
    assert out.shape == SHAPE and bool(torch.isfinite(out).all())
