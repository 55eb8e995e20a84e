"""The port's one-dispatch loops, on the CPU: the step functions that the
card captures as CUDA graphs (``ops/graphs.py``), run here as eager
"replays" (``graphs=True`` on the CPU), against the Python-int loops and the
JAX package.

- The ancestral chain (t = 0 included), the DDIM chain (eta 0 and > 0,
  strided and not) and bits/dim (drawn and injected noise)
  equal their Python loops bit for bit, generator state included, and the
  step functions with a 0-d tensor ``t`` equal their Python-int calls.
- ``DDPM.sample`` (DDIM and ancestral) and ``calculate_bits_per_dimension``
  through the replays agree with the JAX package on injected draws, at the
  tolerances of the existing comparisons: the DDIM chain 1e-3
  (tests/test_torch_port_unet.py), bits/dim rtol 1e-4 on total_bpd and
  1e-3 / atol 1e-5 on the terms (tests/test_torch_port_archive.py).
- A graph lives in its sampler and follows the parameters' versions and
  identity; a replay adds its capture's launch counts (a stand-in for the
  CUDA graph).

The training step's graph, its tabled scalars and ``steps_per_execution``
are tests/test_torch_port_graphs_training.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import DDPM as JDDPM
from diffusion_model_nemo_tpu.modules.generalized_gaussian_diffusion import (
    GeneralizedGaussianDiffusion as JGeneralized,
)
from diffusion_model_nemo_tpu_torch import DDPM
from diffusion_model_nemo_tpu_torch import ops
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.ops import graphs
from diffusion_model_nemo_tpu_torch.ops import norm as TN

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/ddpm/unet_small.yaml"
T, IMG, B = 10, 8, 3
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=16",
]
DDIM = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
ANCESTRAL = "diffusion_model_nemo.modules.GaussianDiffusion"
CHAIN_TOL = 1e-3  # the DDIM chain against JAX (tests/test_torch_port_unet.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0):
    return DDPM(load_config(YAML, overrides=TINY).model, device="cpu", seed=seed)


def _use(model, target, **extra):
    cfg = {k: v for k, v in model.cfg.sampler.items() if k not in ("eta", "ddim_timesteps")}
    model.change_sampler(dict(cfg, _target_=target, **extra))


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _sample_both(model, **kw):
    """(replayed, eager) samples and generator states from one seed."""
    out = []
    for g in (True, False):
        gen = _gen()
        out.append((model.sample(B, IMG, generator=gen, graphs=g, **kw), gen.get_state()))
    return out


# ------------------------------------------------------- bit for bit, CPU --
@pytest.mark.parametrize("num_steps", [None, 1, 4], ids=["T", "t0-only", "last-4"])
def test_ancestral_replays_equal_the_python_loop(num_steps):
    """t = T-1 … 1 as replays of ``ancestral_step`` with a 0-d t and noise
    drawn before each replay, t = 0 eagerly: the same bits and the same
    generator state as the Python-int loop. Exact."""
    model = _model()
    _use(model, ANCESTRAL)
    outs = []
    for g in (True, False):
        gen = _gen()
        with torch.inference_mode():
            x = model.sampler.p_sample_loop(model.get_model_fn(), model.params, (B, IMG, IMG, 3), gen,
                                            num_steps=num_steps, graphs=g)
        outs.append((x, gen.get_state()))
    (a, sa), (b, sb) = outs
    assert torch.equal(a, b) and torch.equal(sa, sb)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("ddim_timesteps", [5, T], ids=["strided", "every-t"])
def test_ddim_replays_equal_the_python_loop(eta, ddim_timesteps):
    """The DDIM chain as replays of one step graph reading (t, t_next) from
    device tables at a 0-d counter, its noise drawn into a static buffer
    before each replay: the Python loop's bits and generator state, twice
    in a row (the second call replays the sampler's graph). Exact."""
    model = _model()
    _use(model, DDIM, eta=eta, ddim_timesteps=ddim_timesteps)
    (a, sa), (b, sb) = _sample_both(model)
    (c, sc), _ = _sample_both(model)
    assert torch.equal(a, b) and torch.equal(sa, sb)
    assert torch.equal(c, b) and torch.equal(sc, sb)


@pytest.mark.parametrize("injected", [False, True], ids=["generator", "injected-noise"])
def test_bits_per_dimension_replays_equal_the_python_loop(injected):
    """Bits/dim's T terms as replays of one step (0-d t, the term written at
    row t): every output bit for bit, generator state included. Exact."""
    model = _model()
    _use(model, ANCESTRAL)
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32))
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal((T, B, IMG, IMG, 3)).astype(np.float32))
    outs = []
    for g in (True, False, True):
        gen = _gen()
        out = model.calculate_bits_per_dimension(x, generator=None if injected else gen,
                                                 noise=noise if injected else None, graphs=g)
        outs.append((out, gen.get_state()))
    for out, state in outs[1:]:
        assert all(torch.equal(out[k], outs[0][0][k]) for k in out)
        assert torch.equal(state, outs[0][1])


def test_step_functions_take_a_0d_tensor_t():
    """``ancestral_step``, ``ddim_step`` (eta 0 and > 0, injected noise) and
    the bits/dim term at a 0-d int64 ``t`` equal their Python-int calls.
    Exact."""
    model = _model()
    fn, params = model.get_model_fn(), model.params
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32))
    _use(model, ANCESTRAL)
    s = model.sampler
    for t in (1, 6, T - 1):
        a = s.ancestral_step(fn, params, x, torch.tensor(t), noise)
        assert torch.equal(a, s.p_sample(fn, params, x, t, noise=noise))
    x0 = torch.from_numpy(rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32))
    for t in (0, 5):
        assert torch.equal(model._bpd_term(fn, params, x0, torch.tensor(t), noise),
                           model._bpd_term(fn, params, x0, t, noise))
    for eta in (0.0, 0.5):
        _use(model, DDIM, eta=eta, ddim_timesteps=5)
        s = model.sampler
        for t, t_next in ((8, 6), (0, -1)):
            a = s.ddim_step(fn, params, x, torch.tensor(t), torch.tensor(t_next), noise=noise)
            b = s.ddim_step(fn, params, x, t, t_next, noise=noise)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------- against JAX, CPU --
@pytest.fixture(scope="module")
def pair():
    """The JAX DDPM and the port's with the same (carried) weights."""
    jmodel = JDDPM(cfg=j_load_config(YAML, overrides=TINY).model)
    jmodel.init_params(jax.random.PRNGKey(0))
    model = _model()
    model._load_flax(jax.tree.map(np.asarray, jmodel.params), None)
    return jmodel, model


def test_ddpm_sample_ddim_replays_match_jax(pair):
    """``DDPM.sample`` with DDIM (eta 0: only x_T is drawn) through the
    replays against the JAX chain from the same x_T. Tolerance 1e-3."""
    jmodel, model = pair
    _use(model, DDIM, eta=0.0, ddim_timesteps=5)
    ours = model.sample(B, IMG, generator=_gen(), graphs=True)
    x_T = torch.randn((B, IMG, IMG, 3), generator=_gen())
    kw = dict(timesteps=T, schedule_name=model.sampler.schedule_name, eta=0.0, ddim_timesteps=5)
    ref = JGeneralized(**kw).p_sample_loop(jmodel.model_fn, jmodel.params, x_T.shape, jax.random.PRNGKey(0),
                                           img=jnp.asarray(x_T.numpy()))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)


def test_ddpm_sample_ancestral_replays_match_jax(pair):
    """``DDPM.sample`` with the ancestral chain through the replays against
    the JAX steps (``p_mean_variance`` + σ_t·noise, the mean at t = 0) fed
    the same draws: x_T, then each t > 0's noise, in the generator's order.
    Tolerance 1e-3 (the DDIM chain's: T network calls at 2e-4)."""
    jmodel, model = pair
    _use(model, ANCESTRAL)
    ours = model.sample(B, IMG, generator=_gen(), graphs=True)
    gen = _gen()
    x = jnp.asarray(torch.randn((B, IMG, IMG, 3), generator=gen).numpy())
    for t in range(T - 1, -1, -1):
        out = jmodel.sampler.p_mean_variance(jmodel.model_fn, jmodel.params, x, jnp.int32(t))
        x = out.mean
        if t > 0:
            x = x + jnp.exp(0.5 * out.log_variance) * jnp.asarray(torch.randn((B, IMG, IMG, 3), generator=gen).numpy())
    np.testing.assert_allclose(ours.numpy(), np.asarray((x + 1.0) * 0.5), atol=CHAIN_TOL, rtol=CHAIN_TOL)


def _jax_bpd_noise(key, shape):
    """The JAX scan's per-t noise (t descending): one split a step."""
    out = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def test_bits_per_dimension_replays_match_jax(pair):
    """Bits/dim through the replays on 8-bit-grid data with the JAX scan's
    noise injected. total_bpd rtol 1e-4, terms rtol 1e-3 / atol 1e-5."""
    jmodel, model = pair
    _use(model, ANCESTRAL)
    x = np.random.default_rng(4).integers(0, 256, (B, IMG, IMG, 3)).astype(np.float32) / 127.5 - 1.0
    x[:, 0, 0, 0], x[:, 0, 1, 0] = 1.0, -1.0
    key = jax.random.PRNGKey(11)
    ref = jmodel.calculate_bits_per_dimension(jnp.asarray(x), key=key)
    ours = model.calculate_bits_per_dimension(torch.from_numpy(x), graphs=True,
                                              noise=torch.from_numpy(_jax_bpd_noise(key, x.shape)))
    np.testing.assert_allclose(ours["total_bpd"].numpy(), np.asarray(ref["total_bpd"]), rtol=1e-4)
    np.testing.assert_allclose(ours["terms_bpd"].numpy(), np.asarray(ref["terms_bpd"]), rtol=1e-3, atol=1e-5)


# ------------------------------------------------------------- graph cache --
def test_graph_cache_key_follows_parameter_versions():
    """One capture for repeated samples; another after an in-place update
    of a parameter, after an EMA swap and after ``load_state_dict``; none
    for an unchanged repeat. The sampler holds one DDIM graph throughout."""
    model = _model()
    _use(model, DDIM, eta=0.0, ddim_timesteps=5)
    built = []  # every graph seen (held, so that no identity is reused)

    def captures_after(**kw):
        model.sample(2, IMG, generator=_gen(), graphs=True, **kw)
        (graph,) = model.sampler.graphs.values()
        if not any(graph is g for g in built):
            built.append(graph)
        return len(built)

    assert captures_after() == 1 and captures_after() == 1
    with torch.no_grad():
        next(iter(model.params.values())).add_(0.1)
    assert captures_after() == 2 and captures_after() == 2
    assert captures_after(use_ema=True) == 3 and captures_after(use_ema=True) == 3
    model.diffusion_model.load_state_dict({k: v.clone() for k, v in model.params.items()})
    assert captures_after() == 4 and captures_after() == 4


def test_graphs_live_and_die_with_their_sampler():
    """A sampler keeps its graphs (DDIM and bits/dim, one entry each) and
    they go with it: after ``change_sampler`` the new sampler holds none
    and captures its own."""
    import gc
    import weakref

    model = _model()
    _use(model, DDIM, eta=0.0, ddim_timesteps=5)
    model.sample(2, IMG, generator=_gen(), graphs=True)
    model.calculate_bits_per_dimension(torch.zeros((2, IMG, IMG, 3)), graphs=True)
    assert sorted(g.info["name"] for g in model.sampler.graphs.values()) == ["bpd", "ddim"]
    old = [weakref.ref(g) for g in model.sampler.graphs.values()]
    _use(model, DDIM, eta=0.0, ddim_timesteps=5)
    gc.collect()  # on the CPU a graph keeps its step function, which holds the sampler
    assert all(ref() is None for ref in old) and model.sampler.graphs == {}
    model.sample(2, IMG, generator=_gen(), graphs=True)
    assert [g.info["name"] for g in model.sampler.graphs.values()] == ["ddim"]


def _stand_in_capture(monkeypatch):
    """Replace the CUDA capture with a stand-in on the CPU; returns it."""
    stand_in = _StandInGraph()

    def capture(run):
        return stand_in, run(), {"capture_s": 0.0, "nodes": None, "pool_mib": 0.0}

    monkeypatch.setattr(graphs, "_on_side_stream", lambda fn: fn())
    monkeypatch.setattr(graphs, "_capture", capture)
    return stand_in


class _StandInGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_the_captured_launch_counts(monkeypatch):
    """The launches a capture counted are taken back (a capture launches
    nothing) and added again at every replay; the warm-up's are real
    launches and stay. A stand-in replaces the CUDA capture on the CPU."""
    stand_in = _stand_in_capture(monkeypatch)

    def step():  # what a wrapper does where it launches: two launches a step
        TN.LAUNCHES["group_norm_silu"] += 2

    ops.reset_launch_counts()
    graph = graphs.Graph("stand-in", step, {}, device="cuda", warmup=step)
    assert ops.launch_counts()["group_norm_silu"] == 2  # the warm-up's step
    assert graph.delta == {"group_norm_silu": 2} and graph.info["launches"] == {"group_norm_silu": 2}
    graph.replay(4)
    graph.replay()
    assert stand_in.replays == 5 and graph.info["replays"] == 5
    assert ops.launch_counts()["group_norm_silu"] == 2 + 5 * 2
    ops.reset_launch_counts()


def test_a_captured_graph_goes_with_its_owner_by_reference_counting(monkeypatch):
    """Once captured (a stand-in for the CUDA capture), a graph holds no
    reference to its step function, so an owner whose ``graphs`` holds it
    is no cycle: dropping the owner frees owner and graph with the cyclic
    collector off (a graph it freed could go in the middle of another
    capture, which a capture forbids)."""
    import gc
    import weakref

    _stand_in_capture(monkeypatch)

    class Owner:
        pass

    owner = Owner()
    owner.graphs = {}
    x = torch.zeros(3)

    def step():  # reads and writes the owner's tensors, as a loop's step does
        x.add_(1.0)
        owner.steps = getattr(owner, "steps", 0) + 1

    graph, built = graphs.cached(owner.graphs, ("stand-in",), (x,),
                                 lambda: graphs.Graph("stand-in", step, {"x": x}, device="cuda", warmup=step))
    assert built and graphs.cached(owner.graphs, ("stand-in",), (x,), None) == (graph, False)
    refs = weakref.ref(owner), weakref.ref(graph)
    gc.disable()
    try:
        del owner, graph, step
        assert all(ref() is None for ref in refs)
    finally:
        gc.enable()
