"""The port's score-SDE library against the JAX package, on the CPU: the
three SDEs, the score function, the predictors and correctors, the
predictor–corrector and probability-flow samplers, and RK45.

Inputs are made with numpy from a seed; draws are taken from the JAX
package's own key splits and injected into the port. The network is
examples/configs/score_sde/vp/unet_small.yaml cut to a float32 U-Net
(dim 8, dim_mults [1], 4 GroupNorm groups as shipped, 8 px); the JAX side
gets the port's seeded weights through ``utils/weights.py``. The chains
over every predictor × corrector use a smooth elementwise stand-in for the
network (a chain of U-Nets compiles for seconds per case in JAX); three of
them (tests/test_sde.py's) run on the U-Net too.

Tolerances, each stated where it is used: the SDE math 1e-6 relative (the
time grid bit for bit against JAX's linspace arithmetic, every discrete
index equal); the score function on the
U-Net 2e-4 relative; each 20-step chain 1e-4 absolute on the [0, 1]
output; RK45 equal NFE and 1e-5 relative; the probability-flow sampler
equal NFE and 1e-3 relative L2 on the images (the random-weight U-Net's ODE
carries float32's differences to ~3e-4 over ~130 steps: JAX's own images
with and without an outer ``jax.jit`` differ by as much). The replayed loops (the captured steps of
the card, run eagerly here) equal their eager loops bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import ScoreSDE as JScoreSDE
from diffusion_model_nemo_tpu.modules import PredictorCorrectorSampler as JPC
from diffusion_model_nemo_tpu.modules import ProbabilityFlowSampler as JPF
from diffusion_model_nemo_tpu.modules import VESDE as JVE
from diffusion_model_nemo_tpu.modules import VPSDE as JVP
from diffusion_model_nemo_tpu.modules import subVPSDE as JSubVP
from diffusion_model_nemo_tpu.modules.sde_lib.score_fn import resolve_score_function as j_score_fn
from diffusion_model_nemo_tpu.ops.ode import odeint_rk45 as j_odeint
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import ScoreSDE
from diffusion_model_nemo_tpu_torch.modules import (
    VESDE, VPSDE, PredictorCorrectorSampler, ProbabilityFlowSampler, subVPSDE,
)
from diffusion_model_nemo_tpu_torch.modules.sde_lib.score_fn import resolve_score_function
from diffusion_model_nemo_tpu_torch.modules.sde_lib.sde_lib import jax_linspace
from diffusion_model_nemo_tpu_torch.ops import ode
from diffusion_model_nemo_tpu_torch.ops.ode import odeint_rk45, poison_on_failure
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/score_sde/vp/unet_small.yaml"
IMG, B, N = 8, 2, 20
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={N}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic",
]
SDE_TOL = 1e-6
NET_TOL = 2e-4  # a whole U-Net (tests/test_torch_export.py:78)
CHAIN_TOL = 1e-4  # a 20-step chain, absolute on the [0, 1] output
ODE_TOL = 1e-5
PF_TOL = 1e-3  # relative L2: JAX's own images with and without an outer jax.jit differ by ~3e-4
SHAPE = (B, IMG, IMG, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def pair():
    """The port's ScoreSDE (seeded weights) and the JAX one with the same
    weights, and the JAX network jitted once."""
    model = ScoreSDE(load_config(YAML, overrides=TINY).model, device="cpu")
    jmodel = JScoreSDE(cfg=j_load_config(YAML, overrides=TINY).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    jfn = jax.jit(jmodel.model_fn)
    return model, jmodel, (lambda p, x, t: jfn(p, x, t))


def _sdes(kind, n=N):
    if kind == "vp":
        return JVP(beta_max=10.0, N=n), VPSDE(beta_max=10.0, N=n, device="cpu")
    if kind == "subvp":
        return JSubVP(beta_max=10.0, N=n), subVPSDE(beta_max=10.0, N=n, device="cpu")
    return JVE(N=n), VESDE(N=n, device="cpu")


def _close(ours, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=tol, atol=tol, err_msg=what)


# ----------------------------------------------------------- the time grid --
GRIDS = [(1.0, 1e-3, 1000), (1.0, 1e-5, 1000), (1.0, 1e-3, N), (float(np.log(0.01)), float(np.log(50.0)), 1000)]


@pytest.mark.parametrize("start,stop,num", GRIDS)
def test_time_grid_is_jax_linspace_bit_for_bit(start, stop, num):
    """Bit for bit against JAX's ``linspace`` arithmetic (``_linspace``
    evaluated op by op); within four float32 steps at the range's scale of
    the jitted ``jnp.linspace``, whose XLA:CPU compilation folds 1/div into
    a constant and contracts the sum into FMAs in its vector body (it
    differs from its own formula in ~40% of the values at N = 1000, by up
    to three steps)."""
    ours = jax_linspace(start, stop, num)
    with jax.disable_jit():
        ref = np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32))
    assert ours.dtype == np.float32 and np.array_equal(ours, ref)
    jitted = np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32))
    assert np.abs(ours - jitted).max() <= 4 * np.spacing(np.float32(max(abs(start), abs(stop))))


def test_sampler_grid_and_discrete_indices_equal_jax():
    """The PC grid of the shipped N = 1000 (T = 1, eps = 1e-3), and on it
    the int cast t·(N−1)/T (VP discretize, ancestral, Langevin's α) and
    VE's round((T − t)(N − 1)): index for index against the jitted JAX
    grid's, as the JAX sampler computes them."""
    sde = VPSDE(N=1000, device="cpu")
    grid = sde.time_grid(sde.sampling_epsilon)
    with jax.disable_jit():
        assert np.array_equal(grid.numpy(), np.asarray(jnp.linspace(1.0, 1e-3, 1000, dtype=jnp.float32)))
    ref = jax.jit(lambda: jnp.linspace(1.0, 1e-3, 1000, dtype=jnp.float32))()
    idx = (grid * (1000 - 1) / 1.0).to(torch.int32).numpy()
    assert np.array_equal(idx, np.asarray((ref * (1000 - 1) / 1.0).astype(jnp.int32)))
    ve = torch.round((1.0 - grid) * (1000 - 1)).to(torch.int32).numpy()
    assert np.array_equal(ve, np.asarray(jnp.round((1.0 - ref) * (1000 - 1)).astype(jnp.int32)))


# ------------------------------------------------------------- the SDE math --
@pytest.mark.parametrize("kind", ["vp", "subvp", "ve"])
def test_sde_math_matches_jax(kind):
    """sde, marginal_prob, discretize, prior_logp and the discrete tables,
    at a [B] t and at a 0-d t (the samplers' fast path): 1e-6."""
    jsde, sde = _sdes(kind)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 3, 2)).astype(np.float32)
    for t in (np.asarray([0.0, 1e-3, 0.37, 1.0], np.float32), np.float32(0.61)):
        tj, tt, xj, xt = jnp.asarray(t), torch.as_tensor(t), jnp.asarray(x), torch.from_numpy(x)
        for name in ("sde", "marginal_prob", "discretize"):
            for o, r in zip(getattr(sde, name)(xt, tt), getattr(jsde, name)(xj, tj)):
                _close(o.numpy(), r, SDE_TOL, f"{kind} {name} t={t}")
    _close(sde.prior_logp(torch.from_numpy(x)).numpy(), jsde.prior_logp(jnp.asarray(x)), SDE_TOL)
    tables = {"vp": ("betas", "discrete_betas", "alphas", "alphas_cumprod", "sqrt_alphas_cumprod",
                     "sqrt_1m_alphas_cumprod"), "ve": ("discrete_sigmas",), "subvp": ()}[kind]
    for name in tables:
        _close(getattr(sde, name).numpy(), getattr(jsde, name), SDE_TOL, name)


def test_prior_sampling_scale_and_shapes():
    g = torch.Generator().manual_seed(0)
    for kind, std in (("vp", 1.0), ("ve", 50.0)):
        _, sde = _sdes(kind)
        z = sde.prior_sampling((4096,), g)
        assert z.dtype == torch.float32 and abs(float(z.std()) / std - 1.0) < 0.05


# -------------------------------------------------------- the score function --
@pytest.mark.parametrize("kind,continuous", [("vp", True), ("vp", False), ("subvp", True), ("ve", True),
                                             ("ve", False)])
def test_score_function_matches_jax(pair, kind, continuous):
    """On the U-Net (4 GroupNorm groups): VP/sub-VP −model/std with float
    labels t·(N−1) (int labels and the sqrt_1m_alphas_cumprod table for a
    discrete VP); VE σ labels or round((T−t)(N−1)). 2e-4."""
    model, jmodel, jfn = pair
    jsde, sde = _sdes(kind)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    for t in (np.asarray([0.05, 0.8], np.float32), np.float32(0.33)):
        ours = resolve_score_function(model.model_fn, sde, continuous)(model.params, torch.from_numpy(x),
                                                                       torch.as_tensor(t))
        ref = j_score_fn(jfn, jsde, continuous)(jmodel.params, jnp.asarray(x), jnp.asarray(t))
        assert _rel_l2(ours.numpy(), ref) < NET_TOL, (kind, continuous, t)


def test_time_embedding_takes_float_labels(pair):
    """Float labels reach the sinusoid as floats: t·(N−1) = 9.5 is neither
    label 9 nor label 10."""
    model, _, _ = pair
    x = torch.zeros(SHAPE)
    out = {t: model.model_fn(model.params, x, torch.full((B,), t)) for t in (9.0, 9.5, 10.0)}
    assert not torch.equal(out[9.5], out[9.0]) and not torch.equal(out[9.5], out[10.0])


# --------------------------------------------------- predictors × correctors --
def _toy_jax(params, x, labels):
    return jnp.tanh(0.5 * x + 0.01 * labels.astype(jnp.float32)[:, None, None, None])


def _toy_torch(params, x, labels):
    return torch.tanh(0.5 * x + 0.01 * labels.to(torch.float32)[:, None, None, None])


def jax_pc_draws(key, shape, n_c: int, n_p: int, steps: int, prior_std: float = 1.0):
    """The prior draw and the per-step normals [steps, n_c + n_p, *shape]
    exactly as JAX's ``PredictorCorrectorSampler.sample`` splits its key."""
    key, prior_key = jax.random.split(key)
    x = jax.random.normal(prior_key, shape, dtype=jnp.float32) * prior_std if prior_std != 1.0 else \
        jax.random.normal(prior_key, shape, dtype=jnp.float32)
    z = np.zeros((steps, n_c + n_p, *shape), np.float32)
    k = key
    for i in range(steps):
        k, kc, kp = jax.random.split(k, 3)
        for j in range(n_c):
            kc, sub = jax.random.split(kc)
            z[i, j] = np.asarray(jax.random.normal(sub, shape, dtype=jnp.float32))
        if n_p:
            z[i, n_c] = np.asarray(jax.random.normal(kp, shape, dtype=jnp.float32))
    return np.array(x), z


def _chain_pair(kind, predictor, corrector, jfn, fn, params_j, params_t, seed, n_steps=1, snr=0.16):
    """(ours, ref): one N-step PC chain in both packages on the JAX draws."""
    jsde, sde = _sdes(kind)
    jpc = JPC(predictor=predictor, corrector=corrector, snr=snr, n_steps=n_steps)
    jpc.update_sde(jsde)
    pc = PredictorCorrectorSampler(predictor=predictor, corrector=corrector, snr=snr, n_steps=n_steps)
    pc.update_sde(sde)
    key = jax.random.PRNGKey(seed)
    n_c = 0 if corrector is None else n_steps
    n_p = 0 if predictor in (None, "none") else 1
    x_T, z = jax_pc_draws(key, SHAPE, n_c, n_p, N, prior_std=50.0 if kind == "ve" else 1.0)
    ref, jnfe = jpc.sample(jfn, params_j, SHAPE, key, return_nfe=True)
    ours, nfe = pc.sample(fn, params_t, SHAPE, noise=torch.from_numpy(z), x_T=torch.from_numpy(x_T),
                          return_nfe=True)
    assert nfe == jnfe == N * (n_steps + 1)
    return ours.numpy(), np.asarray(ref)


MATRIX = [(p, c) for p in (None, "euler_maruyama", "reverse_diffusion", "ancestral_sampling")
          for c in (None, "langevin", "ald")]


@pytest.mark.parametrize("kind,predictor,corrector",
                         [("vp", p, c) for p, c in MATRIX]
                         + [("ve", "ancestral_sampling", "ald"), ("ve", "reverse_diffusion", "langevin"),
                            ("ve", "euler_maruyama", None), ("subvp", "euler_maruyama", "langevin"),
                            ("subvp", "reverse_diffusion", "ald")])
def test_pc_chain_matches_jax(kind, predictor, corrector):
    """Every predictor × corrector over a 20-step chain (VP; three on VE,
    two on sub-VP) on the JAX chain's draws, with a smooth stand-in
    network: 1e-4 absolute at the output's scale (a VE chain under the
    stand-in ends near its prior's σ_max = 50, not in [0, 1])."""
    ours, ref = _chain_pair(kind, predictor, corrector, _toy_jax, _toy_torch, None, None, seed=3)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=CHAIN_TOL * max(1.0, float(np.abs(ref).max())))


def test_ancestral_predictor_refuses_sub_vp_as_jax_does():
    jsde, sde = _sdes("subvp")
    jpc, pc = JPC("ancestral_sampling", None, 0.16), PredictorCorrectorSampler("ancestral_sampling", None, 0.16)
    jpc.update_sde(jsde)
    pc.update_sde(sde)
    with pytest.raises(NotImplementedError):
        jpc._build(_toy_jax)
    with pytest.raises(NotImplementedError):
        pc._build(_toy_torch)


@pytest.mark.parametrize("predictor,corrector", [("reverse_diffusion", "langevin"), ("euler_maruyama", None),
                                                 ("ancestral_sampling", "ald")])
def test_pc_chain_on_the_unet_matches_jax(pair, predictor, corrector):
    """tests/test_sde.py's three combinations on the U-Net: 1e-4 absolute."""
    model, jmodel, jfn = pair
    ours, ref = _chain_pair("vp", predictor, corrector, jfn, model.model_fn, jmodel.params, model.params, seed=4)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=CHAIN_TOL)


@pytest.mark.parametrize("predictor,corrector,n_steps", [("reverse_diffusion", "langevin", 2),
                                                         ("euler_maruyama", None, 1), (None, "ald", 1)])
def test_pc_replays_equal_the_eager_chain(pair, predictor, corrector, n_steps):
    """The captured step's replays (run eagerly on the CPU) against the
    Python loop, bit for bit, generator state included; the second call
    replays the cached graph from step 0; a 5-step prefix (``num_steps``)
    too."""
    model, _, _ = pair
    model.change_sampler({"_target_": "diffusion_model_nemo.modules.PredictorCorrectorSampler",
                          "predictor": predictor, "corrector": corrector, "snr": 0.16, "n_steps": n_steps})
    runs = []
    for graphs in (True, False, True):
        g = torch.Generator().manual_seed(11)
        runs.append((model.sample(B, IMG, generator=g, graphs=graphs), g.get_state()))
    for out, state in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(state, runs[0][1])
    assert len(model.sampler.graphs) == 1
    graph = next(iter(model.sampler.graphs.values()))
    assert graph.info["replays"] == 2 * N - 1  # N - 1 after the warm-up, then N
    with torch.inference_mode():  # as ScoreSDE.sample calls it: the graph's buffers are inference tensors
        prefix = [model.sampler.sample(model.get_model_fn(), model.params, SHAPE, torch.Generator().manual_seed(11),
                                       graphs=g, num_steps=5) for g in (True, False)]
    assert torch.equal(prefix[0], prefix[1]) and not torch.equal(prefix[0], runs[0][0])


# --------------------------------------------------------------------- RK45 --
A = np.array([[0.0, 1.0], [-4.0, -0.3]])


def _beta(t):
    return 0.1 + t * (20.0 - 0.1)


ODE_CASES = {
    # tests/test_ode_vs_scipy.py's problems: (jax f, torch f, y0, t0, t1, rtol, atol)
    "linear": (lambda t, y: jnp.asarray(A, jnp.float32) @ y,
               lambda t, y: torch.tensor(A, dtype=torch.float32) @ y, [1.0, 0.0], 0.0, 5.0, 1e-5, 1e-5),
    "vpsde_drift": (lambda t, y: -0.5 * _beta(t) * y, lambda t, y: -0.5 * _beta(t) * y,
                    [1.0, -2.0, 0.5], 1e-5, 1.0, 1e-5, 1e-5),
    "van_der_pol": (lambda t, y: jnp.stack([y[1], 1.0 * (1 - y[0] ** 2) * y[1] - y[0]]),
                    lambda t, y: torch.stack([y[1], 1.0 * (1 - y[0] ** 2) * y[1] - y[0]]),
                    [2.0, 0.0], 0.0, 6.0, 1e-6, 1e-8),
    "reverse_time": (lambda t, y: -y * jnp.cos(t), lambda t, y: -y * torch.cos(t), [1.5], 2.0, 0.0, 1e-5, 1e-5),
}


@pytest.mark.parametrize("case", sorted(ODE_CASES))
def test_rk45_matches_jax(case):
    """Equal NFE, the final state within 1e-5 relative (forward and reverse
    in time), and the captured step's replays equal the eager loop."""
    jf, tf, y0, t0, t1, rtol, atol = ODE_CASES[case]
    y0 = np.asarray(y0, np.float32)
    ref = j_odeint(jf, jnp.asarray(y0), t0, t1, rtol=rtol, atol=atol)
    ours = odeint_rk45(tf, torch.from_numpy(y0), t0, t1, rtol=rtol, atol=atol)
    assert int(ours.nfev) == int(ref.nfev) and bool(ours.success) and bool(ref.success)
    np.testing.assert_allclose(ours.y.numpy(), np.asarray(ref.y), rtol=ODE_TOL, atol=ODE_TOL * 1e-2)
    replayed = odeint_rk45(tf, torch.from_numpy(y0), t0, t1, rtol=rtol, atol=atol, graphs=True, store={})
    assert torch.equal(replayed.y, ours.y) and torch.equal(replayed.nfev, ours.nfev)


def test_rk45_tuple_state_and_extra_replays_change_nothing(monkeypatch):
    """A (x, logp) state, as the likelihood integrates it; replays after
    ``done`` leave t, y, h and NFE unchanged (``CHECK_EVERY`` far above the
    steps the solve needs, then below them)."""
    def f(t, y):
        x, _ = y
        return -0.5 * _beta(t) * x, (x * x).sum(dim=1)

    y0 = (torch.tensor([[1.0, -2.0], [0.5, 0.25]]), torch.zeros(2))
    eager = odeint_rk45(f, y0, 1e-5, 1.0)
    store = {}
    monkeypatch.setattr(ode, "CHECK_EVERY", 500)
    many = odeint_rk45(f, y0, 1e-5, 1.0, graphs=True, store=store)
    monkeypatch.setattr(ode, "CHECK_EVERY", 3)
    again = odeint_rk45(f, y0, 1e-5, 1.0, graphs=True, store=store)
    for sol in (many, again):
        assert all(torch.equal(a, b) for a, b in zip(sol.y, eager.y)) and torch.equal(sol.nfev, eager.nfev)
    graph = next(iter(store.values()))
    assert float(graph.static["t"]) == 1.0 and graph.info["replays"] >= 500


def test_rk45_max_steps_exhaustion_poisons_with_nan():
    sol = odeint_rk45(lambda t, y: -y, torch.ones(2), 0.0, 1.0, max_steps=3)
    ref = j_odeint(lambda t, y: -y, jnp.ones(2), 0.0, 1.0, max_steps=3)
    assert not bool(sol.success) and not bool(ref.success) and int(sol.nfev) == int(ref.nfev) == 21
    assert torch.isnan(poison_on_failure(sol, sol.y, "a test")).all()
    replayed = odeint_rk45(lambda t, y: -y, torch.ones(2), 0.0, 1.0, max_steps=3, graphs=True, store={})
    assert not bool(replayed.success) and int(replayed.nfev) == 21


# ------------------------------------------------------- probability flow --
def test_probability_flow_sampler_matches_jax(pair):
    """RK45 from the JAX prior draw on the U-Net with the denoising step:
    equal NFE, 1e-3 relative L2; the captured solve equals the eager one."""
    model, jmodel, jfn = pair
    jsde, sde = _sdes("vp", 1000)
    jpf, pf = JPF(denoise=True), ProbabilityFlowSampler(denoise=True)
    jpf.update_sde(jsde)
    pf.update_sde(sde)
    key = jax.random.PRNGKey(5)
    # As the JAX sampler runs when called: under an outer jax.jit XLA fuses
    # the drift into the solver's arithmetic differently and JAX itself
    # takes another NFE (889 against 903 here).
    ref, jnfe = jpf.sample(jfn, jmodel.params, SHAPE, key, return_nfe=True)
    _, prior_key, _ = jax.random.split(key, 3)
    noise = torch.from_numpy(np.asarray(jax.random.normal(prior_key, SHAPE, dtype=jnp.float32)))
    with torch.inference_mode():
        ours, nfe = pf.sample(model.model_fn, model.params, SHAPE, noise=noise, return_nfe=True)
        replayed, nfe_r = pf.sample(model.model_fn, model.params, SHAPE, noise=noise, return_nfe=True,
                                    graphs=True)
    assert int(nfe) == int(jnfe) > 0, (int(nfe), int(jnfe))
    assert _rel_l2(ours.numpy(), ref) < PF_TOL
    assert torch.equal(replayed, ours) and torch.equal(nfe_r, nfe)
