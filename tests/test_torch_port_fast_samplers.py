"""The port's DPM-Solver++, UniPC and Karras samplers on the CPU, against
the JAX package and against their own eager loops.

- The host coefficient tables (and the σ grid, the step grids) equal the
  JAX package's exactly, for every order, spacing, variant, grid and churn.
- The chains, final images and frames, agree with the JAX scans on the same
  weights and the same x_T (Karras's churn: the JAX scan's draws injected)
  within the DDIM chain's 1e-3 (tests/test_torch_port_graphs.py).
- The exact relations inside the port: UniPC order 2 ``bh2`` without the
  corrector is DPM-Solver++(2M), Karras order 1 on the ``ddim`` grid is
  DDIM η = 0, every sampler lands on x̂₀ on a constant-x̂₀ field (the JAX
  package's own tolerances, tests/test_unipc.py and tests/test_karras.py).
- Karras conditions the network on float times off the integer grid: the
  times reach the network as float32, not truncated.
- ``graphs=True`` (the captured step run eagerly on the CPU) equals the
  eager loop bit for bit, frames and generator state included.
- A learned-variance output is refused with a ValueError naming it (the
  JAX loops fail on the same output in a reshape); the guided
  ConditionalDDPM under DPM agrees with JAX.
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
from diffusion_model_nemo_tpu.modules.dpm_solver import DPMSolverDiffusion as JDPM
from diffusion_model_nemo_tpu.modules.karras_diffusion import KarrasDiffusion as JKarras
from diffusion_model_nemo_tpu.modules.unipc import UniPCDiffusion as JUniPC
from diffusion_model_nemo_tpu_torch import ConditionalDDPM, DDPM, ImprovedDDPM
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.modules import (
    DPMSolverDiffusion, GeneralizedGaussianDiffusion, KarrasDiffusion, UniPCDiffusion,
)
from diffusion_model_nemo_tpu_torch.modules.gaussian_diffusion import batched_t
from diffusion_model_nemo_tpu_torch.utils.weights import to_flax_params

REPO = Path(__file__).resolve().parents[1]
YAML = REPO / "examples/configs/ddpm/unet_small.yaml"
T, IMG, B = 10, 8, 3
TINY = [
    f"model.image_size={IMG}", f"model.timesteps={T}", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32",
    "model.train_ds.name=synthetic", "model.train_ds.batch_size=4", "+model.train_ds.length=16",
]
CHAIN_TOL = 1e-3  # the DDIM chain against JAX (tests/test_torch_port_unet.py)
MOD = "diffusion_model_nemo.modules."
JAX_CLASSES = {"DPMSolverDiffusion": JDPM, "UniPCDiffusion": JUniPC, "KarrasDiffusion": JKarras}
PORT_CLASSES = {"DPMSolverDiffusion": DPMSolverDiffusion, "UniPCDiffusion": UniPCDiffusion,
                "KarrasDiffusion": KarrasDiffusion}

DPM_CASES = [dict(solver_order=o, time_spacing=s, solver_steps=n)
             for o in (1, 2) for s, n in (("strided", 5), ("logsnr", 8))]
UNIPC_CASES = [dict(solver_order=o, use_corrector=c, variant=v, solver_steps=5)
               for o in (1, 2, 3) for c in (True, False) for v in ("bh1", "bh2")]
KARRAS_CASES = [dict(solver_order=o, grid=g, s_churn=c, solver_steps=4)
                for o in (1, 2) for g in ("karras", "ddim") for c in (0.0, 1.0)]
TABLE_CASES = ([("DPMSolverDiffusion", c) for c in DPM_CASES] + [("UniPCDiffusion", c) for c in UNIPC_CASES]
               + [("KarrasDiffusion", c) for c in KARRAS_CASES])
# The chains held against JAX: every value of every axis of each sampler
# once, the served defaults among them (DPM: order 1 logsnr, order 2
# strided; UniPC: orders 1-3 with the corrector on, on, off and bh1, bh2,
# bh1; Karras: Euler on the ddim grid without churn, Heun on the karras
# grid with churn). The tables above cover the whole product.
CHAIN_CASES = ([("DPMSolverDiffusion", DPM_CASES[i]) for i in (1, 2)]
               + [("UniPCDiffusion", UNIPC_CASES[i]) for i in (0, 5, 10)]
               + [("KarrasDiffusion", KARRAS_CASES[i]) for i in (2, 5)])

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is as fast
    alone, and does not oversubscribe the cores that the suite's other
    workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case_id(case):
    name, kw = case
    return name.replace("Diffusion", "") + "-" + "-".join(f"{v}" for v in kw.values())


def _model(cls=DDPM, overrides=()):
    model = cls(load_config(YAML, overrides=[*TINY, *overrides]).model, device="cpu", seed=0)
    model.base_sampler = dict(model.cfg.sampler)
    return model


def _use(model, target, **extra):
    model.change_sampler(dict(model.base_sampler, _target_=MOD + target, **extra))
    return model.sampler


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _jax_of(model, cls=JDDPM, overrides=()):
    """The JAX model with the port's weights (no JAX init)."""
    jmodel = cls(cfg=j_load_config(YAML, overrides=[*TINY, *overrides]).model)
    jmodel.params = jax.tree.map(jnp.asarray, to_flax_params(model.params, model.diffusion_model))
    return jmodel


@pytest.fixture(scope="module")
def pair():
    model = _model()
    return _jax_of(model), model


def _jax_sampler(name, **kw):
    return JAX_CLASSES[name](timesteps=T, schedule_name="cosine", **kw)


def _jax_churn_noise(key, M, shape):
    """The Karras scan's churn draws: after the prior's split, one split a
    step (the final Euler step's included), each a flat [B, H·W·C] normal."""
    key, _ = jax.random.split(key)
    out = []
    for _ in range(M):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (shape[0], int(np.prod(shape[1:]))), jnp.float32)))
    return torch.from_numpy(np.stack(out).reshape((M, *shape)))


# ------------------------------------------------------------ host tables --
@pytest.mark.parametrize("case", TABLE_CASES, ids=_case_id)
def test_coefficient_tables_equal_jax(case):
    """Every per-step scalar (and the step grid, the σ grid) equals the JAX
    package's, bit for bit: the same float64 numpy, cast once."""
    name, kw = case
    ours = PORT_CLASSES[name](T, "cosine", device="cpu", **kw)
    ref = _jax_sampler(name, **kw)
    table = "_unipc_coefficients" if name == "UniPCDiffusion" else "_solver_coefficients"
    a, b = getattr(ours, table)(), getattr(ref, table)()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == np.float32 and np.array_equal(a[k], np.asarray(b[k])), k
    if name == "KarrasDiffusion":
        for x, y in zip(ours._sigma_grid(), ref._sigma_grid()):
            assert np.array_equal(x, y)
    else:
        for x, y in zip(ours._solver_sequences(), ref._solver_sequences()):
            assert np.array_equal(x, y)


def test_logsnr_grid_may_be_shorter_than_solver_steps():
    """``logsnr`` spacing ``np.unique``s the nearest discrete times: at T = 10
    eight targets land on fewer times, as in JAX, and the chain has M steps."""
    ours = DPMSolverDiffusion(T, "cosine", solver_steps=8, time_spacing="logsnr", device="cpu")
    M = len(ours._solver_sequences()[0])
    assert M < 8 and M == len(_jax_sampler("DPMSolverDiffusion", solver_steps=8,
                                           time_spacing="logsnr")._solver_sequences()[0])
    out, frames = ours.p_sample_loop(lambda p, x, t: torch.zeros_like(x), None, (1, 2, 2, 1), _gen(),
                                     return_frames=True)
    assert frames.shape[0] == M


# --------------------------------------------------------- against JAX --
@pytest.mark.parametrize("case", CHAIN_CASES, ids=_case_id)
def test_chain_and_frames_match_jax(pair, case):
    """The captured chain (``graphs=True``) from the same x_T (and, for
    Karras's churn, the JAX scan's own draws) against the JAX scan: the
    final images and every frame within 1e-3."""
    jmodel, model = pair
    name, kw = case
    sampler = _use(model, name, **kw)
    shape = (B, IMG, IMG, 3)
    x_T = torch.randn(shape, generator=_gen())
    key = jax.random.PRNGKey(5)
    extra = {}
    if name == "KarrasDiffusion" and kw["s_churn"] > 0:
        extra["noise"] = _jax_churn_noise(key, kw["solver_steps"], shape)
    with torch.inference_mode():
        out, frames = sampler.p_sample_loop(model.get_model_fn(), model.params, shape, None, img=x_T,
                                            graphs=True, return_frames=True, **extra)
    ref_s = _jax_sampler(name, **kw)
    ref, ref_frames = jax.jit(lambda p, img: ref_s.p_sample_loop(jmodel.model_fn, p, shape, key, img=img,
                                                                 return_frames=True))(
        jmodel.params, jnp.asarray(x_T.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)
    np.testing.assert_allclose(frames.numpy(), np.asarray(ref_frames), atol=CHAIN_TOL, rtol=CHAIN_TOL)


def test_guided_conditional_under_dpm_matches_jax():
    """ConditionalDDPM with a label and w = 3 under DPM-Solver++(2M): one 2B
    forward a step in both packages, the same x_T; within 1e-3, and the
    captured chain equals the eager one bit for bit."""
    extra = ["model.num_classes=4"]
    model = _model(ConditionalDDPM, extra)
    jmodel = _jax_of(model, JConditionalDDPM, extra)
    _use(model, "DPMSolverDiffusion", solver_steps=5)
    outs = [model.sample(B, IMG, generator=_gen(), label=2, guidance_scale=3.0, graphs=g) for g in (True, False)]
    assert torch.equal(outs[0], outs[1])
    x_T = torch.randn((B, IMG, IMG, 3), generator=_gen())
    ref_s = _jax_sampler("DPMSolverDiffusion", solver_steps=5, class_conditional=True)
    fn = jmodel._cfg_model_fn(jnp.full((B,), 2, jnp.int32), 3.0)
    ref = jax.jit(lambda p, img: ref_s.p_sample_loop(fn, p, img.shape, jax.random.PRNGKey(0), img=img))(
        jmodel.params, jnp.asarray(x_T.numpy()))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref), atol=CHAIN_TOL, rtol=CHAIN_TOL)


# ------------------------------------------------------ exact relations --
def _const_x0_field(sampler):
    """The JAX tests' ε field whose implied x̂₀ is a fixed image in [-0.5,
    0.5] (integer times, as DPM and UniPC pass them)."""
    acp = sampler.constants.alphas_cumprod
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-0.5, 0.5, (1, IMG, IMG, 1)).astype(np.float32))

    def model_fn(params, x, t):
        a = acp[t.to(torch.long)].reshape(-1, 1, 1, 1)
        return (x - torch.sqrt(a) * x0) / torch.sqrt(1.0 - a)

    return model_fn, x0


def test_unipc_order2_bh2_without_corrector_is_dpm_solver():
    """UniPC(2, bh2, no corrector) == DPM-Solver++(2M) on the same grid
    (atol 1e-6, tests/test_unipc.py)."""
    uni = UniPCDiffusion(T, "cosine", solver_steps=5, solver_order=2, variant="bh2", use_corrector=False,
                         device="cpu")
    dpm = DPMSolverDiffusion(T, "cosine", solver_steps=5, solver_order=2, device="cpu")
    fn, _ = _const_x0_field(uni)
    x_T = torch.randn((2, IMG, IMG, 1), generator=_gen())
    a, b = (s.p_sample_loop(fn, None, x_T.shape, None, img=x_T, graphs=True) for s in (uni, dpm))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def _gaussian_field(acp_ext, m=0.05, s=0.2):
    """The ε field of a Gaussian data distribution N(m, s²) at integer times
    (tests/test_karras.py): x̂₀ stays inside the clip range, so DDIM's and
    Karras's clips are both no-ops."""

    def model_fn(params, x, t):
        a = acp_ext[t.to(torch.long) + 1].reshape(-1, 1, 1, 1)
        sig = torch.sqrt((1.0 - a) / a)
        xhat = x / torch.sqrt(a)
        x0 = (s * s * xhat + sig * sig * m) / (s * s + sig * sig)
        return (xhat - x0) / sig

    return model_fn


def test_karras_euler_on_the_ddim_grid_is_ddim():
    """Karras order 1 on the ``ddim`` grid == DDIM η = 0 from the same
    physical start (Karras takes x̂ = x_t / a), captured (atol 2e-4,
    tests/test_karras.py)."""
    dd = GeneralizedGaussianDiffusion(T, "cosine", eta=0.0, ddim_timesteps=5, device="cpu")
    kd = KarrasDiffusion(T, "cosine", solver_steps=5, solver_order=1, grid="ddim", device="cpu")
    fn = _gaussian_field(dd.alphas_extended_cumprod)
    z = torch.randn((2, IMG, IMG, 1), generator=_gen())
    acp0 = float(dd.alphas_extended_cumprod[int(dd._strided_sequences()[0][0]) + 1])
    a = dd.p_sample_loop(fn, None, z.shape, None, img=z, graphs=True)
    b = kd.p_sample_loop(fn, None, z.shape, None, img=z / float(np.sqrt(acp0)), graphs=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


@pytest.mark.parametrize("sampler", [
    DPMSolverDiffusion(T, "cosine", solver_steps=5, solver_order=2, device="cpu"),
    DPMSolverDiffusion(T, "cosine", solver_steps=8, time_spacing="logsnr", device="cpu"),
    *[UniPCDiffusion(T, "cosine", solver_steps=6, solver_order=o, device="cpu") for o in (1, 2, 3)],
], ids=["dpm2", "dpm2-logsnr", "unipc1", "unipc2", "unipc3"])
def test_solvers_are_exact_on_a_constant_x0_field(sampler):
    """DPM and UniPC (corrector on) land on x̂₀ (atol 1e-4,
    tests/test_unipc.py)."""
    fn, x0 = _const_x0_field(sampler)
    out = sampler.p_sample_loop(fn, None, (2, IMG, IMG, 1), _gen(), unnormalize=False, graphs=True)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(x0.numpy(), out.shape), atol=1e-4)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("churn", [0.0, 1.0])
def test_karras_is_exact_on_a_constant_x0_field(order, churn):
    """A ``pred_x0`` network that returns a fixed x̂₀: Euler and Heun, with
    churn or not, land on it (atol 1e-4)."""
    s = KarrasDiffusion(T, "cosine", objective="pred_x0", solver_steps=5, solver_order=order, s_churn=churn,
                        device="cpu")
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-0.5, 0.5, (1, IMG, IMG, 1)).astype(np.float32))
    out = s.p_sample_loop(lambda p, x, t: x0.expand_as(x), None, (2, IMG, IMG, 1), _gen(), unnormalize=False,
                          graphs=True)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(x0.numpy(), out.shape), atol=1e-4)


def test_karras_passes_off_grid_times_as_float():
    """The Karras grid's conditioning times are off the integer grid; the
    network receives each as float32 [B], equal to the table's (a cast to
    int would truncate them), and ``batched_t`` keeps a float."""
    s = KarrasDiffusion(T, "cosine", solver_steps=5, solver_order=2, s_churn=1.0, device="cpu")
    coefs = s._solver_coefficients()
    assert np.any(coefs["t_hat"] != np.round(coefs["t_hat"]))
    seen = []

    def model_fn(params, x, t):
        seen.append(t.clone())
        return torch.zeros_like(x)

    s.p_sample_loop(model_fn, None, (2, IMG, IMG, 3), _gen(), graphs=False)
    assert all(t.dtype == torch.float32 and t.shape == (2,) for t in seen)
    expect = [v for i in range(4) for v in (coefs["t_hat"][i], coefs["t_next"][i])] + [coefs["t_hat"][4]]
    assert [float(t[0]) for t in seen] == [float(v) for v in expect]
    x = torch.zeros(2, 1)
    assert batched_t(torch.tensor(2.5), x).tolist() == [2.5, 2.5]
    assert batched_t(torch.tensor(3), x).dtype == torch.int32 and batched_t(3, x).tolist() == [3, 3]


# ------------------------------------------------ replays, bit for bit --
@pytest.mark.parametrize("case", [
    ("DPMSolverDiffusion", dict(solver_steps=5)),
    ("UniPCDiffusion", dict(solver_steps=5, solver_order=3)),
    ("KarrasDiffusion", dict(solver_steps=4, s_churn=1.0)),
    ("KarrasDiffusion", dict(solver_steps=4, solver_order=1, s_churn=1.0)),
], ids=_case_id)
def test_replays_equal_the_eager_loop(case):
    """``graphs=True`` (the captured step, its counter and static buffers)
    twice in a row (the second call replays the cached graph) against the
    eager loop: images, frames and generator state bit for bit."""
    model = _model()
    name, kw = case
    _use(model, name, **kw)
    outs = []
    for g in (True, False, True):
        gen = _gen()
        out, frames = model.sample(B, IMG, generator=gen, graphs=g, return_frames=True)
        outs.append((out, frames, gen.get_state()))
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    heun = name == "KarrasDiffusion" and kw.get("solver_order", 2) == 2  # its last Euler step a graph apart
    assert len(model.sampler.graphs) == (2 if heun else 1)


def test_a_new_schedule_captures_anew():
    """The graph is held to the coefficient table: ``compute_constants``
    drops the table and the next chain captures a new graph."""
    model = _model()
    _use(model, "DPMSolverDiffusion", solver_steps=5)
    model.sample(1, IMG, generator=_gen(), graphs=True)
    (first,) = model.sampler.graphs.values()
    model.sampler.compute_constants(T)
    model.sample(1, IMG, generator=_gen(), graphs=True)
    (second,) = model.sampler.graphs.values()
    assert second is not first


# --------------------------------------------------- learned variance --
@pytest.mark.parametrize("name", ["DPMSolverDiffusion", "UniPCDiffusion", "KarrasDiffusion"])
def test_learned_variance_is_refused(name):
    """ImprovedDDPM's [B, H, W, 2C] output: the port raises a ValueError
    that names it; the JAX loop fails on the same output (a reshape
    TypeError). A property of the JAX package the port keeps."""
    model = ImprovedDDPM(load_config(REPO / "examples/configs/improved_ddpm/unet_small.yaml",
                                     overrides=TINY).model, device="cpu", seed=0)
    model.base_sampler = dict(model.cfg.sampler)
    _use(model, name, solver_steps=4)
    with pytest.raises(ValueError, match="learned-variance"):
        model.sample(1, IMG, generator=_gen())
    two_c = lambda p, x, t: jnp.concatenate([x, x], axis=-1)  # noqa: E731
    with pytest.raises(TypeError):
        _jax_sampler(name, solver_steps=4).p_sample_loop(two_c, None, (1, 4, 4, 3), jax.random.PRNGKey(0))
