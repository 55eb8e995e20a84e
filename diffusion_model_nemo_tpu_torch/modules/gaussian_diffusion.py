"""DDPM process: forward noising, posterior, ancestral sampling.

Counterpart of ``diffusion_model_nemo_tpu/modules/gaussian_diffusion.py``:
the same constant table and formulas (``pred_noise`` / ``pred_x0`` /
``pred_v``, x̂₀ clamped to [-1, 1], zero noise at t = 0). The JAX package's
reverse chain is one ``lax.scan`` over a flat [B, H·W·C] carry; here, on
CUDA, t = T−1 … 1 are replays of one captured ``ancestral_step``
(``ops/graphs.py``) with the noise drawn before each replay in the eager
loop's order, and t = 0 (no draw) runs eagerly; ``graphs=False`` (and the
CPU) runs the Python loop over image-shaped tensors. ``return_frames``
writes each step's frame into one device buffer behind the step;
``interpolate`` lerps two noised endpoints and runs the chain's last t
steps. A conditional model's
network comes in as a :class:`Conditioned` model function: a captured chain
holds its class labels (and the guidance scale, a 0-d tensor) as static
buffers, filled before every chain.

``zero_terminal_snr`` rescales the schedule so that ᾱ_T = 0 and needs a
``pred_v`` or ``pred_x0`` objective, as in the JAX package; ``v_target``,
``predict_noise_from_v`` and the objective-aware ``min_snr_weight`` (Min-SNR-γ)
serve the training step.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..config.registry import register_target
from ..ops import graphs as graphs_lib
from ..ops.schedules import extract
from .diffusion_process import AbstractDiffusionProcess, ModelFn

__all__ = ["Conditioned", "GaussianDiffusion", "PMeanVariance", "batched_t", "graph_key", "static_model_fn",
           "fill_static", "new_frames", "put_frame"]


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: Optional[torch.Tensor]
    log_variance: torch.Tensor
    pred_x_start: torch.Tensor


def batched_t(t, x: torch.Tensor) -> torch.Tensor:
    """The network's time input [B]; the process math takes a Python int
    (the sampling loops), a 0-d tensor (broadcast on its device, no host
    sync: int32, or float32 for a floating one, as JAX's ``batched_t`` keeps
    the solvers' float times, the Karras grid's off the integers) or a [B]
    tensor."""
    if torch.is_tensor(t):
        if t.ndim > 0:
            return t
        dtype = torch.float32 if t.is_floating_point() else torch.int32
        return t.to(device=x.device, dtype=dtype).expand(x.shape[0])
    return torch.full((x.shape[0],), int(t), dtype=torch.int32, device=x.device)


class Conditioned:
    """``fn(params, x, t, **tensors)`` as a ``model_fn(params, x, t)``: a
    conditional network with its tensors bound (the class labels, and a
    guided one's scale as a float32 0-d tensor). A captured chain keys on
    ``fn`` and the tensors' shapes, and holds the tensors as static buffers
    that every chain refills (``static_model_fn``, ``fill_static``), so one
    guided graph serves every scale: a closure over the labels would key it
    on an id that Python reuses once the closure is freed, and replay
    another request's labels."""

    def __init__(self, fn, tensors: Dict[str, torch.Tensor]):
        self.fn, self.tensors = fn, dict(tensors)

    def __call__(self, params, x, t):
        return self.fn(params, x, t, **self.tensors)

    def key(self) -> tuple:
        return (*graph_key(self.fn), tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(self.tensors.items())))


def graph_key(model_fn) -> tuple:
    """The network function in a sampling graph's key: a bound method as
    its object's identity and its function (the sampler's ``graphs`` then
    holds no reference to the model); a :class:`Conditioned` one adds its
    tensors' shapes, never their values."""
    if isinstance(model_fn, Conditioned):
        return model_fn.key()
    return id(getattr(model_fn, "__self__", model_fn)), getattr(model_fn, "__func__", None)


def static_model_fn(model_fn, static: Dict[str, Any]):
    """The model function a captured step calls: a :class:`Conditioned` one
    reads its tensors from buffers it makes in ``static["cond"]``."""
    if not isinstance(model_fn, Conditioned):
        return model_fn
    static["cond"] = {k: v.clone() for k, v in model_fn.tensors.items()}
    return Conditioned(model_fn.fn, static["cond"])


def fill_static(model_fn, static: Dict[str, Any]) -> None:
    """Copy a :class:`Conditioned` model function's tensors into the static
    buffers of a graph built by ``static_model_fn`` (before a chain)."""
    if isinstance(model_fn, Conditioned):
        for k, v in model_fn.tensors.items():
            static["cond"][k].copy_(v)


def _randn(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def new_frames(n: int, x: torch.Tensor) -> torch.Tensor:
    """The trajectory buffer [n, *x.shape] on x's device (a T = 1000 chain
    at B = 64, 32 px is 786 MB)."""
    return torch.empty((n, *x.shape), dtype=torch.float32, device=x.device)


def put_frame(frames: Optional[torch.Tensor], i: int, x: torch.Tensor) -> None:
    """Step i's frame (x + 1) / 2 into ``frames`` (if any), as the JAX scan
    emits it: enqueued behind the step, no host sync."""
    if frames is not None:
        torch.mul(x + 1.0, 0.5, out=frames[i])


@register_target("diffusion_model_nemo.modules.GaussianDiffusion")
class GaussianDiffusion(AbstractDiffusionProcess):
    def __init__(
        self,
        timesteps: int,
        schedule_name: str,
        schedule_cfg: Optional[Dict[str, Any]] = None,
        objective: str = "pred_noise",
        class_conditional: bool = False,
        zero_terminal_snr: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__(timesteps, schedule_name, schedule_cfg, device)
        if objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"objective must be pred_noise|pred_x0|pred_v, got {objective}")
        if zero_terminal_snr and objective == "pred_noise":
            # At SNR 0 the input is pure noise and ε is unidentifiable.
            raise ValueError(
                "zero_terminal_snr requires objective pred_v or pred_x0 "
                "(epsilon is unidentifiable at the terminal SNR-0 step)"
            )
        self.objective = objective
        self.use_class_conditioning = bool(class_conditional)
        self.zero_terminal_snr = bool(zero_terminal_snr)
        self.compute_constants(timesteps)
        self.graphs: dict = {}  # the captured sampling steps (ops/graphs.py), keyed like _jitted

    # ---- q space -------------------------------------------------------------
    def q_mean_variance(self, x_start, t):
        """Marginal q(x_t | x_0): (mean, variance, log variance)."""
        c = self.constants
        mean = x_start * extract(c.sqrt_alphas_cumprod, t, x_start.ndim)
        variance = extract(1.0 - c.alphas_cumprod, t, x_start.ndim)
        return mean, variance, extract(c.log_one_minus_alphas_cumprod, t, x_start.ndim)

    def q_posterior(self, x_start, x, t):
        c = self.constants
        mean = extract(c.posterior_mean_coef1, t, x.ndim) * x_start + extract(
            c.posterior_mean_coef2, t, x.ndim
        ) * x
        return mean, extract(c.posterior_log_variance_clipped, t, x.ndim)

    def q_sample(self, x_start, t, noise):
        """x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε; ``noise`` is the caller's."""
        c = self.constants
        return (
            extract(c.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + extract(c.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise
        )

    def predict_start_from_noise(self, x_t, t, noise):
        c = self.constants
        return (
            extract(c.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(c.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise
        )

    # ---- v-parameterization: v = √ᾱ_t·ε − √(1−ᾱ_t)·x₀ -------------------------
    def v_target(self, x_start, t, noise):
        """The training target v of an (x₀, t, ε) triple."""
        c = self.constants
        return (
            extract(c.sqrt_alphas_cumprod, t, x_start.ndim) * noise
            - extract(c.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * x_start
        )

    def predict_start_from_v(self, x_t, t, v):
        c = self.constants
        return (
            extract(c.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(c.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v
        )

    def predict_noise_from_v(self, x_t, t, v):
        """ε̂ = √(1−ᾱ_t)·x_t + √ᾱ_t·v̂."""
        c = self.constants
        return (
            extract(c.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * x_t
            + extract(c.sqrt_alphas_cumprod, t, x_t.ndim) * v
        )

    def min_snr_weight(self, t, gamma: float) -> torch.Tensor:
        """The per-example Min-SNR-γ weight [B] (Hang et al. 2023) of the
        loss as regressed: min(SNR, γ)/SNR for ε, min(SNR, γ) for x₀,
        min(SNR, γ)/(SNR + 1) for v; float32 on the table, as in JAX."""
        acp = self.constants.alphas_cumprod
        snr = acp / torch.clamp(1.0 - acp, min=1e-20)
        w = torch.clamp(snr, max=float(gamma))
        if self.objective == "pred_noise":
            w = w / snr
        elif self.objective == "pred_v":
            w = w / (snr + 1.0)
        return extract(w, t, 1)

    # ---- p space -------------------------------------------------------------
    def p_mean_variance(
        self, model_fn: Optional[ModelFn], params: Any, x, t, model_output=None
    ) -> PMeanVariance:
        """Reverse-step Gaussian with the clipped posterior log-variance."""
        if model_output is None:
            model_output = model_fn(params, x, batched_t(t, x))
        if self.objective == "pred_noise":
            x_recon = self.predict_start_from_noise(x, t, model_output)
        elif self.objective == "pred_v":
            x_recon = self.predict_start_from_v(x, t, model_output)
        else:
            x_recon = model_output
        x_recon = x_recon.clamp(-1.0, 1.0)
        mean, log_variance = self.q_posterior(x_recon, x, t)
        return PMeanVariance(mean, None, log_variance, x_recon)

    def p_sample(self, model_fn, params, x, t, generator=None, noise=None):
        """One ancestral step; no noise where t = 0. ``t`` is a Python int
        (the sampling loops: no tensor, no host sync, no draw at t = 0) or a
        0-d or [B] tensor, masked per sample as the JAX package does.
        ``noise`` may be injected (tests feed both packages the same draws)."""
        if not torch.is_tensor(t):
            if int(t) == 0:
                return self.p_mean_variance(model_fn, params, x, t).mean
            if noise is None:
                noise = _randn(x.shape, generator, x.device)
            return self.ancestral_step(model_fn, params, x, t, noise)
        out = self.p_mean_variance(model_fn, params, x, t)
        if noise is None:
            noise = _randn(x.shape, generator, x.device)
        step = torch.exp(0.5 * out.log_variance) * noise
        mask = (t.to(x.device) != 0).to(step.dtype)
        step = step * (mask.reshape(-1, *((1,) * (x.ndim - 1))) if t.ndim else mask)
        return out.mean + step

    def ancestral_step(self, model_fn, params, x, t, noise):
        """One ancestral step at t > 0 with the caller's ``noise``: μ_θ(x, t)
        + σ_t·noise. ``t`` is a Python int (``p_sample``) or a 0-d device
        tensor (the captured step of ``p_sample_loop``): the same arithmetic."""
        out = self.p_mean_variance(model_fn, params, x, t)
        return out.mean + torch.exp(0.5 * out.log_variance) * noise

    def p_sample_loop(
        self,
        model_fn: ModelFn,
        params: Any,
        shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        img: Optional[torch.Tensor] = None,
        num_steps: Optional[int] = None,
        unnormalize: bool = True,
        graphs: Optional[bool] = None,
        return_frames: bool = False,
    ):
        """Reverse chain over t = T−1 … 0 (or the last ``num_steps`` steps;
        0 returns ``img``) from ``img`` (default N(0, I) from ``generator``).
        ``graphs``: replay a captured step (default: on CUDA) or run the
        Python loop; both draw the same numbers from ``generator`` in the
        same order. ``return_frames``: also return the trajectory [T, B, H,
        W, C] in [0, 1] (one device buffer, each step's frame written after
        it, no host sync), as ``(out, frames)``."""
        T = self.timesteps if num_steps is None else int(num_steps)
        x = img if img is not None else _randn(shape, generator, self.device)
        frames = new_frames(T, x) if return_frames else None
        if T > 0 and graphs_lib.use_graphs(graphs, x.device):
            x = self._ancestral_replays(model_fn, params, x, T, generator, frames)
        else:
            for i, t in enumerate(range(T - 1, -1, -1)):
                x = self.p_sample(model_fn, params, x, t, generator)
                put_frame(frames, i, x)
        out = (x + 1.0) * 0.5 if unnormalize else x
        return (out, frames) if return_frames else out

    def _ancestral_replays(self, model_fn, params, x, T: int, generator, frames=None) -> torch.Tensor:
        """t = T−1 … 1 through one captured ``ancestral_step`` (static x and
        noise, a 0-d device t that the step decrements; the noise is drawn
        into its buffer before each step, so the draws are the eager loop's),
        then t = 0 eagerly (no draw). ``frames``: each step's frame is
        written after it, outside the graph."""
        if T > 1:
            static = None

            def build():
                nonlocal static
                static = {"x": x.clone(), "noise": torch.empty_like(x),
                          "t": torch.full((), T - 1, dtype=torch.long, device=x.device)}
                fn = static_model_fn(model_fn, static)

                def step():
                    static["x"].copy_(self.ancestral_step(fn, params, static["x"], static["t"], static["noise"]))
                    static["t"].sub_(1)

                def warmup():  # the chain's first step
                    static["noise"].normal_(generator=generator)
                    step()

                return graphs_lib.Graph("ancestral", step, static, device=x.device, warmup=warmup)

            # Keyed on the schedule's length, not the chain's: the step is the
            # same for any chain length (a partial chain sets the device t), so
            # every SDEdit strength and interpolation t replays one graph,
            # while a schedule of another length (WaveGrad's searched one)
            # keeps a graph of its own beside it.
            key = ("ancestral", self.timesteps, tuple(x.shape), x.dtype, x.device, *graph_key(model_fn))
            graph, built = graphs_lib.cached(self.graphs, key, (*(params or {}).values(), *self.table_tensors()),
                                             build)
            static = graph.static
            if built:
                put_frame(frames, 0, static["x"])
            else:
                static["x"].copy_(x)
                static["t"].fill_(T - 1)
                fill_static(model_fn, static)
            for i in range(int(built), T - 1):
                static["noise"].normal_(generator=generator)
                graph.replay()
                put_frame(frames, i, static["x"])
            x = static["x"]
        x = self.p_sample(model_fn, params, x, 0, generator)
        put_frame(frames, T - 1, x)
        return x

    def interpolate(self, model_fn, params, x1: torch.Tensor, x2: torch.Tensor,
                    generator: Optional[torch.Generator] = None, t: Optional[int] = None, lambd: float = 0.5,
                    return_frames: bool = False, graphs: Optional[bool] = None):
        """Noise both endpoints to step ``t`` (default T−1) with two draws
        from ``generator`` (x1's, then x2's), lerp in q space, then run the
        last ``t`` steps of the ancestral chain (JAX
        ``gaussian_diffusion.py:interpolate``, which denoises from t − 1)."""
        t = self.timesteps - 1 if t is None else int(t)
        if t >= self.timesteps:
            raise ValueError(f"`t` must be < {self.timesteps} during interpolation")
        if x1.shape != x2.shape:
            raise ValueError(f"x1 and x2 differ in shape: {list(x1.shape)} and {list(x2.shape)}")
        t_b = torch.full((x1.shape[0],), t, dtype=torch.int32, device=x1.device)
        xt1 = self.q_sample(x1, t_b, _randn(x1.shape, generator, x1.device))
        xt2 = self.q_sample(x2, t_b, _randn(x2.shape, generator, x2.device))
        img = (1.0 - lambd) * xt1 + lambd * xt2
        return self.p_sample_loop(model_fn, params, tuple(x1.shape), generator, img=img, num_steps=t,
                                  graphs=graphs, return_frames=return_frames)

    def sample(self, model_fn, params, shape, generator=None, **kwargs):
        return self.p_sample_loop(model_fn, params, shape, generator, **kwargs)
