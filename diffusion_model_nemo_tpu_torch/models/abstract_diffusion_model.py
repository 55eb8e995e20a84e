"""Base model: builds the network and the sampler from the config, owns the
parameters and their EMA copy, sets up the data, hot-swaps samplers, dumps
sample grids, computes bits/dim, and saves and restores ``.dmn`` archives.

Counterpart of ``diffusion_model_nemo_tpu/models/abstract_diffusion_model.py``.
Parameters are ``state_dict``-style dicts of float32 tensors (``params``,
``ema_params``) on the model's device; ``model_fn(params, x, t, classes=None)``
runs the network with the given parameters (inference), ``train_model_fn``
the same with autograd, and ``get_model_fn(batch, training)`` returns one of
them as ``model_fn(params, x, t)`` (a conditional model binds the batch's
labels there, as a ``Conditioned`` model function). Archives hold
the weights as flax parameter trees (``utils/weights.py``), so an archive
either package writes restores in the other. A training step's dropout
masks are injected draws (``draw_dropout_masks``), keyed by site.
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from ..config.registry import get_target, instantiate
from ..config.yaml_config import Config, from_dict, to_yaml
from ..data.hf_vision_data import build_dataloader
from ..loss.variational_bound_loss import compute_variational_loss_terms
from ..modules.gaussian_diffusion import fill_static, graph_key, static_model_fn
from ..ops import graphs as graphs_lib
from ..ops.math import LOG2, mean_flattened, normal_kl, num_to_groups
from ..training import checkpoints as ckpt_lib
from ..utils import hub as hub_lib
from ..utils.image import save_image_grid
from ..utils.weights import from_flax_params, to_flax_params

__all__ = ["AbstractDiffusionModel", "resolve_archive_path"]

log = logging.getLogger(__name__)


def resolve_archive_path(path: str) -> str:
    """``path`` itself, or the archive a local-hub model of that name
    resolves to (``utils/hub.py``), so that every archive-taking entry point
    accepts ``model_path=<hub name>``."""
    if not os.path.exists(str(path)):
        resolved = hub_lib.resolve_model_name(str(path))
        if resolved is not None:
            log.info(f"Resolved hub model {path!r} -> {resolved}")
            return str(resolved)
    return str(path)


class AbstractDiffusionModel:
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.cfg: Config = from_dict(cfg)
        self.device = torch.device(device)
        self.image_size = self.cfg.get("image_size")
        self.timesteps = self.cfg.get("timesteps")
        self.channels = self.cfg.get("channels", 3)
        self.seed = int(seed)
        self.save_and_sample_every = self.cfg.get("save_every", 1000)
        self._result_dir: Optional[Path] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        self._train_dl = None
        self._test_dl = None

    # ---- network plumbing -----------------------------------------------------
    def network_config(self) -> Dict[str, Any]:
        """``cfg.diffusion_model`` as the network is built from it: a wider
        input (``_example_input_channels``) goes in as ``in_channels`` (the
        config keeps the JAX package's keys)."""
        net_cfg = dict(self.cfg.diffusion_model)
        if self._example_input_channels() is not None:
            net_cfg["in_channels"] = self._example_input_channels()
        return net_cfg

    def build_network(self) -> torch.nn.Module:
        """Instantiate ``network_config()`` on the model's device with
        weights drawn from ``seed`` (lecun-normal, like flax's init)."""
        net_cfg = self.network_config()
        target = get_target(str(net_cfg.pop("_target_")))
        net = target(**net_cfg)
        net.reset_parameters(torch.Generator().manual_seed(self.seed))
        net.to(self.device)
        net.eval()
        net.requires_grad_(False)
        return net

    def _example_input_channels(self) -> Optional[int]:
        """Channels of the network's image input where they are not the
        image's (JAX's name): a model that concatenates a condition (SR3's
        2C) says so; None = the network's own ``channels``."""
        return None

    def init_params(self) -> Dict[str, torch.Tensor]:
        """Take the network's weights as ``params`` and copy them to ``ema_params``."""
        self.params = dict(self.diffusion_model.state_dict())
        self.ema_params = {k: v.clone() for k, v in self.params.items()}
        return self.params

    def model_fn(self, params, x: torch.Tensor, t: torch.Tensor,
                 classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The network with ``params`` (inference); ``classes`` [B] int for
        a network built with ``num_classes``."""
        with torch.inference_mode():
            return self.train_model_fn(params, x, t, classes)

    def train_model_fn(self, params, x: torch.Tensor, t: torch.Tensor,
                       classes: Optional[torch.Tensor] = None,
                       dropout_masks: Optional[Dict[str, torch.Tensor]] = None,
                       aug_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``model_fn`` with autograd on: gradients reach ``params``;
        ``dropout_masks`` ({site: keep mask}) turn the network's dropout on;
        ``aug_cond`` is an augmentation descriptor (a network with
        ``aug_dim``)."""
        kwargs = {} if classes is None else {"classes": classes}
        if dropout_masks:
            kwargs["dropout_masks"] = dropout_masks
        if aug_cond is not None:
            kwargs["aug_cond"] = aug_cond
        return functional_call(self.diffusion_model, params, (x, t), kwargs)

    def get_model_fn(self, batch: Optional[Dict] = None, training: bool = False, label_mask=None,
                     dropout_masks: Optional[Dict[str, torch.Tensor]] = None,
                     aug_cond: Optional[torch.Tensor] = None):
        """``model_fn(params, x, t)``: ``train_model_fn`` when ``training``
        (with training's ``dropout_masks`` and augmentation descriptor
        ``aug_cond`` bound), else ``model_fn``. A conditional model binds
        ``batch``'s labels (``label_mask``: training's null-class mask)."""
        if not training:
            return self.model_fn
        bound = {}
        if dropout_masks:
            bound["dropout_masks"] = dropout_masks
        if aug_cond is not None:
            bound["aug_cond"] = aug_cond
        return functools.partial(self.train_model_fn, **bound) if bound else self.train_model_fn

    # ---- dropout's injected masks ---------------------------------------------
    def draw_dropout_masks(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """The keep mask of each dropout site of the network for inputs of
        ``shape`` (``rand < 1 − rate``, bool), keyed ``dropout/<site>`` for
        a step's flat draws; none when the network has no dropout."""
        sites = getattr(self.diffusion_model, "dropout_shapes", lambda _s: {})(tuple(shape))
        if not sites:
            return {}
        keep = 1.0 - float(self.diffusion_model.dropout)
        return {f"dropout/{site}": torch.rand(s, generator=generator, device=self.device) < keep
                for site, s in sites.items()}

    @staticmethod
    def dropout_masks(draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{site: keep mask} from a step's draws (their ``dropout/`` keys)."""
        return {k[len("dropout/"):]: v for k, v in draws.items() if k.startswith("dropout/")}

    def forward(self, x_t: torch.Tensor, t: torch.Tensor, classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.model_fn(self.params, x_t, t, classes)

    # ---- data ------------------------------------------------------------------
    def _setup_dataloader(self, cfg, mode: str):
        """A synthetic set defaults to the model's image size and channels."""
        if cfg is None or cfg.get("name") is None:
            return None
        if str(cfg.get("name", "")).startswith("synthetic"):
            cfg.setdefault("image_size", self.image_size)
            cfg.setdefault("channels", self.channels)
            if self.cfg.get("num_classes") is not None:  # labels inside the class-embedding table
                cfg.setdefault("num_classes", int(self.cfg["num_classes"]))
        return build_dataloader(cfg, mode=mode)

    def setup_training_data(self, train_data_config) -> None:
        cfg = from_dict(train_data_config)
        if "shuffle" in cfg:
            cfg["shuffle"] = True
        self._train_dl = self._setup_dataloader(cfg, mode="train")

    def setup_test_data(self, test_data_config) -> None:
        cfg = from_dict(test_data_config)
        if "shuffle" in cfg:
            cfg["shuffle"] = False
        self._test_dl = self._setup_dataloader(cfg, mode="test")

    # ---- sampler hot-swap -----------------------------------------------------
    def change_sampler(self, sampler_cfg) -> None:
        """Re-instantiate the sampler and persist its config in ``cfg``."""
        sampler_cfg = from_dict(sampler_cfg)
        self.sampler = instantiate(sampler_cfg, device=self.device)
        self.cfg["sampler"] = sampler_cfg
        log.info(f"Sampler changed to :\n{to_yaml(sampler_cfg)}")

    # ---- sample dumps -----------------------------------------------------------
    def _prepare_output_dir(self) -> Path:
        if self._result_dir is None:
            timestamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            self._result_dir = Path(self.cfg.get("results_dir") or f"./results/{timestamp}/").absolute()
            self._result_dir.mkdir(exist_ok=True, parents=True)
        return self._result_dir

    def _save_image_step(self, batch_size: int, step: int):
        """A grid of samples every ``save_every`` steps: ``num_to_groups(4,
        batch_size)`` batches (4 images) with the model's sampler, drawn
        from a generator seeded with ``step`` (the JAX package's
        ``PRNGKey(step)``), saved as ``sample-<milestone>-<i>.png``; returns
        the images as numpy [N, H, W, C] in [0, 1]."""
        out_dir = self._prepare_output_dir()
        milestone = step // max(int(self.save_and_sample_every), 1)
        generator = torch.Generator(device=self.device).manual_seed(int(step))
        all_imgs = []
        for idx, n in enumerate(num_to_groups(4, batch_size)):
            imgs = self.sample(batch_size=n, image_size=self.image_size, generator=generator)
            imgs = imgs.float().cpu().numpy()
            save_path = str(out_dir / f"sample-{milestone}-{idx + 1}.png")
            save_image_grid(imgs, save_path, nrow=6)
            log.info(f"Images saved at path : {save_path}")
            all_imgs.append(imgs)
        return np.concatenate(all_imgs) if all_imgs else None

    # ---- bits/dim ----------------------------------------------------------------
    def calculate_bits_per_dimension(
        self,
        x_start: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        max_batch_size: int = 32,
        noise: Optional[torch.Tensor] = None,
        graphs: Optional[bool] = None,
        model_fn=None,
    ) -> Dict[str, torch.Tensor]:
        """Exact discrete VLB bits/dim: for t = T-1 … 0, q_sample → q_posterior
        → p_mean_variance → the VLB term; the prior KL at the end.

        Each t's noise is drawn from ``generator`` (default seeded 0), or
        taken from ``noise`` [T, B, H, W, C] in the order the loop uses it
        (t descending), as the JAX scan draws it. ``graphs``: replay one
        captured step (default: on CUDA) or run the Python loop; the draws
        are the same. ``model_fn``: default ``get_model_fn()`` (a
        conditional model's test step binds the batch's labels). Returns
        ``total_bpd`` [B], ``terms_bpd`` [B, T] (t ascending) and
        ``prior_bpd`` [B]."""
        if max_batch_size > 0:
            x_start = x_start[: min(max_batch_size, x_start.shape[0])]
        sampler = self.sampler
        model_fn = model_fn or self.get_model_fn()
        T, B = int(sampler.timesteps), x_start.shape[0]
        if noise is not None and tuple(noise.shape) != (T,) + tuple(x_start.shape):
            raise ValueError(f"noise must be [T, *x_start.shape] = {[T, *x_start.shape]}, got {list(noise.shape)}")
        if noise is None and generator is None:
            generator = torch.Generator(device=x_start.device).manual_seed(0)

        def fill(eps: torch.Tensor, i: int) -> torch.Tensor:
            """Step i's noise (t = T-1-i) into ``eps``."""
            if noise is not None:
                return eps.copy_(noise[i])
            return eps.normal_(generator=generator)

        with torch.inference_mode():
            if graphs_lib.use_graphs(graphs, x_start.device):
                terms = self._bpd_replays(model_fn, x_start, T, fill)
            else:
                terms = torch.empty((T, B), dtype=torch.float32, device=x_start.device)
                eps = torch.empty_like(x_start)
                for i, t in enumerate(range(T - 1, -1, -1)):
                    terms[t] = self._bpd_term(model_fn, self.params, x_start, t, fill(eps, i))
            terms_bpd = terms.T
            qt_mean, _, qt_log_var = sampler.q_mean_variance(x_start, T - 1)
            prior_bpd = mean_flattened(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / LOG2
            return {
                "total_bpd": terms_bpd.sum(dim=1) + prior_bpd,
                "terms_bpd": terms_bpd,
                "prior_bpd": prior_bpd,
            }

    def _bpd_term(self, model_fn, params, x_start, t, eps) -> torch.Tensor:
        """The VLB term [B] in bits at ``t`` (a Python int, or a 0-d device
        tensor in the captured step) with the step's noise ``eps``."""
        sampler = self.sampler
        x_t = sampler.q_sample(x_start, t, eps)
        true_mean, true_log_var = sampler.q_posterior(x_start=x_start, x=x_t, t=t)
        out = sampler.p_mean_variance(model_fn, params, x=x_t, t=t)
        term, _ = compute_variational_loss_terms(
            samples=x_start,
            model_mean=out.mean,
            model_log_variance=torch.broadcast_to(out.log_variance, out.mean.shape),
            true_mean=true_mean,
            true_log_variance_clipped=true_log_var,
            t=t,
        )
        return term

    def _bpd_replays(self, model_fn, x_start, T: int, fill) -> torch.Tensor:
        """The T terms through one captured ``_bpd_term`` step (static x_start
        and noise, a 0-d device t that the step decrements, the term written
        into a static [T, B] at row t); step i's noise is filled in before
        it. The first step (t = T-1) runs eagerly (the capture's warm-up).
        Returns the terms [T, B] (a copy)."""
        params = self.params
        static = None

        def build():
            nonlocal static
            dev = x_start.device
            static = {"x": x_start.clone(), "eps": torch.empty_like(x_start),
                      "t": torch.full((), T - 1, dtype=torch.long, device=dev),
                      "terms": torch.zeros((T, x_start.shape[0]), dtype=torch.float32, device=dev)}
            fn = static_model_fn(model_fn, static)

            def step():
                t = static["t"]
                term = self._bpd_term(fn, params, static["x"], t, static["eps"])
                static["terms"].index_copy_(0, t.reshape(1), term.reshape(1, -1))
                t.sub_(1)

            def warmup():
                fill(static["eps"], 0)
                step()

            return graphs_lib.Graph("bpd", step, static, device=dev, warmup=warmup)

        key = ("bpd", T, tuple(x_start.shape), x_start.dtype, x_start.device, *graph_key(model_fn))
        graph, built = graphs_lib.cached(self.sampler.graphs, key,
                                         (*(params or {}).values(), *self.sampler.table_tensors()), build)
        static = graph.static
        if not built:
            static["x"].copy_(x_start)
            static["t"].fill_(T - 1)
            fill_static(model_fn, static)
        for i in range(1 if built else 0, T):
            fill(static["eps"], i)
            graph.replay()
        return static["terms"].clone()

    # ---- persistence -------------------------------------------------------------
    def _load_flax(self, params, ema, use_ema: bool = False) -> None:
        """Set ``params`` / ``ema_params`` from flax trees (``ema`` may be
        None: the EMA starts as a copy); ``use_ema`` serves the EMA."""
        net = self.diffusion_model
        p = {k: v.to(self.device) for k, v in from_flax_params(params, net).items()}
        e = None if ema is None else {k: v.to(self.device) for k, v in from_flax_params(ema, net).items()}
        self.params = e if (use_ema and e is not None) else p
        fresh = e is None or self.params is e
        self.ema_params = {k: v.clone() for k, v in self.params.items()} if fresh else e

    def save_to(self, path: str) -> str:
        """Single-file export: config + weights + EMA, and ``extra.yaml``
        naming the model class (what generic restores dispatch on)."""
        net = self.diffusion_model
        ema = None if self.ema_params is None else to_flax_params(self.ema_params, net)
        return ckpt_lib.save_archive(path, self.cfg, to_flax_params(self.params, net), ema,
                                     extra={"model_class": type(self).__name__})

    @classmethod
    def restore_from(cls, path: str, use_ema: bool = False, device: Union[str, torch.device] = "cuda"):
        """The model of an archive (or of a local-hub model name)."""
        path = resolve_archive_path(path)
        cfg, params, ema, _ = ckpt_lib.load_archive(path)
        model = cls(cfg=cfg, device=device)
        model._load_flax(params, ema, use_ema)
        log.info(f"Model restored from : {path}")
        return model

    def maybe_init_from_pretrained_checkpoint(self, cfg) -> None:
        """Warm-start the weights from another archive if the config names
        one (``+init_from_nemo_model=`` / ``+init_from_model=``)."""
        cfg = from_dict(cfg)
        src = cfg.get("init_from_nemo_model") or cfg.get("init_from_model")
        if src:
            _, params, ema, _ = ckpt_lib.load_archive(resolve_archive_path(src))
            self._load_flax(params, ema)
            log.info(f"Model weights warm-started from : {src}")

    @classmethod
    def from_pretrained(cls, model_name: str, use_ema: bool = False, device: Union[str, torch.device] = "cuda"):
        """An existing path, else a model installed in the local hub; an
        unknown name raises, listing what is installed."""
        if os.path.exists(str(model_name)) or hub_lib.resolve_model_name(str(model_name)) is not None:
            return cls.restore_from(str(model_name), use_ema=use_ema, device=device)
        available = [m.pretrained_model_name for m in hub_lib.list_hub_models()]
        raise FileNotFoundError(
            f"{cls.__name__}.from_pretrained({model_name!r}): not a path and not installed in the "
            f"local hub {hub_lib.hub_dir()} (installed: {available or 'none'}). Publish with "
            "model.publish_to_hub(name) or copy a .dmn archive into the hub directory."
        )

    def publish_to_hub(self, model_name: str) -> str:
        """Save this model into the local hub under ``model_name``."""
        with tempfile.TemporaryDirectory() as td:
            tmp = os.path.join(td, f"{model_name}.dmn")
            self.save_to(tmp)
            return str(hub_lib.publish_archive(tmp, model_name))

    @classmethod
    def list_available_models(cls):
        """Models installed in the local hub (None when there are none)."""
        return hub_lib.list_hub_models() or None
