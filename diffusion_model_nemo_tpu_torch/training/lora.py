"""LoRA fine-tuning (Hu et al. 2021) of a trained model with its base frozen.

Counterpart of ``diffusion_model_nemo_tpu/training/lora.py``. The adapters
are ``{flax path: {"a": A, "b": B}}`` keyed by the JAX package's
'/'-joined kernel paths (``down_0_block1/block1/proj/kernel``), A
[fan_in, r] and B [r, cout] in flax's kernel layout (fan_in = the product of
the HWIO shape but the last), so adapter files move between the packages.
ΔW = (α/r)·reshape(A·B) is formed in the flax kernel's layout and taken to
the port's by the carrier's rule for that leaf (``utils/weights.py:
kernel_to_torch``: conv HWIO → OIHW, ``Conv1x1`` [1, 1, C, F] → [F, C],
the transposed conv flipped → IOHW, Dense transposed).

``LoRAFinetuner`` trains the adapters through the model family's own
``training_step`` on the merged weights W + ΔW, formed inside the step:
the base parameters are read, never written, and get no gradient; the
gradients reach A and B through the merged weights, the kernels' among them
(``ops/recompute.py``'s plain recomputes differentiate their weight inputs,
leaves or not). The update is optax's ``clip_by_global_norm`` then AdamW
(its default betas and eps, ``weight_decay`` as given) or SGD, over the
adapters only (``optim.py``). On CUDA a step is one captured graph, as the
Trainer's: the batch, the draws and the optimizer's row are static buffers
refilled every step, and the wrappers' derived weights (prenorm folds,
casts, fragment orders) of the merged weights are derived inside the
graph; the graph is held to the base, the adapters and the moments, so a new
base or new adapters capture anew. The draws are injected (``finetune``'s
``draws``) or drawn from a ``torch.Generator`` (the JAX package draws them
from a key: the streams differ).

``merged_model`` bakes ΔW into a same-family model (weights and EMA), which
samples, serves and archives through every stock path.
"""

from __future__ import annotations

import copy
import logging
import math
import re
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config.yaml_config import from_dict
from ..modules.parts import Conv1d, Conv2d, ConvTranspose2d, Dense, not_ported
from ..ops import graphs as graphs_lib
from ..utils.weights import kernel_to_flax, kernel_to_torch
from .optim import Optimizer, clip_by_global_norm
from .step_graph import OptimizerRows, adamw, replayed

__all__ = ["lora_init", "merge_adapters", "adapter_param_count", "save_adapters", "load_adapters",
           "LoRAFinetuner"]

log = logging.getLogger(__name__)

_SEP = "/"
_KERNEL_OWNERS = (Conv2d, Conv1d, ConvTranspose2d, Dense)  # Conv1x1 is a Dense

Adapters = Dict[str, Dict[str, torch.Tensor]]


def _flax_shape(owner: torch.nn.Module, w: torch.Tensor) -> Tuple[int, ...]:
    """The flax kernel shape of ``owner``'s weight ``w`` (no data moved)."""
    return tuple(kernel_to_flax(owner, torch.empty(w.shape, device="meta")).shape)


def _walk_kernels(params: Dict[str, torch.Tensor], network: torch.nn.Module) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """(flax path, ``state_dict`` key, flax kernel shape) of every
    matmul-shaped ``kernel`` leaf of ``network``'s flax tree (the weights of
    its convolutions and Dense layers; the MoE's stacked experts are no
    ``kernel``), sorted as the JAX ``_walk_kernels`` visits the tree."""
    out = []
    for key, w in params.items():
        *mod_path, leaf = key.split(".")
        if leaf != "weight":
            continue
        owner = network.get_submodule(".".join(mod_path))
        if isinstance(owner, _KERNEL_OWNERS):
            shape = _flax_shape(owner, w)
            if len(shape) >= 2:
                out.append((_SEP.join(mod_path + ["kernel"]), key, shape))
    return sorted(out, key=lambda e: e[0].split(_SEP))


def lora_init(params: Dict[str, torch.Tensor], network: torch.nn.Module, rank: int,
              generator: Optional[torch.Generator] = None, targets: str = ".*",
              dtype: torch.dtype = torch.float32) -> Adapters:
    """Zero-effect adapters ``{path: {"a", "b"}}`` for every kernel whose
    flax path matches the ``targets`` regex (searched): r = min(rank,
    fan_in, cout), A ~ N(0, 1)/√fan_in (drawn on the CPU from
    ``generator``, default seeded 0, in path order), B = 0, on the
    parameters' device. ΔW = 0 at step 0: the fine-tune starts at the base
    model exactly."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    pat = re.compile(targets)
    kernels = [(p, k, s) for p, k, s in _walk_kernels(params, network) if pat.search(p)]
    if not kernels:
        raise ValueError(f"no kernels match targets={targets!r}")
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    adapters: Adapters = {}
    for path, key, shape in kernels:
        fan_in, cout = int(np.prod(shape[:-1])), int(shape[-1])
        r = min(int(rank), fan_in, cout)
        device = params[key].device
        a = torch.randn((fan_in, r), generator=generator, dtype=torch.float32) / math.sqrt(fan_in)
        adapters[path] = {"a": a.to(device=device, dtype=dtype),
                          "b": torch.zeros((r, cout), dtype=dtype, device=device)}
    return adapters


def _owner_key(network: torch.nn.Module, path: str) -> Tuple[torch.nn.Module, str]:
    mod_path = path.split(_SEP)[:-1]
    return network.get_submodule(".".join(mod_path)), ".".join(mod_path + ["weight"])


def merge_adapters(params: Dict[str, torch.Tensor], adapters: Adapters, scale: float,
                   network: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A new parameter dict: W + scale·ΔW for every adapted kernel (ΔW =
    reshape(A·B) in the flax layout, then the leaf's layout), every other
    entry the same tensor. Differentiable in A and B."""
    merged = dict(params)
    for path, ab in adapters.items():
        owner, key = _owner_key(network, path)
        w = params[key]
        delta = (ab["a"] @ ab["b"]).reshape(_flax_shape(owner, w)).to(w.dtype)
        merged[key] = w + scale * kernel_to_torch(owner, delta).contiguous()
    return merged


def adapter_param_count(adapters: Adapters) -> int:
    return sum(int(v.numel()) for ab in adapters.values() for v in ab.values())


def save_adapters(path: str, adapters: Adapters, rank: int, alpha: float, targets: str) -> str:
    """Adapters and their metadata as one ``.npz`` (the JAX package's
    format: ``<path>::a`` / ``::b`` arrays, ``__lora_meta__`` [rank, alpha]
    float64, ``__lora_targets__``)."""
    flat = {}
    for p, ab in adapters.items():
        flat[f"{p}::a"] = ab["a"].detach().float().cpu().numpy()
        flat[f"{p}::b"] = ab["b"].detach().float().cpu().numpy()
    np.savez(path, __lora_meta__=np.array([rank, alpha], np.float64), __lora_targets__=np.array(targets), **flat)
    return path


def load_adapters(path: str) -> Tuple[Adapters, int, float, str]:
    """(adapters as float32 CPU tensors, rank, alpha, targets) from a file
    either package wrote."""
    with np.load(path, allow_pickle=False) as z:
        rank, alpha = z["__lora_meta__"]
        targets = str(z["__lora_targets__"])
        adapters: Adapters = {}
        for k in z.files:
            if k.startswith("__lora_"):
                continue
            p, which = k.rsplit("::", 1)
            adapters.setdefault(p, {})[which] = torch.from_numpy(np.array(z[k], dtype=np.float32))
    return adapters, int(rank), float(alpha), targets


def _flatten(adapters: Adapters) -> Dict[str, torch.Tensor]:
    return {f"{p}::{w}": ab[w] for p, ab in adapters.items() for w in ("a", "b")}


class LoRAFinetuner:
    """Trains LoRA adapters on a frozen model through its ``training_step``
    (any family whose step is ``training_step(params, batch, draws)``).

    ``rank`` / ``alpha``: the adapter rank and the scaling α/r of ΔW (α
    defaults to the rank, scale 1); ``targets``: a regex over the flax
    kernel paths; ``optimizer``: "adamw" or "sgd"; ``generator``: A's
    draws (default seeded 0). ``adapters`` may be set to other ones
    (``load_adapters``'s, say), as in the JAX package: ``finetune`` starts
    from whatever it holds. ``mesh=`` is not ported."""

    def __init__(self, model, rank: int = 8, alpha: Optional[float] = None, targets: str = ".*",
                 learning_rate: float = 1e-4, weight_decay: float = 0.0, grad_clip: float = 1.0,
                 optimizer: str = "adamw", mesh=None, generator: Optional[torch.Generator] = None):
        if mesh is not None:
            raise not_ported("LoRAFinetuner", "mesh=", "parallelism")
        self.model = model
        self.rank = int(rank)
        self.alpha = float(alpha if alpha is not None else rank)
        self.scale = self.alpha / self.rank
        self.targets = targets
        self.adapters = lora_init(model.params, model.diffusion_model, self.rank, generator, targets)
        if optimizer == "adamw":
            self.optimizer = adamw(learning_rate, weight_decay)
        elif optimizer == "sgd":
            lr = float(learning_rate)
            self.optimizer = Optimizer("sgd", lambda _count: lr)
        else:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.grad_clip = float(grad_clip)
        self.opt_state: Dict = {}
        self.graphs: dict = {}  # the captured step (ops/graphs.py)
        self._rows = OptimizerRows(self.optimizer, model.device)
        n_base = sum(int(p.numel()) for p in model.params.values())
        n_ad = adapter_param_count(self.adapters)
        log.info(f"LoRA r={self.rank} α={self.alpha}: {len(self.adapters)} kernels, {n_ad:,} trainable params "
                 f"({100.0 * n_ad / n_base:.2f}% of base)")

    # ---- the step ---------------------------------------------------------------
    def _step(self, batch, draws, scalars: torch.Tensor) -> torch.Tensor:
        """The step, device work only (the captured function): merge, the
        family's loss, the adapters' gradients, the clip and the update in
        place. Returns the loss."""
        model = self.model
        flat = _flatten(self.adapters)
        merged = merge_adapters(model.params, self.adapters, self.scale, model.diffusion_model)
        loss, _metrics = model.training_step(merged, batch, draws)
        keys = list(flat)
        grads = dict(zip(keys, torch.autograd.grad(loss, [flat[k] for k in keys])))
        with torch.no_grad():
            grads = clip_by_global_norm(grads, self.grad_clip)
            self.optimizer.step(flat, grads, self.opt_state, scalars=scalars)
        return loss.detach()

    def train_step(self, batch, draws: Dict[str, torch.Tensor], graphs: Optional[bool] = None) -> torch.Tensor:
        """One adapter update on a raw batch with the step's draws (the
        family's ``draw_training_inputs``). ``graphs``: replay the captured
        step (default: on CUDA; the first call runs eagerly and captures) or
        run it eagerly. Returns the loss (a device tensor)."""
        scalars = self._rows[self.opt_state["count"]]
        with torch.inference_mode(False):
            if graphs_lib.use_graphs(graphs, self.model.device):
                loss = self._replayed(batch, draws, scalars)
            else:
                loss = self._step(batch, draws, scalars)
        self.opt_state["count"] += 1
        return loss

    def _replayed(self, batch, draws, scalars) -> torch.Tensor:
        model = self.model
        writes = [*_flatten(self.adapters).values(),
                  *(v for d in self.opt_state.values() if isinstance(d, dict) for v in d.values())]
        tables = getattr(model.sampler, "table_tensors", tuple)()
        frozen = getattr(model, "frozen_tensors", tuple)()
        out = replayed(self.graphs, "lora_step", batch, {**draws, "opt": scalars},
                       lambda b, i: self._step(b, {k: i[k] for k in draws}, i["opt"]), model.device, writes,
                       [*model.params.values(), *tables, *frozen])
        return out.clone()

    def finetune(self, batches: Iterator, steps: int, generator: Optional[torch.Generator] = None,
                 log_every: int = 50, draws: Optional[Iterable[Dict[str, torch.Tensor]]] = None,
                 graphs: Optional[bool] = None) -> List[float]:
        """``steps`` adapter updates, a batch from ``batches`` each and its
        draws from ``generator`` (default seeded 0 on the model's device) or
        the next of ``draws``; returns the losses logged every ``log_every``
        steps and at the last. Each call starts a fresh optimizer state from
        the current adapters (trainable copies of them on the model's
        device), as the JAX package's does."""
        model = self.model
        self.adapters = {p: {w: torch.as_tensor(t).detach().to(model.device, torch.float32).clone()
                             .requires_grad_(True) for w, t in ab.items()} for p, ab in self.adapters.items()}
        self.opt_state = self.optimizer.init(_flatten(self.adapters))  # fresh each call, as the JAX finetune's
        injected = iter(draws) if draws is not None else None
        if injected is None and generator is None:
            generator = torch.Generator(device=model.device).manual_seed(0)
        losses: List[float] = []
        for i in range(int(steps)):
            batch = next(batches)
            d = next(injected) if injected is not None else model.draw_training_inputs(
                np.shape(batch["image"]), generator)
            d = {k: v.to(model.device) for k, v in d.items()}
            loss = self.train_step(batch, d, graphs)
            if log_every and (i % log_every == 0 or i == steps - 1):
                losses.append(float(loss))
                log.info(f"[lora] step {i}: loss {losses[-1]:.5f}")
        return losses

    # ---- packaging ----------------------------------------------------------------
    def merged_params(self) -> Dict[str, torch.Tensor]:
        """The base parameters with ΔW baked in (new tensors where adapted)."""
        with torch.no_grad():
            merged = merge_adapters(self.model.params, self.adapters, self.scale, self.model.diffusion_model)
        return {k: v.detach() for k, v in merged.items()}

    def merged_model(self):
        """A same-family model whose weights and EMA are the merged
        parameters: it samples, serves and archives through every stock
        path with no adapter left."""
        model = self.model
        merged = type(model)(cfg=copy.deepcopy(from_dict(model.cfg)), device=model.device, seed=model.seed)
        params = self.merged_params()
        merged.params = {k: v.clone() for k, v in params.items()}
        merged.ema_params = {k: v.clone() for k, v in params.items()}
        return merged

    def save_adapters(self, path: str) -> str:
        return save_adapters(path, self.adapters, self.rank, self.alpha, self.targets)
