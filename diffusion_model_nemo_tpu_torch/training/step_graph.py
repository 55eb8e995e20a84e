"""A training step as one captured graph (``ops/graphs.py``), the one way
the Trainer, the reflow step, LoRA and the two distillers run theirs.

``replayed`` stages what the step reads into the graph's static buffers
before every replay: every numeric array of the raw batch (the image or the
waveform, the labels, the caption tokens: whatever the family's
preprocessing reads, through pinned memory on CUDA, as a pageable copy
cannot overlap), then the step's other inputs (its draws and the
optimizer's row). So the graph reads what the eager step reads, and a batch
key that reaches one reaches the other. ``OptimizerRows`` keeps an
optimizer's rows (``Optimizer.table``) on the device, a step copying its
row in and never reading the table.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..ops import graphs as graphs_lib
from .optim import Optimizer

__all__ = ["OptimizerRows", "adamw", "batch_arrays", "replayed"]

_BATCH = "batch/"  # the batch's static buffers, apart from the inputs' names


def adamw(learning_rate: float, weight_decay: float = 0.0) -> Optimizer:
    """AdamW at optax's default betas and eps with a constant rate, as the
    JAX package's fine-tuning and distillation recipes build it."""
    lr = float(learning_rate)
    return Optimizer("adamw", lambda _count: lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=float(weight_decay))


class OptimizerRows:
    """``optimizer``'s rows on ``device``: ``rows[count]`` is the row of the
    update after ``count`` (the table built anew over twice the count, on
    the host between steps, when a step passes its end)."""

    def __init__(self, optimizer: Optimizer, device):
        self.optimizer, self.device = optimizer, device
        self._table: Optional[torch.Tensor] = None

    def __getitem__(self, count: int) -> torch.Tensor:
        if self._table is None or count >= self._table.shape[0]:
            self._table = self.optimizer.table(max(2 * count, 64), self.device)
        return self._table[count]


def batch_arrays(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """Every numeric (or boolean) array of a raw batch, numpy or tensor, as
    a tensor where it lies, pinned when it goes from the host to CUDA;
    strings and other objects are left out (no step reads them)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v):
            a = np.asarray(v)
            if a.dtype.kind not in "biuf":
                continue
            v = torch.as_tensor(np.ascontiguousarray(a))
        if device.type == "cuda" and v.device.type == "cpu" and not v.is_pinned():
            v = v.pin_memory()
        out[k] = v
    return out


def replayed(store: Dict[tuple, Any], name: str, batch: Mapping[str, Any], inputs: Dict[str, torch.Tensor],
             step: Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]], Any], device,
             writes: Sequence[torch.Tensor], sources: Iterable[torch.Tensor], key: tuple = ()) -> Any:
    """``step(batch, inputs)`` as a replay of the graph named ``name`` kept
    in ``store``: the batch's arrays (``batch_arrays``) and ``inputs`` are
    copied into its static buffers first. The graph is keyed on ``key`` and
    their names, shapes and dtypes, and held to ``writes`` (the tensors the
    step updates in place) and ``sources`` (what else it reads: weights,
    tables), so that new ones capture anew. Its first call runs the step
    eagerly (the warm-up) and captures it. Returns what the step returned:
    the graph's own buffers on CUDA, which the caller clones."""
    host = batch_arrays(batch, device)

    def stage(static):
        for k, v in host.items():
            static[_BATCH + k].copy_(v, non_blocking=True)
        for k, v in inputs.items():
            static[k].copy_(v)

    def build():
        static = {**{_BATCH + k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in host.items()},
                  **{k: torch.empty_like(v, device=device) for k, v in inputs.items()}}
        stage(static)

        def run():
            return step({k: static[_BATCH + k] for k in host}, {k: static[k] for k in inputs})

        return graphs_lib.Graph(name, run, static, device=device, warmup=run, mutates=writes, derived=False)

    key = (name, *key, *((_BATCH + k, tuple(v.shape), v.dtype) for k, v in host.items()),
           *((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
    graph, built = graphs_lib.cached(store, key, [*writes, *sources], build)
    if built:
        return graph.warmup_out
    stage(graph.static)
    return graph.replay()
