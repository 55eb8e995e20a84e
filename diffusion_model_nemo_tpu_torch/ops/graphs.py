"""CUDA graphs of the port's hot loops: a step captured once, then replayed.

Counterpart of the JAX package's one-dispatch loops (``lax.scan`` under a
``jit`` that ``AbstractDiffusionModel._jitted`` caches): the DDIM and
ancestral chains, the bits/dim loop and the training step each run on the
card as replays of one captured step function. The function is the one the
loop runs eagerly: it reads and writes only static tensors (the caller
fills the inputs with ``copy_`` or an eager draw before each replay), and
takes its time step from a 0-d device tensor that it advances itself, so a
replay needs nothing from the host.

- ``Graph``: runs the loop's first step eagerly on a side stream (the
  warm-up, which is real work: every kernel library is loaded, every
  ``cudaFuncSetAttribute`` has run and cuDNN has chosen its plans before
  the capture), then captures the step with
  ``capture_error_mode="thread_local"`` (the server captures on its worker
  thread while HTTP threads run). On the CPU a replay calls the step: the
  same loop, eagerly, for the tests.
- ``cached``: a graph kept in a dict of its owner (the sampler's
  ``graphs``, the train state's ``graphs``), so it goes with its owner, as
  ``_jitted`` goes with the model. It is keyed like ``_jitted`` on the
  caller's name, shapes and dtypes (and the route switches and cuDNN /
  cuBLAS settings a capture freezes), and held to the parameter tensors it
  reads, each by identity and ``_version`` as ``weights.py:_DerivedWeights``
  keys derived weights: a restore, an EMA swap, an optimizer step or
  ``load_state_dict`` captures anew and never replays stale derived
  weights.
- Launch accounting: a wrapper counts its launches on the host, so a replay
  would count nothing. The counts a capture made are taken back and added
  again at every replay: launches stay "calls made" (captured x replays,
  plus the warm-up's own).
- ``captured_call``: a one-shot function of tensors (the autoencoder's
  encode, decode and reconstruct, the latent sampler's decode) as a
  replay: its inputs are copied into static buffers, its outputs cloned.
- A replay that writes the tensors it is held to (the training step) bumps
  their ``_version``, as an eager in-place update does, so that nothing
  derived from their old values is used again, and keeps the new versions.

There is no fallback: a capture or replay that raises on the card raises
to the caller. ``use_graphs(None, device)`` is true exactly on CUDA; the
loops take ``graphs=False`` to run their eager Python loop instead.
"""

from __future__ import annotations

import ctypes
import gc
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch

from .weights import _derived

__all__ = ["Graph", "cached", "captured_call", "use_graphs"]

# The switches the wrappers read at call time (the JAX package's opt-in
# routes): a graph keeps the routes of its capture, so they key it too.
ROUTE_SWITCHES = ("DMN_TPU_PALLAS_NORM_BM", "DMN_TPU_PALLAS_LINATTN_BLOCK", "DMN_TPU_PALLAS_LINATTN",
                  "DMN_TPU_TAP_SPLIT_CONV")


def _routes() -> tuple:
    """What a capture freezes besides shapes and tensors: the route switches
    and the library settings that choose cuDNN's and cuBLAS's algorithms."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (tuple(os.environ.get(k) for k in ROUTE_SWITCHES), cudnn.deterministic, cudnn.benchmark,
            cudnn.allow_tf32, matmul.allow_tf32, torch.get_float32_matmul_precision())


def use_graphs(graphs: Optional[bool], device) -> bool:
    """``graphs`` as given; None means "on CUDA"."""
    return torch.device(device).type == "cuda" if graphs is None else bool(graphs)


_libcuda = None


def _node_count(graph: "torch.cuda.CUDAGraph") -> Optional[int]:
    """Nodes of a kept ``cudaGraph_t`` (libcuda's ``cuGraphGetNodes``)."""
    global _libcuda
    if _libcuda is None:
        _libcuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = _libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if rc == 0 else None


def _on_side_stream(fn: Callable[[], Any]) -> Any:
    """``fn()`` on a side stream that waits for the current one, which then
    waits for it (the warm-up before a capture)."""
    from . import _build

    _build.load_kernels()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


def _capture(run: Callable[[], Any]):
    """Capture ``run()`` into a CUDA graph: (graph, what ``run`` returned,
    {capture seconds, nodes, pool MiB}). The cyclic garbage collector is
    off meanwhile: an owner it finds in a cycle would destroy its graphs,
    an operation a capture forbids, and it invalidates the capture."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = run()
    finally:
        if collecting:
            gc.enable()
    graph.instantiate()
    return graph, out, {"capture_s": time.perf_counter() - t0, "nodes": _node_count(graph),
                        "pool_mib": (torch.cuda.memory_reserved() - reserved) / 2**20}


def _version(t: torch.Tensor) -> Optional[int]:
    try:
        return t._version
    except RuntimeError:  # an inference tensor tracks no version (and is never written outside one)
        return None


def _versions(tensors: Sequence[torch.Tensor]) -> List[Optional[int]]:
    return [_version(t) for t in tensors]


class Graph:
    """``step()`` (it reads and writes the tensors of ``static``) captured
    as one graph.

    ``warmup()`` runs first, eagerly (on a side stream on CUDA): the loop's
    own first step, real work whose launches count as launches; its result
    is ``warmup_out``. Then the capture. ``replay()`` runs the graph (on the
    CPU: ``step()``) and returns ``out``, what the captured call returned
    (static tensors on CUDA). ``mutates``: tensors the step writes in
    place, whose ``_version`` each replay bumps. ``derived=False`` captures
    with ``_derived`` off, so that what the wrappers derive from weights the
    step changes is recomputed at every replay. ``sources`` and
    ``versions`` are what ``cached`` holds it to."""

    def __init__(self, name: str, step: Callable[[], Any], static: Dict[str, Any], *,
                 device, warmup: Callable[[], Any], mutates: Sequence[torch.Tensor] = (), derived: bool = True):
        self.static, self.mutates = static, tuple(mutates)
        self.delta: Dict[str, int] = {}
        self.kept: List[Any] = []  # derived weights the graph reads: kept alive with it
        self.sources: Sequence[torch.Tensor] = ()
        self.versions: List[Optional[int]] = []
        self.info = {"name": name, "capture_s": 0.0, "nodes": None, "pool_mib": 0.0, "launches": {}, "replays": 0}
        self._step, self._graph = step, None
        self.out = None
        if torch.device(device).type != "cuda":
            self.warmup_out = warmup()
            return
        from . import launch_counts, set_launch_counts

        self.warmup_out = _on_side_stream(warmup)
        before = launch_counts()
        enabled, _derived.enabled = _derived.enabled, derived
        _derived.capturing = self.kept
        try:
            self._graph, self.out, capture = _capture(step)
        finally:
            _derived.enabled, _derived.capturing = enabled, None
            after = launch_counts()
            set_launch_counts(before)  # a capture launches nothing
        self.delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.info.update(capture, launches=dict(self.delta))
        self._step = None  # the graph holds no reference to the model or the loop

    def replay(self, times: int = 1):
        from . import add_launch_counts

        for _ in range(times):
            if self._graph is not None:
                self._graph.replay()
            else:
                self.out = self._step()
        self.info["replays"] += times
        add_launch_counts({k: v * times for k, v in self.delta.items()})
        if self.mutates:
            for t in self.mutates:
                torch.autograd.graph.increment_version(t)
            self.versions = _versions(self.sources)  # what its own replay left
        return self.out


def cached(store: Dict[tuple, Graph], key: tuple, sources: Iterable[torch.Tensor],
           build: Callable[[], Graph]):
    """(graph, built): ``store[key]`` while ``sources`` are the tensors it
    was built on, each at the version it had then (or that a replay of it
    left), else a new ``build()`` in its place (the old graph goes first,
    its pool with it). The graph holds its sources: what it reads stays
    alive while it does."""
    key = key + _routes()
    sources = tuple(sources)
    graph = store.get(key)
    if (graph is not None and len(graph.sources) == len(sources)
            and all(a is b for a, b in zip(graph.sources, sources)) and graph.versions == _versions(sources)):
        return graph, False
    if graph is not None:
        del store[key]
        graph = None  # the old graph goes before the new one is captured
    graph = build()
    graph.sources, graph.versions = sources, _versions(sources)
    store[key] = graph
    return graph, True


def captured_call(store: Dict[tuple, Graph], name: str, fn: Callable[..., Any], inputs: Dict[str, torch.Tensor],
                  sources: Iterable[torch.Tensor], graphs: Optional[bool] = None):
    """``fn(**inputs)`` (a tensor or a tuple of tensors) as a replay of a
    graph kept in ``store``, keyed on ``name`` and the inputs' shapes and
    dtypes and held to ``sources`` (the weights it reads): the first call
    runs ``fn`` eagerly on static copies of the inputs and captures it,
    later calls copy the inputs in and replay. Returns clones (never the
    graph's own buffers). ``graphs``: as ``use_graphs`` (default: on CUDA);
    False calls ``fn(**inputs)``. Tensors ``fn`` reads besides its inputs
    and sources (a 0-d scale, say) are read at every replay, as buffers."""
    device = next(iter(inputs.values())).device
    if not use_graphs(graphs, device):
        return fn(**inputs)

    def build():
        static = {k: v.clone() for k, v in inputs.items()}
        return Graph(name, lambda: fn(**static), static, device=device, warmup=lambda: fn(**static))

    key = (name, *((k, tuple(v.shape), v.dtype, v.device) for k, v in inputs.items()))
    graph, built = cached(store, key, sources, build)
    if built:
        out = graph.warmup_out
    else:
        for k, v in inputs.items():
            graph.static[k].copy_(v)
        out = graph.replay()
    return tuple(v.clone() for v in out) if isinstance(out, tuple) else out.clone()
