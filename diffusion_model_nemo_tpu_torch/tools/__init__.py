"""The port's kernel microbenchmarks: counterparts of the JAX package's
``tools/microbench_attn.py``, ``tools/microbench_conv.py`` and
``tools/microbench_attn_lanes.py``, the entry points that reach TPU kernels
#10-#13. Each module has ``run(...) -> list[dict]``, ``report(rows)`` (the
JAX tool's lines) and ``main(argv)``:

    python -m diffusion_model_nemo_tpu_torch.tools.microbench_conv [--device cpu] [B H W C F ...]

Timing is CUDA events around ``reps`` back-to-back calls, the median of
``rounds``; on the CPU (``--device cpu``, for the tests) the host clock, which
times PyTorch's CPU kernels and says nothing of the card.

``check_attention`` and ``check_conv_norm`` are not microbenchmarks of the
JAX package but the short card checks of kernels #7 and #4, and #11 and #6,
to run first after an edit of their sources (``python -m
diffusion_model_nemo_tpu_torch.tools.check_attention``). They and
``chip_smoke.py`` measure through ``profiling``; ``ab_chip.py`` runs another
checkout's serving load and ``chip_smoke.py`` with that measurement, for A/B
runs on one card. ``reconstruct_ema`` is the JAX tool's counterpart: a
post-hoc EMA snapshot directory and a base archive become an archive whose
EMA is the reconstruction (host numpy only).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

__all__ = ["timed_us", "arg_parser", "to_device", "shape_tag"]


def timed_us(fn: Callable[[], object], device: torch.device, reps: int, rounds: int) -> float:
    """Median over ``rounds`` of the time per call of ``reps`` back-to-back
    calls of ``fn``, in µs, after one warm-up call."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / reps)
    else:
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) * 1e6 / reps)
    return float(np.median(times))


def to_device(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor of ``dtype`` on ``device``."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)


def shape_tag(shape) -> str:
    """[128,1024,32], as the JAX tools print a shape."""
    return "[" + ",".join(str(n) for n in shape) + "]"


def arg_parser(description: str, reps: int, rounds: int) -> argparse.ArgumentParser:
    """The options every tool takes: --device, --reps, --rounds."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--reps", type=int, default=reps, help="back-to-back calls per timing")
    p.add_argument("--rounds", type=int, default=rounds, help="timings; the median is reported")
    return p
