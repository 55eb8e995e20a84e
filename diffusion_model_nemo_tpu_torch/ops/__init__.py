"""Numerical ops of the port: schedules, GroupNorm(+FiLM)+SiLU, attention,
the 3×3 convolution and the 2-D transpose of the kernel microbenchmarks.

``KERNELS`` maps each hand-written Hopper kernel to its wrapper. Each
wrapper adds one to its integer counter in its module's ``LAUNCHES`` where
it launches its kernel, so a run can show that its main path went through
the kernels; a CUDA graph's replay adds what its capture counted
(``graphs.py``). A backward pass launches none (``recompute.py``).
"""

from . import attention, conv, norm, schedules, transpose
from .attention import (
    attention_block_small_cuda,
    attention_cuda,
    linear_attention_block_cuda,
    linear_attention_block_v1_cuda,
    linear_attention_block_v2_cuda,
    linear_attention_qkv_cuda,
    linear_attention_tokens_cuda,
    linear_attention_v4_cuda,
)
from .conv import conv3x3_cuda
from .norm import group_norm_silu_bm_cuda, group_norm_silu_cuda, group_norm_silu_film_cuda
from .transpose import transpose2d_cuda

KERNELS = {
    "group_norm_silu": group_norm_silu_cuda,
    "linear_attention_block": linear_attention_block_cuda,
    "linear_attention_tokens": linear_attention_tokens_cuda,
    "attention_block_small": attention_block_small_cuda,
    "group_norm_silu_film": group_norm_silu_film_cuda,
    "group_norm_silu_bm": group_norm_silu_bm_cuda,
    "attention": attention_cuda,
    "linear_attention_qkv": linear_attention_qkv_cuda,
    "linear_attention_block_v1": linear_attention_block_v1_cuda,
    "linear_attention_block_v2": linear_attention_block_v2_cuda,
    "conv3x3": conv3x3_cuda,
    "linear_attention_v4": linear_attention_v4_cuda,
    "transpose2d": transpose2d_cuda,
}
_COUNTERS = {
    name: mod.LAUNCHES for mod in (norm, attention, conv, transpose) for name in mod.LAUNCHES
}


def launch_counts() -> dict:
    return {name: _COUNTERS[name][name] for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        _COUNTERS[name][name] = 0


def set_launch_counts(counts: dict) -> None:
    """Set the counters to ``counts`` (what ``launch_counts`` returned)."""
    for name, n in counts.items():
        _COUNTERS[name][name] = n


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` {kernel: launches}: a CUDA graph's replay launches what
    its capture recorded, with no wrapper call on the host (``graphs.py``)."""
    for name, n in delta.items():
        _COUNTERS[name][name] += n


from . import graphs  # noqa: E402  (after the counters it keeps)
from . import ode  # noqa: E402  (captures through graphs)

__all__ = [
    "attention", "conv", "graphs", "norm", "ode", "schedules", "transpose",
    "KERNELS", "add_launch_counts", "launch_counts", "reset_launch_counts", "set_launch_counts",
]
