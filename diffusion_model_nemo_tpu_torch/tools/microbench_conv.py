"""Microbenchmark: the 3×3 conv kernel #11 against cuDNN at the flagship's shapes.

Counterpart of the JAX package's ``tools/microbench_conv.py``, at its six
shapes (level-0 and level-1 block convs, the up path's 64 → 32 concat conv,
the padded and space-to-depth level-0 candidates) with bf16 x, w and b.
Arms:
- ``cudnn``: ``F.conv2d`` in bf16 on a channels_last view of the NHWC x,
  the library yardstick (the JAX tool's ``xla`` arm), timed only and never
  on the op's route;
- ``conv3x3``: kernel #11 through ``ops.conv.conv3x3``, without the gate (as
  the JAX tool calls ``_pallas_conv3x3``), with its max |diff| against
  ``conv3x3_reference``.
The JAX tool swept the tap-split kernel's samples per grid step (g = 4 ... 32);
the tap split and its blocking were the TPU's way to widen a 32-channel GEMM
on its 128-lane matrix unit, and the card's kernel computes the conv
directly, so it is one arm here. On the CPU the library arm is PyTorch's CPU
conv and is named ``conv2d``.

    python -m diffusion_model_nemo_tpu_torch.tools.microbench_conv [--device cpu] [B H W C F ...]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import conv
from . import arg_parser, timed_us, to_device

__all__ = ["SHAPES", "run", "report", "main"]

SHAPES = (
    (128, 32, 32, 32, 32),    # level-0 block conv
    (128, 32, 32, 64, 32),    # up-path concat conv (64 -> 32)
    (128, 16, 16, 64, 64),    # level-1 block conv
    (128, 32, 32, 64, 64),    # level 0 padded 32 -> 64
    (128, 32, 32, 128, 128),  # level 0 padded 32 -> 128
    (128, 16, 16, 32, 32),    # space-to-depth level 0
)
REPS, ROUNDS = 50, 5


def inputs(shape, device: torch.device):
    """bf16 x ~ N(0, 1), w and b ~ N(0, 0.1²), from a numpy seed."""
    B, H, W, C, Fo = shape
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    return (
        to_device(rng.standard_normal((B, H, W, C)), bf, device),
        to_device(rng.standard_normal((3, 3, C, Fo)) * 0.1, bf, device),
        to_device(rng.standard_normal(Fo) * 0.1, bf, device),
    )


def library_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """A call of ``F.conv2d`` (cuDNN on the card) on the same NHWC data: x as
    a channels_last NCHW view, w [F, C, 3, 3] channels_last. Returns NCHW."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xc, wc, b, padding=1)


def run(shapes=SHAPES, device="cuda", reps: int = REPS, rounds: int = ROUNDS) -> list:
    """One row per (shape, arm): {"tool", "shape", "arm", "us", "gflop",
    "device"}; the kernel's with "max_abs_diff" against the plain conv."""
    device = torch.device(device)
    lib_arm = "cudnn" if device.type == "cuda" else "conv2d"
    rows = []
    with torch.no_grad():
        for shape in shapes:
            B, H, W, C, Fo = shape
            x, w, b = inputs(shape, device)
            gflop = 2 * B * H * W * 9 * C * Fo / 1e9
            row = {"tool": "microbench_conv", "shape": list(shape), "gflop": gflop, "device": device.type}
            rows.append(dict(row, arm=lib_arm, us=timed_us(library_conv(x, w, b), device, reps, rounds)))
            t = timed_us(lambda: conv.conv3x3(x, w, b), device, reps, rounds)
            diff = (conv.conv3x3(x, w, b).float() - conv.conv3x3_reference(x, w, b).float()).abs().max()
            rows.append(dict(row, arm="conv3x3", us=t, max_abs_diff=float(diff)))
    return rows


def report(rows) -> list:
    """The JAX tool's lines: the library conv, then the kernel indented."""
    lines = []
    for row in rows:
        B, H, W, C, Fo = row["shape"]
        rate = f"{row['gflop'] / row['us'] * 1e3:6.1f} GF/ms"
        if "max_abs_diff" in row:
            lines.append(f"   {row['arm']}: {row['us']:8.1f} us ({rate})  max|d|={row['max_abs_diff']:.4f}")
        else:
            lines.append(f"[{B},{H},{W},{C}->{Fo}] {row['arm']} {row['us']:8.1f} us ({rate})")
    return lines


def main(argv=None) -> int:
    p = arg_parser(__doc__.splitlines()[0], REPS, ROUNDS)
    p.add_argument("dims", type=int, nargs="*", metavar="B H W C F",
                   help="shapes as groups of five (default: the six flagship shapes)")
    args = p.parse_args(argv)
    if len(args.dims) % 5:
        p.error("shapes are groups of five numbers: B H W C F")
    shapes = [tuple(args.dims[i:i + 5]) for i in range(0, len(args.dims), 5)] or SHAPES
    for line in report(run(shapes, args.device, args.reps, args.rounds)):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
