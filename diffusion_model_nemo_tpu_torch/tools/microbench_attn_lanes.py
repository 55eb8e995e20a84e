"""Probe: the qkv-fused linear attention on natural and lane-packed tokens, and
a 2-D transpose.

Counterpart of the JAX package's ``tools/microbench_attn_lanes.py``. On the
TPU a [B, N, C] operand with C = 32 or 64 pads its 128-lane tiles 4x or 2x;
the probe's v4 passes the same buffer viewed as [B, N·C/128, 128]. Arms, each
followed by the out projection, at the flagship shapes in bf16:
- ``v3``: kernel #3 (the qkv-fused linear attention) on [B, N, C];
- ``v4``: ``v4_call``, kernel #12 on the packed view. On the card the two
  views are the same bytes, so #12 reads them as token rows.
Each prints its max |diff| against the composed reference. Then
``transpose_probe`` times kernel #13, [rows, 128] → [128, rows] in bf16,
against the copy ``x.t().contiguous()`` and checks it bit for bit. The JAX
tool's sweeps of samples per grid step (g = 2, 4, 8) were TPU blockings and
are dropped.

    python -m diffusion_model_nemo_tpu_torch.tools.microbench_attn_lanes [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import attention as A
from ..ops import transpose as T
from ..ops.recompute import kernel_call
from . import arg_parser, shape_tag, timed_us, to_device

__all__ = ["SHAPES", "TRANSPOSES", "v4_call", "transpose_probe", "run", "report", "main"]

SHAPES = ((128, 1024, 32), (128, 256, 64))
TRANSPOSES = ((4096, 128), (8192, 128), (32768, 128))
HEADS, DIM_HEAD = 4, 32
REPS, ROUNDS = 50, 5


def v4_call(x: torch.Tensor, wqkv: torch.Tensor, heads: int, dim_head: int, scale: float) -> torch.Tensor:
    """[B, N, C] tokens → [B, N, h·d] through kernel #12 on their packed view."""
    B, N, C = x.shape
    return A.linear_attention_v4(x.reshape(B, N * C // 128, 128), wqkv, N, heads, dim_head, scale)


def transpose_probe(rows: int, lanes: int, dtype=torch.bfloat16, device="cuda",
                    reps: int = REPS, rounds: int = ROUNDS) -> dict:
    """Kernel #13 on x [rows, lanes] → [lanes, rows]: its time, the copy's,
    and whether it equals the copy bit for bit."""
    device = torch.device(device)
    x = to_device(np.random.default_rng(0).standard_normal((rows, lanes)), dtype, device)
    with torch.no_grad():
        exact = bool(torch.equal(T.transpose2d(x), T.transpose2d_reference(x)))
        return {
            "tool": "microbench_attn_lanes", "shape": [rows, lanes], "arm": "transpose",
            "dtype": "bf16" if dtype == torch.bfloat16 else str(dtype).removeprefix("torch."), "mb": rows * lanes * x.element_size() / 1e6,
            "us": timed_us(lambda: T.transpose2d(x), device, reps, rounds),
            "copy_us": timed_us(lambda: T.transpose2d_reference(x), device, reps, rounds),
            "exact": exact, "device": device.type,
        }


def run(shapes=SHAPES, transposes=TRANSPOSES, device="cuda", reps: int = REPS,
        rounds: int = ROUNDS) -> list:
    """One row per (shape, arm) with "us" and "max_abs_diff" against the
    composed reference, then one per transpose shape."""
    device = torch.device(device)
    hd = HEADS * DIM_HEAD
    scale = DIM_HEAD**-0.5
    rows = []
    with torch.no_grad():
        for B, N, C in shapes:
            x = to_device(np.random.default_rng(0).standard_normal((B, N, C)), torch.bfloat16, device)
            rng = np.random.default_rng(1)
            wqkv = to_device(rng.standard_normal((C, 3 * hd)) * 0.1, torch.float32, device)
            wout = to_device(rng.standard_normal((hd, C)) * 0.1, torch.float32, device)
            wo = wout.to(x.dtype)

            def v3(y):
                return kernel_call(
                    A.linear_attention_tokens_cuda, A.linear_attention_tokens_reference,
                    y, wqkv, HEADS, DIM_HEAD, scale,
                ).to(y.dtype) @ wo

            def v4(y):
                return v4_call(y, wqkv, HEADS, DIM_HEAD, scale).to(y.dtype) @ wo

            qkv = x @ wqkv.to(x.dtype)
            ref = (A.linear_attention_qkv_reference(qkv, HEADS, DIM_HEAD, scale).to(x.dtype) @ wo).float()
            for name, fn in (("v3", v3), ("v4", v4)):
                rows.append({
                    "tool": "microbench_attn_lanes", "shape": [B, N, C], "arm": name,
                    "us": timed_us(lambda: fn(x), device, reps, rounds),
                    "max_abs_diff": float((fn(x).float() - ref).abs().max()), "device": device.type,
                })
    for r, lanes in transposes:
        rows.append(transpose_probe(r, lanes, torch.bfloat16, device, reps, rounds))
    return rows


def report(rows) -> list:
    """The JAX tool's lines, with the copy's time and the bitwise check
    beside each transpose."""
    lines = []
    for row in rows:
        tag = shape_tag(row["shape"])
        if row["arm"] == "transpose":
            lines.append(f"transpose {tag} {row['dtype']} ({row['mb']:.1f} MB): {row['us']:7.1f} us/op  "
                         f"(copy {row['copy_us']:7.1f} us/op, bitwise equal: {row['exact']})")
        else:
            lines.append(f"{tag} {row['arm']}: {row['us']:7.1f} us/op  max|d|={row['max_abs_diff']:.4f}")
    return lines


def main(argv=None) -> int:
    p = arg_parser(__doc__.splitlines()[0], REPS, ROUNDS)
    p.add_argument("--shape", type=int, nargs=3, action="append", metavar=("B", "N", "C"),
                   help="a token shape (repeatable); default the two flagship shapes")
    p.add_argument("--transpose", type=int, nargs=2, action="append", metavar=("ROWS", "LANES"),
                   help="a transpose shape (repeatable); default [4096|8192|32768, 128]")
    args = p.parse_args(argv)
    rows = run(args.shape or SHAPES, args.transpose or TRANSPOSES, args.device, args.reps, args.rounds)
    for line in report(rows):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
