"""Microbenchmark: the linear-attention block's routes at the flagship shapes.

Counterpart of the JAX package's ``tools/microbench_attn.py``. Arms, on one
block ``Residual(PreNorm(LinearAttention))`` with 4 heads x 32:
- ``composed``: GroupNorm(1) → h @ W_qkv → ``fused_linear_attention_qkv``
  (kernel #8 on the card, in bf16) → out projection + bias → GroupNorm(1) → + x;
- ``v1``: the whole-block kernel #9;
- ``v2``: the whole-block kernel #10.
The JAX tool swept v2's samples per grid step (g = 1, 2, 4, 8), a VMEM
blocking of the TPU that has no counterpart on the card, so v2 is one arm
here. It prints v2's max |diff| against ``composed``.

    python -m diffusion_model_nemo_tpu_torch.tools.microbench_attn [--device cpu] [--shape B N C]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import attention as A
from ..ops.recompute import kernel_call
from . import arg_parser, shape_tag, timed_us, to_device

__all__ = ["SHAPES", "run", "report", "main"]

SHAPES = ((128, 1024, 32), (128, 256, 64))
HEADS, DIM_HEAD = 4, 32
REPS, ROUNDS = 50, 5
EPS = 1e-5


def _weights(C: int, device: torch.device):
    """The JAX tool's block: f32 W_qkv, W_out, b_out ~ N(0, 0.1²), prenorm and
    out-norm affine at identity (γ = 1, β = 0)."""
    rng = np.random.default_rng(1)
    hd = HEADS * DIM_HEAD
    f = torch.float32
    ones, zeros = torch.ones(C, device=device), torch.zeros(C, device=device)
    return (
        ones, zeros,
        to_device(rng.standard_normal((C, 3 * hd)) * 0.1, f, device),
        to_device(rng.standard_normal((hd, C)) * 0.1, f, device),
        to_device(rng.standard_normal(C) * 0.1, f, device),
        ones, zeros,
    )


def arms(C: int, device: torch.device):
    """{arm: fn(x)} for one channel count."""
    ng, nb, wqkv, wout, bout, og, ob = _weights(C, device)
    scale = DIM_HEAD**-0.5
    block = (ng, nb, wqkv, wout, bout, og, ob, HEADS, DIM_HEAD, scale, EPS)

    def composed(x):
        h = A._gn1(x, ng, nb, EPS)
        attn = A.fused_linear_attention_qkv(h @ wqkv.to(h.dtype), HEADS, DIM_HEAD, scale)
        out = attn.to(x.dtype) @ wout.to(x.dtype) + bout.to(x.dtype)
        return A._gn1(out, og, ob, EPS) + x

    return {
        "composed": composed,
        "v1": lambda x: kernel_call(
            A.linear_attention_block_v1_cuda, A.linear_attention_block_reference, x, *block
        ),
        "v2": lambda x: A.linear_attention_block_v2(x, *block),
    }


def run(shapes=SHAPES, device="cuda", reps: int = REPS, rounds: int = ROUNDS) -> list:
    """One row per (shape, arm): {"tool", "shape", "arm", "us", "device"},
    v2's with "max_abs_diff" against ``composed``."""
    device = torch.device(device)
    rows = []
    for B, N, C in shapes:
        x = to_device(np.random.default_rng(0).standard_normal((B, N, C)), torch.bfloat16, device)
        fns = arms(C, device)
        with torch.no_grad():
            for name, fn in fns.items():
                rows.append({
                    "tool": "microbench_attn", "shape": [B, N, C], "arm": name,
                    "us": timed_us(lambda: fn(x), device, reps, rounds), "device": device.type,
                })
            ref = fns["composed"](x).float()
            rows[-1]["max_abs_diff"] = float((fns["v2"](x).float() - ref).abs().max())
    return rows


def report(rows) -> list:
    """The JAX tool's lines: µs per call for each arm, then v2's max |diff|."""
    lines = [f"{shape_tag(row['shape'])} {row['arm']:12s}: {row['us']:8.1f} us/op" for row in rows]
    lines += [f"{shape_tag(row['shape'])} v2 max|d|={row['max_abs_diff']:.4f}"
              for row in rows if "max_abs_diff" in row]
    return lines


def main(argv=None) -> int:
    p = arg_parser(__doc__.splitlines()[0], REPS, ROUNDS)
    p.add_argument("--shape", type=int, nargs=3, action="append", metavar=("B", "N", "C"),
                   help="a shape to run (repeatable); default the two flagship shapes")
    args = p.parse_args(argv)
    rows = run(args.shape or SHAPES, args.device, args.reps, args.rounds)
    for line in report(rows):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
