"""Short card check of the two tensor-core attention kernels, for the first
chip call after an edit of ``csrc/attention.cu``, ``csrc/attention_block_small.cu``
or ``csrc/mma.cuh``:

    python -m diffusion_model_nemo_tpu_torch.tools.check_attention

It builds the kernels, prints what ptxas reported for the two sources
(registers, spills), holds kernel #7 (bf16 at edge shapes: ragged and tiny N,
every head dim, strided k/v cut from one qkv tensor; float32 once) and kernel
#4 (the ends of its gate, a C that is padded) against their plain versions
at the kernel tolerances, and times both at the DiT-S/2 and unet_small shapes:
CUDA events over back-to-back wrapper calls (host gaps count), SDPA beside #7,
torch.profiler device time for #4. About half a minute on one H100. Exits
non-zero if a kernel disagrees. No CPU mode: a CPU tensor never reaches a kernel.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops import attention as A
from .profiling import device_profile, time_ms

ATTENTION_SHAPES = (  # [B, N, h, d]
    (2, 1024, 2, 64), (2, 1100, 3, 32), (2, 1100, 2, 64), (1, 1030, 1, 64), (1, 40, 1, 64),
    (1, 64, 1, 64), (1, 100, 2, 128), (2, 1024, 2, 128), (1, 4096, 2, 64), (64, 1024, 6, 64),
)
SMALL_BLOCK_SHAPES = (  # [B, N, C]
    (64, 16, 256), (128, 16, 256), (4, 8, 64), (4, 64, 128), (3, 32, 256), (64, 16, 512),
    (2, 24, 96), (64, 16, 64), (3, 16, 48), (2, 40, 136), (64, 64, 512),
)


def ptxas_report(stem: str):
    """(kernel, resources) per entry function of one source's build log."""
    for path in _build.BUILD_DIR.glob(f"{stem}-*.log"):
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                info = [ln.replace("ptxas info    : ", "").strip() for ln in lines[i + 1 : i + 4]
                        if "Used" in ln or "spill" in ln]
                yield line.split("'")[1], " | ".join(info)


def agrees(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> bool:
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= tol + tol * ref.float().abs()).all()) and bool(torch.isfinite(out.float()).all())
    print(f"[check] {name} max_abs_err={float(err.max()):.3e} ok={ok} (rtol = atol = {tol})", flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("check_attention: no CUDA device", file=sys.stderr)
        return 2
    _build.load_kernels()
    print(f"[build] nvcc {_build.build_seconds['total']:.2f} s")
    for stem in ("attention", "attention_block_small"):
        for kernel, info in ptxas_report(stem):
            print(f"[ptxas] {kernel[:96]}: {info}")
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    ok = True
    for B, N, H, D in ATTENTION_SHAPES:
        qkv = randn(B, N, 3, H, D).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0] * D**-0.5, qkv[:, :, 1], qkv[:, :, 2]
        ok &= agrees(f"attention {[B, N, H, D]} bf16", A.attention_cuda(q, k, v), A.attention_reference(q, k, v), 2e-2)
        ms = time_ms(lambda: A.attention_cuda(q, k, v))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0))
        print(f"[time] attention {[B, N, H, D]}: {ms:.4f} ms ({4 * B * H * N * N * D / ms / 1e9:.1f} TFLOP/s), "
              f"SDPA {sdpa:.4f} ms", flush=True)
    qkv = randn(2, 1024, 3, 2, 64)
    q, k, v = qkv[:, :, 0] * 0.125, qkv[:, :, 1], qkv[:, :, 2]
    ok &= agrees("attention [2, 1024, 2, 64] float32", A.attention_cuda(q, k, v), A.attention_reference(q, k, v), 1e-4)

    for B, N, C in SMALL_BLOCK_SHAPES:
        args = (randn(B, N, C, std=0.5).to(torch.bfloat16), 1.0 + randn(C, std=0.1), randn(C, std=0.1),
                randn(C, 384, std=C**-0.5), randn(128, C, std=128**-0.5), randn(C, std=0.1),
                4, 32, 32**-0.5, 1e-5)
        ok &= agrees(f"attention_block_small {[B, N, C]}", A.attention_block_small_cuda(*args),
                     A.attention_block_reference(*args), 2e-2)
        ms = time_ms(lambda: A.attention_block_small_cuda(*args), 50)
        print(f"[time] attention_block_small {[B, N, C]}: {ms:.4f} ms by CUDA events (the wrapper's host time "
              f"counts), device {device_profile(lambda: A.attention_block_small_cuda(*args))[0] * 1e3:.2f} us",
              flush=True)
    print("all agree" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
