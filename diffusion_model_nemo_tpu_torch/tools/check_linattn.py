"""Short card check of the whole-block linear-attention kernels #2, #9 and
#10, of its core mode, #3 and #12, and of its raw mode, #8
(``csrc/linear_attention.cu``: one launch, one thread-block cluster a
sample), for the first chip call after an edit of that source or of
``csrc/mma.cuh``:

    python -m diffusion_model_nemo_tpu_torch.tools.check_linattn

It builds the kernels, prints what ptxas reported for the source (registers,
shared memory, spills), then holds each kernel against its plain version at
the shapes its paths give it (unet_small B=64 for #2, the switched unet_small
B=128 and the microbenchmark for #9, the microbenchmark for #10) and at the
corners of the gates ([2,4096,32], [2,4096,128], [3,100,128] with a ragged
last m16 tile, [2,64,128]): #2 against ``linear_attention_block_packed_reference``,
#9 and #10 against ``linear_attention_block_v2_reference``, at rtol = atol =
2e-2 in bf16 and 1e-4 for #10 in float32. #3 runs at unet_small's
[64,64,64] and at the corners of its gate ([2,4096,32], [2,4096,128],
[2,4096,256] in the core's recompute form, [3,104,128], [2,64,128]), #12 at
the microbenchmark's two shapes in bf16 and at one in float32, both against
``linear_attention_tokens_fused_reference`` (the TPU kernel's seams), with
a seam check in bf16 besides the tolerance: against the same plain version
with its sums in float64 (the same bf16 roundings), max |diff| at most one
bf16 step at the output's scale (2^-7 max |ref|), at most 2% of the elements
differing; then #3 at the N = 4096 corners on 16 seeds (``[seeds]`` lines:
how far the kernel and the float32 plain version each sit from the float64
one). #8 runs in float32 (1e-4) and bf16 (2e-2 and the seam check) at
the float32 U-Net's three shapes ([64,1024|256|64,384]) and at the corners
of its gate ([2,4096,384] on a cluster of 16 in the reload form,
[3,104,384] with N % 16 != 0, [2,64,384]), against
``linear_attention_qkv_fused_reference`` (f32 throughout, one cast), all
timed; then, at the float32 U-Net's shapes and [64,512,384], #8's time on
both raw plans, 128 and 64 tokens a CTA (``[sweep]`` lines: the plan takes
128 up to N = 256). Every call must run exactly one device kernel and
repeat bit for bit, and the plan's shared-memory bytes must equal the
source's own layout
(``dmn_linattn_block_smem``). At the path shapes it times each kernel by
torch.profiler device time and by CUDA events around calls queued behind a
spin kernel (``profiling``), beside its bound and, summed over a path, the
device time of the form that came before (``PERF.md``, kernel table). About
a minute on one H100. Exits non-zero if a check fails. No CPU mode: a CPU
tensor never reaches a kernel.
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import torch

from ..ops import _build
from ..ops import attention as A
from .check_attention import ptxas_report
from .profiling import bound_us, device_profile, kernel_launches, queued_us

HEADS, DIM_HEAD = 4, 32
# kernel -> (wrapper, plain version)
KERNELS = {
    "linear_attention_block": ("linear_attention_block_cuda", "linear_attention_block_packed_reference"),
    "linear_attention_block_v1": ("linear_attention_block_v1_cuda", "linear_attention_block_v2_reference"),
    "linear_attention_block_v2": ("linear_attention_block_v2_cuda", "linear_attention_block_v2_reference"),
    "linear_attention_tokens": ("linear_attention_tokens_cuda", "linear_attention_tokens_fused_reference"),
    "linear_attention_v4": ("linear_attention_v4_cuda", "linear_attention_v4_fused_reference"),
    "linear_attention_qkv": ("linear_attention_qkv_cuda", "linear_attention_qkv_fused_reference"),
}
CORE = ("linear_attention_tokens", "linear_attention_v4")  # the core mode
SEAM = CORE + ("linear_attention_qkv",)  # held to the TPU kernel's seams in bf16 too
SEAM_DIFFER = 0.02
SEAM_SEEDS = 16  # seeds #3 is held on at the N = 4096 corners
TOOL_SHAPES = ((128, 1024, 32), (128, 256, 64))  # the microbenchmark's (#9 and #10)
PATH_SHAPES = {  # [B, N, C] of each kernel's main path: one call each a pass
    "linear_attention_block": ((64, 1024, 32), (64, 256, 64), (64, 64, 128), (64, 256, 32)),
    "linear_attention_block_v1": ((128, 64, 64),),  # unet_small B=128 under its switch
    "linear_attention_block_v2": TOOL_SHAPES,
    "linear_attention_tokens": ((64, 64, 64),),  # unet_small B=64
    "linear_attention_v4": TOOL_SHAPES,
    "linear_attention_qkv": ((64, 1024, 384), (64, 256, 384), (64, 64, 384)),  # the float32 unet_small B=64
}
PATH_DTYPE = {"linear_attention_qkv": torch.float32}  # the others' main path is bf16
PATH_CALLS = {(64, 256, 384): 2, (64, 64, 384): 2}  # #8's calls a forward at a shape, where more than one
QKV_CORNER_SHAPES = ((2, 4096, 384), (3, 104, 384), (2, 64, 384))
# The corners of the gates, and #9 at the microbenchmark's shapes.
CORNER_SHAPES = ((2, 4096, 32), (2, 4096, 128), (3, 100, 128), (2, 64, 128))
CORE_CORNER_SHAPES = ((2, 4096, 32), (2, 4096, 128), (2, 4096, 256), (3, 104, 128), (2, 64, 128))
F32_SHAPES = {  # float32: resident, then the recompute form (#10); #12 at one tool shape
    "linear_attention_block_v2": ((128, 256, 64), (2, 4096, 32)),
    "linear_attention_v4": ((128, 256, 64),),
}
# The form before each kernel's redesign, device ms per main-path pass
# (PERF.md kernel table, NVIDIA H100 80GB HBM3 at 700 W): the five-launch
# block for #2 over its four unet_small calls, #9 over one switched forward
# and #10 over the two microbenchmark shapes; the three-launch core for #3 at
# unet_small's one call and #12 over the two microbenchmark shapes; #8's
# three launches over the float32 unet_small's five calls.
OLD_DEV_MS = {"linear_attention_block": 1.1876, "linear_attention_block_v1": 0.1824,
              "linear_attention_block_v2": 1.7724, "linear_attention_tokens": 0.0904,
              "linear_attention_v4": 1.1011, "linear_attention_qkv": 0.6025}


def block_args(shape, dtype, gen, device="cuda"):
    """Seeded inputs of one block call: x, the prenorm and out-norm affines,
    W_qkv, W_out, b_out, then heads, dim_head, scale, eps."""
    B, N, C = shape

    def randn(*s, std=1.0):
        return torch.randn(*s, generator=gen, device=device) * std

    return (randn(B, N, C, std=0.5).to(dtype), 1.0 + randn(C, std=0.1), randn(C, std=0.1),
            randn(C, 384, std=C**-0.5), randn(128, C, std=128**-0.5), randn(C, std=0.1),
            1.0 + randn(C, std=0.1), randn(C, std=0.1), HEADS, DIM_HEAD, DIM_HEAD**-0.5, 1e-5)


def core_args(name: str, shape, dtype, gen, device="cuda"):
    """Seeded inputs of one core call: h ~ N(0, 1) (normed tokens), W_qkv ~
    N(0, 1/C); #12 takes h on its lane-packed view and N."""
    B, N, C = shape
    h = torch.randn(B, N, C, generator=gen, device=device).to(dtype)
    w = torch.randn(C, 384, generator=gen, device=device) * C**-0.5
    if name == "linear_attention_v4":
        return h.reshape(B, N * C // 128, 128), w, N, HEADS, DIM_HEAD, DIM_HEAD**-0.5
    return h, w, HEADS, DIM_HEAD, DIM_HEAD**-0.5


def qkv_args(shape, dtype, gen, device="cuda"):
    """Seeded inputs of one #8 call: raw qkv ~ N(0, 1) (a 1x1 conv of normed
    features), then heads, dim_head, scale."""
    return torch.randn(*shape, generator=gen, device=device).to(dtype), HEADS, DIM_HEAD, DIM_HEAD**-0.5


def plan(name: str, shape, dtype):
    """The launch plan of kernel ``name`` for a [B, N, C] call."""
    return A.linattn_block_plan(shape[1], shape[2], dtype, core=name in CORE, raw=name == "linear_attention_qkv")


def format_row(row: dict) -> str:
    """One checked call as a line: the hold, the launch count, the repeat,
    and where timed the device time, the queued-events time and the bound."""
    line = (f"[check] {row['kernel']} {list(row['shape'])} {row['dtype']} plan={row['plan']} "
            f"max_abs_err={row['max_abs_err']:.3e} ok={row['ok']} (rtol = atol = {row['tol']}) "
            f"kernels/call={row['kernels']} repeat_bitwise={row['repeat']} plan_bytes_mirrored={row['mirrored']}")
    if "seam_step" in row:
        line += f" | seam: max_abs_err <= {row['seam_step']:.3e} (one bf16 step), differ {row['differ']:.4f}"
    if "dev_us" in row:
        line += (f" | dev {row['dev_us']:.2f} us, queued {row['queued_us']:.2f} us, "
                 f"bound {row['bound_us']:.3f} us")
    return line


def check(name: str, shape, dtype, gen, timed: bool) -> dict:
    wrapper, plain = (getattr(A, attr) for attr in KERNELS[name])
    core, raw = name in CORE, name == "linear_attention_qkv"
    args = (qkv_args(shape, dtype, gen) if raw else core_args(name, shape, dtype, gen) if core
            else block_args(shape, dtype, gen))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    out, ref = wrapper(*args), plain(*args)
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= tol + tol * ref.float().abs()).all()) and bool(torch.isfinite(out.float()).all())
    seam = {}
    if name in SEAM and dtype == torch.bfloat16:  # against the same roundings with float64 sums
        exact = plain(*args, acc=torch.float64).float()
        seam = {"seam_step": 2.0**-7 * float(exact.abs().max()), "differ": float((out.float() != exact).float().mean())}
        ok &= float((out.float() - exact).abs().max()) <= seam["seam_step"] and seam["differ"] <= SEAM_DIFFER
    launched = kernel_launches(lambda: wrapper(*args))
    one = len(launched) == 1 and "linattn_block_kernel" in launched[0]
    repeat = bool(torch.equal(wrapper(*args), out))
    lp = plan(name, shape, dtype)
    smem_fn = _build.c_function("linear_attention", "dmn_linattn_block_smem", [ctypes.c_int] * 5, ctypes.c_long)
    esize = 2 if dtype == torch.bfloat16 else 4
    mirrored = smem_fn(shape[2], lp.slab, int(lp.resident), esize, 2 if raw else int(core)) == lp.smem_bytes
    row = {"kernel": name, "shape": shape, "dtype": str(dtype).removeprefix("torch."),
           "plan": f"{lp.cluster}x{lp.slab}{'' if lp.resident else ' recompute'} {lp.smem_bytes} B",
           "max_abs_err": float(err.max()), "ok": ok and one and repeat and mirrored, "tol": tol,
           "kernels": len(launched) if one else launched, "repeat": repeat, "mirrored": mirrored, **seam}
    if timed:
        row["dev_us"] = device_profile(lambda: wrapper(*args))[0] * 1e3
        row["queued_us"] = queued_us(lambda: wrapper(*args))
        row["bound_us"] = bound_us(name, args)
    print(format_row(row), flush=True)
    return row


def sweep_raw_slabs(gen) -> None:
    """#8 in float32 at [64, 64|256|512|1024, 384] on the raw plan with 128
    tokens a CTA (a CTA an SM) and with 64 (two CTAs an SM), each held
    against the seam-true reference; device time by torch.profiler."""
    for N in (64, 256, 512, 1024):
        qkv = torch.randn(64, N, 384, generator=gen, device="cuda")
        ref = A.linear_attention_qkv_fused_reference(qkv, HEADS, DIM_HEAD, DIM_HEAD**-0.5)
        parts = []
        for slab in (128, 64):
            cluster = min(A._RAW_MAX_CLUSTER, -(-N // slab))
            tokens = -(-N // cluster)
            lp = A.LinattnBlockPlan(cluster, tokens, A._linattn_raw_smem(tokens, True, 4), True)
            run = lambda: A._launch_qkv(qkv, lp, DIM_HEAD**-0.5)  # noqa: E731
            err = float((run() - ref).abs().max())
            assert err <= 1e-4, (N, slab, err)
            parts.append(f"{slab} tokens a CTA ({cluster}x{tokens}) dev {device_profile(run)[0] * 1e3:.2f} us")
        print(f"[sweep] linear_attention_qkv [64, {N}, 384] float32: " + " | ".join(parts), flush=True)


def seam_seeds() -> bool:
    """#3 at the N = 4096 corners (resident at C = 32, the recompute form at
    C = 128 and 256) on ``SEAM_SEEDS`` seeds: the share of bf16 elements where
    the kernel differs from the seam-true plain version, where the kernel
    differs from that version with every sum in float64 (the same bf16
    roundings: the seam check's yardstick), and where the float32 plain
    version differs from the float64 one; min / median / max over the
    seeds, and the seeds whose share against float64 crosses the seam
    check's limit."""
    ok = True
    for shape in CORE_CORNER_SHAPES[:3]:
        shares = {"kernel-f32": [], "kernel-f64": [], "f32-f64": []}
        for seed in range(SEAM_SEEDS):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            h, w, heads, dim_head, scale = core_args("linear_attention_tokens", shape, torch.bfloat16, gen)
            out = A.linear_attention_tokens_cuda(h, w, heads, dim_head, scale).float()
            ref = A.linear_attention_tokens_fused_reference(h, w, heads, dim_head, scale).float()
            exact = A.linear_attention_tokens_fused_reference(h, w, heads, dim_head, scale, torch.float64).float()
            for key, (a, b) in {"kernel-f32": (out, ref), "kernel-f64": (out, exact), "f32-f64": (ref, exact)}.items():
                shares[key].append(float((a != b).float().mean()))
        over = [s for s, share in enumerate(shares["kernel-f64"]) if share > SEAM_DIFFER]
        ok &= not over
        print(f"[seeds] linear_attention_tokens {list(shape)} bf16, {SEAM_SEEDS} seeds, share of elements that differ "
              "(min / median / max): " + "; ".join(
                  f"{k} {min(v):.4f} / {statistics.median(v):.4f} / {max(v):.4f}" for k, v in shares.items())
              + f"; seeds over {SEAM_DIFFER}: {over}", flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("check_linattn: no CUDA device", file=sys.stderr)
        return 2
    _build.load_kernels()
    print(f"[build] nvcc {_build.build_seconds['total']:.2f} s")
    for kernel, info in ptxas_report("linear_attention"):
        print(f"[ptxas] {kernel[:96]}: {info}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for name in KERNELS:
        pdt = PATH_DTYPE.get(name, torch.bfloat16)
        rows = [check(name, shape, pdt, gen, True) for shape in PATH_SHAPES[name]]
        path = list(rows)
        if name == "linear_attention_qkv":  # bf16 at the path shapes, both dtypes at the corners, all timed
            rows += [check(name, shape, torch.bfloat16, gen, True) for shape in PATH_SHAPES[name]]
            rows += [check(name, shape, dt, gen, True) for shape in QKV_CORNER_SHAPES
                     for dt in (torch.bfloat16, torch.float32)]
        else:
            untimed = {"linear_attention_block_v1": CORNER_SHAPES + TOOL_SHAPES, "linear_attention_tokens":
                       CORE_CORNER_SHAPES, "linear_attention_v4": ()}.get(name, CORNER_SHAPES)
            rows += [check(name, shape, torch.bfloat16, gen, False) for shape in untimed]
            f32 = F32_SHAPES.get(name, ())
            rows += [check(name, shape, torch.float32, gen, shape == f32[0]) for shape in f32]
        ok &= all(r["ok"] for r in rows)
        calls = [PATH_CALLS.get(tuple(r["shape"]), 1) if name == "linear_attention_qkv" else 1 for r in path]
        total = {k: sum(n * r[k] for n, r in zip(calls, path)) / 1e3 for k in ("dev_us", "queued_us", "bound_us")}
        print(f"[time] {name} per main-path pass ({sum(calls)} calls, {str(pdt).removeprefix('torch.')}): dev "
              f"{total['dev_us']:.4f} ms, queued {total['queued_us']:.4f} ms, bound {total['bound_us']:.5f} ms; "
              f"the form before its redesign {OLD_DEV_MS[name]} ms (PERF.md kernel table)", flush=True)
    sweep_raw_slabs(gen)
    ok &= seam_seeds()
    print("all agree" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
