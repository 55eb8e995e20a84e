"""Short card check of kernels #11 (3×3 conv), #6 (batch-minor GroupNorm) and
#1/#5 (GroupNorm(+FiLM)+SiLU), for the first chip call after an edit of
``csrc/conv3x3.cu``, ``csrc/group_norm_bm.cu``, ``csrc/group_norm_silu.cu``,
``csrc/group_norm.cuh`` or ``csrc/mma.cuh``:

    python -m diffusion_model_nemo_tpu_torch.tools.check_conv_norm

It builds the kernels, prints what ptxas reported for the three sources
(registers, shared memory, spills) and the tensor-core instructions in the
conv library's SASS (``cuobjdump -sass``: HMMA for mma.sync, HGMMA for
wgmma), then holds each kernel against its plain version at the kernel
tolerances (bf16 2e-2, float32 1e-4): #11 at the microbenchmark's six
shapes, at C = 32 with F = 64 and 128 (where ``conv3x3_route`` picks the
wgmma form by F alone), and at edge shapes (a ragged last band, C and F
that are not multiples of 32 or of 8, W = 128, F > 128), #6 at unet_small's
batch-minor sites at B=128 with and without FiLM, in float32, and at a C
that takes the element-wise path; #1 at unet_small's seven GroupNorm site
shapes at B=64 and #5 (per-sample FiLM) at the FiLM Block pass's at B=128,
then both at the corners: float32 [64,32,32,32], B = 1, bf16 [1,64,64,128]
(a cluster's CTAs holding 128 KB shares in shared memory), bf16
[1,128,128,128] (a slab beyond a cluster's shared memory, read twice), C =
48, C = 36 (element-wise pieces) and a per-pixel FiLM map; and #1 at
[64,32,32,32] with a sample forced onto 1, 2, 4 and 8 CTAs (the plan's
cluster rule), beside a trivial kernel's device time (the per-launch
floor). Each #11 timed shape and each #6, #1 and #5 site is timed
(kernel, cuDNN or ``F.group_norm`` + ``F.silu``) by CUDA events around calls queued
behind a spin kernel, so the host's launch time is hidden, and by
torch.profiler device time (``profiling.device_profile``), beside its bound
(``profiling.bound_us``); #1 and #5 are also summed over a forward (a pass)
with each site's count. Where the kernel takes the wgmma form, the mma.sync
form is held and timed at the same shape too. Each #6, #1 and #5 call must
run exactly one kernel on the card and repeat bit for bit, and #1's plan
bytes must equal the source's layout (``dmn_group_norm_silu_smem``). About
a minute on one H100. Exits non-zero if a kernel disagrees. No CPU mode: a
CPU tensor never reaches a kernel.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops import conv as CV
from ..ops import norm as N
from .check_attention import agrees, ptxas_report
from .microbench_conv import SHAPES as CONV_TOOL_SHAPES
from .microbench_conv import inputs as conv_inputs
from .microbench_conv import library_conv
from .profiling import bound_us, device_profile, kernel_launches, queued_us

# [B, H, W, C, F] timed beside the tool shapes: C = 32 (one chunk of input
# channels) with F >= 64, where the route by F alone picks the wgmma form.
CONV_ROUTE_SHAPES = ((128, 32, 32, 32, 64), (128, 32, 32, 32, 128), (128, 16, 16, 32, 64))
CONV_EDGE_SHAPES = (  # [B, H, W, C, F]: ragged band, C % 32, F % 8, W = 128, F > 128, C % 8; both forms
    (2, 7, 20, 48, 40), (2, 9, 128, 32, 136), (3, 33, 32, 96, 200), (2, 5, 5, 3, 8), (2, 6, 6, 16, 12),
    (2, 7, 20, 72, 64), (2, 5, 5, 66, 70), (2, 9, 128, 64, 136), (2, 6, 9, 3, 64),
)
NORM_SITES = (  # [B, H, W, C]: unet_small's batch-minor GroupNorm sites at B=128
    (128, 32, 32, 32), (128, 16, 16, 64), (128, 16, 16, 128), (128, 8, 8, 128),
)
NORM_EDGE = ((128, 8, 8, 96, torch.bfloat16), (128, 16, 16, 32, torch.float32), (128, 4, 4, 36, torch.bfloat16))
# #1's sites in one unet_small forward at B=64 ([H, W, C]: count); the FiLM
# Block pass (#5) has the same sites at B=128.
GN_SITES = {(32, 32, 32): 7, (16, 16, 32): 4, (16, 16, 64): 4, (8, 8, 64): 4, (8, 8, 128): 4, (4, 4, 128): 4,
            (4, 4, 256): 8}
GN_CORNERS = (  # [B, H, W, C], dtype, FiLM map per pixel
    ((64, 32, 32, 32), torch.float32, False), ((1, 32, 32, 32), torch.bfloat16, False),
    ((1, 64, 64, 128), torch.bfloat16, False), ((1, 128, 128, 128), torch.bfloat16, False),
    ((2, 16, 16, 48), torch.bfloat16, False),
    ((2, 8, 8, 36), torch.bfloat16, False), ((2, 8, 8, 64), torch.bfloat16, True),
    ((2, 8, 8, 64), torch.float32, True),
)
# The plan's share of a slab a CTA forced to these sizes at #1's largest
# site, [64, 32, 32, 32] bf16 (64 KB a sample): clusters of 1, 2, 4 and 8.
CLUSTER_SWEEP = (64 * 1024, 32 * 1024, 16 * 1024, 8 * 1024)
# Device ms a pass before the redesign (PERF.md kernel table, NVIDIA H100
# 80GB HBM3 at 700 W): #1 over a unet_small forward, #5 over the FiLM pass.
GN_OLD_DEV_MS = {"group_norm_silu": 0.2490, "group_norm_silu_film": 0.4879}


def sass_mma_counts(stem: str) -> dict:
    """Tensor-core instructions in one kernel library's SASS, by opcode."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    lib = _build.build_kernels()[stem]
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts = {}
    for op in ("HMMA", "HGMMA", "FFMA"):
        counts[op] = sum(1 for line in sass.splitlines() if f" {op}." in line or f" {op} " in line)
    return counts


def profiled_us(fn) -> float:
    """torch.profiler device time per call, in µs."""
    return device_profile(fn)[0] * 1e3


def check_conv(randn) -> bool:
    ok = True
    total = {}
    for shape in CONV_TOOL_SHAPES + CONV_ROUTE_SHAPES:
        x, w, b = conv_inputs(shape, torch.device("cuda"))
        B, H, W, C, Fo = shape
        route = CV.conv3x3_route(Fo)
        ok &= agrees(f"conv3x3 {list(shape)} bf16 ({route})", CV.conv3x3_cuda(x, w, b),
                     CV.conv3x3_reference(x, w, b), 2e-2)
        kernel, lib = (lambda: CV.conv3x3_cuda(x, w, b)), library_conv(x, w, b)
        k_us, l_us, k_prof, l_prof = queued_us(kernel), queued_us(lib), profiled_us(kernel), profiled_us(lib)
        bound = bound_us("conv3x3", (x, w, b))
        if shape in CONV_TOOL_SHAPES:
            for key, v in (("kernel", k_us), ("cudnn", l_us), ("bound", bound), ("kernel_prof", k_prof),
                           ("cudnn_prof", l_prof)):
                total[key] = total.get(key, 0.0) + v
        if route == "wgmma":  # the mma.sync form at the same shape, for comparison
            with mock.patch.object(CV, "conv3x3_route", lambda F: "mma"):
                ok &= agrees(f"conv3x3 {list(shape)} bf16 (mma)", CV.conv3x3_cuda(x, w, b),
                             CV.conv3x3_reference(x, w, b), 2e-2)
                print(f"[time] conv3x3 {list(shape)}: mma.sync form {queued_us(kernel):.2f} us "
                      f"(queued events; profiler {profiled_us(kernel):.2f})")
        print(f"[time] conv3x3 {list(shape)}: kernel ({route}) {k_us:.2f} us, cuDNN {l_us:.2f} us (queued events; "
              f"profiler {k_prof:.2f} / {l_prof:.2f}), bound {bound:.2f} us "
              f"({2 * B * H * W * 9 * C * Fo / k_us / 1e6:.1f} TFLOP/s)", flush=True)
    print(f"[time] conv3x3 over the six tool shapes: kernel {total['kernel']:.2f} us, cuDNN {total['cudnn']:.2f} us "
          f"(queued events; profiler {total['kernel_prof']:.2f} / {total['cudnn_prof']:.2f}), "
          f"bound {total['bound']:.2f} us", flush=True)
    for B, H, W, C, Fo in CONV_EDGE_SHAPES:
        x = randn(B, H, W, C).to(torch.bfloat16)
        w, b = randn(3, 3, C, Fo, std=C**-0.5 / 3), randn(Fo, std=0.1)
        ok &= agrees(f"conv3x3 {[B, H, W, C, Fo]} bf16 ({CV.conv3x3_route(Fo)})", CV.conv3x3_cuda(x, w, b),
                     CV.conv3x3_reference(x, w, b), 2e-2)
    ok &= agrees(f"conv3x3 {list(x.shape) + [w.shape[-1]]} bf16, no bias", CV.conv3x3_cuda(x, w, None),
                 CV.conv3x3_reference(x, w, None), 2e-2)
    for shape in ((128, 16, 16, 32, 32), (2, 7, 20, 48, 40)):
        x, w, b = (a.float() for a in conv_inputs(shape, torch.device("cuda")))
        ok &= agrees(f"conv3x3 {list(shape)} float32", CV.conv3x3_cuda(x, w, b), CV.conv3x3_reference(x, w, b), 1e-4)
    return ok


def check_norm(randn) -> bool:
    ok = True
    total = {}
    sites = [(s, torch.bfloat16) for s in NORM_SITES] + [(s[:4], s[4]) for s in NORM_EDGE]
    for shape, dt in sites:
        B, H, W, C = shape
        x = randn(*shape).to(dt)
        gamma, beta = 1.0 + randn(C, std=0.1), randn(C, std=0.1)
        groups = 4 if C % 8 else 8
        film = randn(B, 1, 1, 2 * C, std=0.5).to(dt).chunk(2, dim=-1)
        tol = 2e-2 if dt == torch.bfloat16 else 1e-4
        tag = f"{list(shape)} {str(dt)[6:]}"
        ok &= agrees(f"group_norm_silu_bm {tag}", N.group_norm_silu_bm_cuda(x, gamma, beta, groups),
                     N.group_norm_silu_reference(x, gamma, beta, groups), tol)
        ok &= agrees(f"group_norm_silu_bm {tag} FiLM", N.group_norm_silu_bm_cuda(x, gamma, beta, groups, 1e-5, *film),
                     N.group_norm_silu_reference(x, gamma, beta, groups, 1e-5, *film), tol)
        names = kernel_launches(lambda: N.group_norm_silu_bm_cuda(x, gamma, beta, groups, 1e-5, *film))
        if len(names) != 1 or "gn_bm_kernel" not in names[0]:
            print(f"[check] group_norm_silu_bm {tag}: one call ran {names}, not one gn_bm_kernel")
            ok = False
        if dt != torch.bfloat16 or shape not in NORM_SITES:
            continue
        g, bb = gamma.to(dt), beta.to(dt)
        xc = x.permute(0, 3, 1, 2)
        kernel = lambda: N.group_norm_silu_bm_cuda(x, gamma, beta, groups)  # noqa: E731
        lib = lambda: F.silu(F.group_norm(xc, groups, g, bb, 1e-5))  # noqa: E731
        k_us, l_us, k_prof, l_prof = queued_us(kernel), queued_us(lib), profiled_us(kernel), profiled_us(lib)
        bound = bound_us("group_norm_silu_bm", (x, gamma, beta, groups))
        for key, v in (("kernel", k_us), ("library", l_us), ("bound", bound), ("kernel_prof", k_prof),
                       ("library_prof", l_prof)):
            total[key] = total.get(key, 0.0) + v
        print(f"[time] group_norm_silu_bm {tag}: kernel {k_us:.2f} us, F.group_norm+F.silu {l_us:.2f} us "
              f"(queued events; profiler {k_prof:.2f} / {l_prof:.2f}), bound {bound:.2f} us", flush=True)
    print(f"[time] group_norm_silu_bm over its sites: kernel {total['kernel']:.2f} us, library "
          f"{total['library']:.2f} us (queued events; profiler {total['kernel_prof']:.2f} / "
          f"{total['library_prof']:.2f}), bound {total['bound']:.2f} us", flush=True)
    return ok


def check_gn_silu(randn) -> bool:
    """#1 and #5 at their path shapes (timed) and at the corners."""
    ok = True
    smem_fn = _build.c_function("group_norm_silu", "dmn_group_norm_silu_smem", [ctypes.c_int] * 5, ctypes.c_long)

    def one(name, shape, dt, film, timed):
        B, H, W, C = shape
        groups = 8 if C % 8 == 0 else 4
        x = randn(*shape).to(dt)
        gamma, beta = 1.0 + randn(C, std=0.1), randn(C, std=0.1)
        args = (x, gamma, beta, groups, 1e-5)
        if name == "group_norm_silu_film":
            fs = (B, H, W, 2 * C) if film == "pixel" else (B, 1, 1, 2 * C)
            args += tuple(randn(*fs, std=0.5).to(dt).chunk(2, dim=-1))
        wrapper = getattr(N, f"{name}_cuda")
        tol = 2e-2 if dt == torch.bfloat16 else 1e-4
        tag = f"{name} {list(shape)} {str(dt)[6:]}{' FiLM ' + film if film else ''}"
        out = wrapper(*args)
        good = agrees(tag, out, N.group_norm_silu_reference(*args), tol)
        names = kernel_launches(lambda: wrapper(*args))
        repeat = bool(torch.equal(wrapper(*args), out))
        plan = N.group_norm_plan(H * W, C, groups, dt, x.data_ptr() % 16 == 0)
        esize = x.element_size()
        mirrored = smem_fn(C, plan.pixels, N._GN_FORMS.index(plan.form), esize, int(plan.vec)) == plan.smem_bytes
        print(f"[check] {tag}: plan {plan.cluster}x{plan.pixels} {plan.form}{'' if plan.vec else ' element-wise'} "
              f"{plan.smem_bytes} B, one call ran {names}, "
              f"repeat_bitwise={repeat} plan_bytes_mirrored={mirrored}", flush=True)
        good &= len(names) == 1 and "gn_silu_kernel" in names[0] and repeat and mirrored
        if not timed:
            return good, None
        g, bb = gamma.to(dt), beta.to(dt)
        xc = x.permute(0, 3, 1, 2)
        lib = lambda: F.silu(F.group_norm(xc, groups, g, bb, 1e-5))  # noqa: E731
        k_us, l_us, k_prof = queued_us(lambda: wrapper(*args)), queued_us(lib), profiled_us(lambda: wrapper(*args))
        bound = bound_us(name, args)
        print(f"[time] {tag}: kernel {k_us:.2f} us, F.group_norm+F.silu {l_us:.2f} us (queued events; "
              f"kernel profiler {k_prof:.2f}), bound {bound:.2f} us", flush=True)
        return good, (k_us, k_prof, bound)

    for name, B, film in (("group_norm_silu", 64, ""), ("group_norm_silu_film", 128, "per sample")):
        total = [0.0, 0.0, 0.0]
        for (H, W, C), count in GN_SITES.items():
            good, times = one(name, (B, H, W, C), torch.bfloat16, film, True)
            ok &= good
            total = [t + count * v for t, v in zip(total, times)]
        print(f"[time] {name} per pass ({sum(GN_SITES.values())} calls at B={B}): queued {total[0] / 1e3:.4f} ms, "
              f"profiler {total[1] / 1e3:.4f} ms, bound {total[2] / 1e3:.5f} ms; the form before its redesign "
              f"{GN_OLD_DEV_MS[name]} ms (PERF.md kernel table)", flush=True)
    x = randn(64, 32, 32, 32).to(torch.bfloat16)
    gamma, beta = 1.0 + randn(32, std=0.1), randn(32, std=0.1)
    sweep = []
    for share in CLUSTER_SWEEP:  # why the plan splits a sample only above 32 KB
        with mock.patch.object(N, "_GN_SHARE_BYTES", share):
            N.group_norm_plan.cache_clear()  # the plan is cached per shape
            plan = N.group_norm_plan(32 * 32, 32, 8, torch.bfloat16)
            ok &= agrees(f"group_norm_silu [64, 32, 32, 32] bfloat16 on {plan.cluster} CTAs ({plan.form})",
                         N.group_norm_silu_cuda(x, gamma, beta, 8), N.group_norm_silu_reference(x, gamma, beta, 8),
                         2e-2)
            sweep.append(f"{plan.cluster} CTAs ({plan.form}) {profiled_us(lambda: N.group_norm_silu_cuda(x, gamma, beta, 8)):.2f}")
    N.group_norm_plan.cache_clear()
    print(f"[time] group_norm_silu [64, 32, 32, 32] bfloat16, a sample over: {'; '.join(sweep)} us (profiler)", flush=True)
    y = torch.zeros(64, device="cuda")
    print(f"[time] the per-launch floor: a 64-element add_ {profiled_us(lambda: y.add_(1)):.2f} us (profiler)", flush=True)
    for shape, dt, per_pixel in GN_CORNERS:
        if not per_pixel:
            ok &= one("group_norm_silu", shape, dt, "", False)[0]
        ok &= one("group_norm_silu_film", shape, dt, "pixel" if per_pixel else "per sample", False)[0]
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("check_conv_norm: no CUDA device", file=sys.stderr)
        return 2
    _build.load_kernels()
    print(f"[build] nvcc {_build.build_seconds['total']:.2f} s")
    for stem in ("conv3x3", "group_norm_bm", "group_norm_silu"):
        for kernel, info in ptxas_report(stem):
            print(f"[ptxas] {kernel[:96]}: {info}")
    print(f"[sass] conv3x3 library: {sass_mma_counts('conv3x3')}")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    ok = check_gn_silu(randn)
    ok &= check_conv(randn)
    ok &= check_norm(randn)
    print("all agree" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
