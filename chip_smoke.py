#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's training and serving paths on one GPU and
check them.

    python3 chip_smoke.py            # all phases, one card

Paths: unet_small (bf16, 32 px) trained at batch 128 and served, on kernels
#1-#4, and under the JAX package's two opt-in switches on #6
(``DMN_TPU_PALLAS_NORM_BM=1``) and #9 (``DMN_TPU_PALLAS_LINATTN_BLOCK=1``);
``Block(x, scale_shift)`` at unet_small's GroupNorm sites on #5 (and #6
under its switch); DiT-S/2 (bf16, 64 px) on kernel #7; the float32
unet_small on kernels #1 and #8.

Phases:
  1. Print the card (``nvidia-smi`` name and power limit) and build the
     hand-written Hopper kernels from ``diffusion_model_nemo_tpu_torch/csrc``
     (one nvcc per source, all in parallel).
  2. Hold every kernel against its plain PyTorch version on the card, at
     every shape the unet_small, flagship, float32 unet_small and DiT-S/2
     forwards send it at B=64 (inputs recorded from a real forward; #7 also
     in float32 and #8 also in bf16 at one shape), at rtol = atol = 2e-2 in
     bf16 (the JAX package's kernel-test tolerance) and 1e-4 in float32
     (the same math with f32 sums in another order); time kernel, plain
     version, a one-call PyTorch yardstick where one exists (CUDA events
     around 20 back-to-back calls, so host launch gaps count where the host
     is the limit; the logs add the device time per call from
     torch.profiler), and the least time the card could take (bytes at
     3.35 TB/s or operations at the peak rate of their type, whichever is
     larger).
  3. One U-Net forward at B=64 per bf16 configuration and one DiT-S/2
     forward with the kernels, against the same forward with every kernel
     swapped for its plain version (TF32 off for both), with device-time
     breakdowns of the unet_small and DiT forwards; the float32 route: the
     GroupNorm kernel in float32, a float32 unet_small forward against its
     plain path, and a 10-step DDIM chain with #8's launches counted.
  4. The main path: ``SamplingServer`` on unet_small (full width, random
     weights from a seed) with DDIM-50 and max_batch=64 answers /healthz,
     /stats and /sample requests (concurrent png + npy, one seed twice); the
     images decode, the seeded one repeats bit for bit, and every kernel's
     launch count equals its per-forward count x 50 steps x batches.
     4b. The same on DiT-S/2 at 64 px (full width and depth, seeded random
     weights with the adaLN-Zero leaves redrawn) with max_batch=32.
  5. A short ancestral chain (p_sample_loop, 10 steps).
  6. The training slice at B=128:
     6a. unet_small and flagship forwards under each switch against the
         plain path, with the launches per forward equal to those the gates
         derive (a shapes-only forward on meta tensors);
     6b. the FiLM path: ``Block(x, scale_shift)`` with per-sample FiLM from a
         time MLP at each of unet_small's 35 GroupNorm sites, forward and
         backward, against the plain path; #5 launches 35 times, 0 in the
         backward (and #6 27 times under its switch);
     6c. one unet_small training step with kernels against the plain path
         from the same weights and draws (loss, whole gradient), 0 kernel
         launches in the backward; per kernel call of the step, the kernel's
         time against its backward's plain recompute;
     6d. ``Trainer.fit`` of unet_small for 20 steps on the synthetic set
         (finite losses, the EMA moved, launches = 20 x per forward), step
         time, samples/s and the device-busy share of a step; then 5 steps
         under both switches (#6 = 27, #9 = 1, #3 = 0 per step).
  Every new kernel (#5, #6 plain and FiLM, #9) is held against its plain
  version at every shape these paths give it, as in phase 2, and so are
  #1-#4 at the training step's B=128 shapes.

The last two lines are a JSON object with one entry per kernel and the
result line {"ok": true, "device": {...}}. Any failure exits non-zero and
prints no result. Without a CUDA device, or outside the repository, it fails.
"""

from __future__ import annotations

import base64
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from contextlib import ExitStack
from unittest import mock

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 on CUDA cores
B = 64
TOL = 2e-2  # kernel vs plain, bf16: tests/test_ops_kernels.py
F32_TOL = 1e-4  # kernel vs plain, float32: f32 sums in another order
UNET_REL_TOL = 3e-2  # whole network, kernels vs plain path, relative L2 in bf16
F32_REL_TOL = 1e-4  # whole float32 U-Net, kernels vs plain path, relative L2
DDIM_STEPS = 50
DIT_MAX_BATCH = 32
DIT_IMG = 64
SEED = 0
TRAIN_B = 128  # unet_small's own training batch (examples/configs/ddpm/unet_small.yaml)
TRAIN_STEPS = 20
SWITCHED_STEPS = 5
LOSS_REL_TOL = 1e-2  # training step, kernels vs plain path: loss
GRAD_REL_TOL = 5e-2  # and the whole gradient, relative L2
NORM_BM = {"DMN_TPU_PALLAS_NORM_BM": "1"}
LINATTN_BLOCK = {"DMN_TPU_PALLAS_LINATTN_BLOCK": "1"}
BOTH = {**NORM_BM, **LINATTN_BLOCK}
# The configuration whose forward is each kernel's main path (per-forward sums).
MAIN_CFG = {
    "group_norm_silu": "unet_small",
    "linear_attention_block": "unet_small",
    "linear_attention_tokens": "unet_small",
    "attention_block_small": "unet_small",
    "linear_attention_qkv": "unet_small_f32",
    "attention": "dit_s2",
    "group_norm_silu_film": "film_block",
    "group_norm_silu_bm": "unet_small_128_switched",
    "linear_attention_block_v1": "unet_small_128_switched",
}
FILM_KERNELS = ("group_norm_silu_film", "group_norm_silu_bm")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Kernel names of this repository's CUDA sources, as the profiler reports them.
HAND_KERNELS = (
    "gn_silu_kernel", "xstats_kernel", "kv_kernel", "merge_kernel", "apply_kernel",
    "outnorm_kernel", "attn_block_small_kernel", "qkv_kv_kernel", "qkv_apply_kernel",
    "attn_fwd_kernel", "bm_stats_kernel", "bm_apply_kernel", "v1_kstats_kernel",
    "v1_gram_kernel", "v1_merge_kernel", "v1_apply_kernel",
)


def device_profile(fn, iters: int = 10):
    """Device time per call of everything ``fn`` runs on the card, from a
    torch.profiler trace: (total ms per call, {kernel name: ms per call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return sum(by_name.values()), by_name


def device_ms(fn):
    """Device time per call from the profiler; None ("not measured") when
    the trace holds no device time."""
    total = device_profile(fn)[0]
    return total if total > 0 else None


def fmt(v, digits=4) -> str:
    return "not measured" if v is None else f"{v:.{digits}f}"


def add(acc, v):
    """Sum that stays None once a term was not measured."""
    return None if acc is None or v is None else acc + v


# --------------------------------------------------------------- kernel table --
def kernel_table(port):
    """name -> (wrapper module, wrapper attribute, plain version, source, TPU kernel)."""
    A, N = port.ops.attention, port.ops.norm
    return {
        "group_norm_silu": (
            N, "group_norm_silu_cuda", N.group_norm_silu_reference,
            "diffusion_model_nemo_tpu_torch/csrc/group_norm_silu.cu",
            "diffusion_model_nemo_tpu/ops/norm.py:92",
        ),
        "linear_attention_block": (
            A, "linear_attention_block_cuda", A.linear_attention_block_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:842",
        ),
        "linear_attention_tokens": (
            A, "linear_attention_tokens_cuda", A.linear_attention_tokens_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:660",
        ),
        "attention_block_small": (
            A, "attention_block_small_cuda", A.attention_block_reference,
            "diffusion_model_nemo_tpu_torch/csrc/attention_block_small.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:1103",
        ),
        "linear_attention_qkv": (
            A, "linear_attention_qkv_cuda", A.linear_attention_qkv_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:194",
        ),
        "attention": (
            A, "attention_cuda", A.attention_reference,
            "diffusion_model_nemo_tpu_torch/csrc/attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:57",
        ),
        "group_norm_silu_film": (
            N, "group_norm_silu_film_cuda", N.group_norm_silu_reference,
            "diffusion_model_nemo_tpu_torch/csrc/group_norm_silu.cu",
            "diffusion_model_nemo_tpu/ops/norm.py:101",
        ),
        "group_norm_silu_bm": (
            N, "group_norm_silu_bm_cuda", N.group_norm_silu_reference,
            "diffusion_model_nemo_tpu_torch/csrc/group_norm_bm.cu",
            "diffusion_model_nemo_tpu/ops/norm.py:142",
        ),
        "linear_attention_block_v1": (
            A, "linear_attention_block_v1_cuda", A.linear_attention_block_reference,
            "diffusion_model_nemo_tpu_torch/csrc/linear_attention.cu",
            "diffusion_model_nemo_tpu/ops/attention.py:353",
        ),
    }


def copy_arg(a, dtype=None):
    """A copy of a recorded argument that keeps its strides (the DiT's k and
    v are strided slices of its qkv tensor), optionally in another dtype."""
    import torch

    if not torch.is_tensor(a):
        return a
    out = torch.empty_strided(a.size(), a.stride(), dtype=dtype or a.dtype, device=a.device)
    return out.copy_(a)


def call_key(name, args):
    """A recorded call's key: x's shape, and the FiLM scale's shape where
    the GroupNorm call has one."""
    key = tuple(args[0].shape)
    if name in FILM_KERNELS and len(args) > 5 and args[5] is not None:
        key += ("film",) + tuple(args[5].shape)
    return key


def record_calls(port, model, x, t, run=None):
    """One forward (or ``run()``); returns {kernel: {key: [count, copied args]}}."""
    import torch

    table = kernel_table(port)
    calls = {name: {} for name in table}
    with ExitStack() as stack:
        for name, (mod, attr, _plain, _src, _rep) in table.items():
            real = getattr(mod, attr)

            def recorder(*args, _name=name, _real=real):
                key = call_key(_name, args)
                slot = calls[_name].setdefault(key, [0, None])
                slot[0] += 1
                if slot[1] is None:
                    slot[1] = tuple(copy_arg(a) for a in args)
                return _real(*args)

            stack.enter_context(mock.patch.object(mod, attr, recorder))
        if run is None:
            model.forward(x, t)
        else:
            run()
    torch.cuda.synchronize()
    return calls


def plain_path(port):
    """Context in which every kernel wrapper is swapped for its plain version
    (for the reference forward only)."""
    stack = ExitStack()
    for mod, attr, plain, _src, _rep in kernel_table(port).values():
        stack.enter_context(mock.patch.object(mod, attr, plain))
    return stack


def work(name, args):
    """(bytes, operations, operation type) the function must move and do."""
    import torch

    x = args[0]
    es = x.element_size()
    kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
    if name == "attention":  # q, k, v in, out out; q·kᵀ and p·v
        Bn, Nn, h, d = x.shape
        return 4 * x.numel() * es, 4 * Bn * h * Nn * Nn * d, kind
    if name == "linear_attention_qkv":  # qkv in, out out; kᵀv and q·gram per head
        Bn, Nn, C3 = x.shape
        hd, dh = C3 // 3, 32
        return x.numel() * es + Bn * Nn * hd * es, Bn * Nn * 2 * 2 * hd * dh, kind
    if name.startswith("group_norm_silu"):
        Bn, H, W, C = x.shape
        n = x.numel()
        film = args[5:7] if len(args) > 5 and args[5] is not None else ()
        film_bytes = sum(a.numel() * a.element_size() for a in film)
        return 2 * n * es + 2 * C * 4 + film_bytes, (14 if film else 11) * n, "f32"
    Bn, Nn, C = x.shape
    hd = 128
    if name == "linear_attention_tokens":
        io_bytes = x.numel() * es + Bn * Nn * hd * es + C * 3 * hd * 4
        return io_bytes, Bn * Nn * (2 * C * 3 * hd + 2 * 2 * 32 * 32 * 4), "bf16"
    weights = (C * 3 * hd + hd * C + 3 * C) * 4 + 2 * C * 4
    io_bytes = 2 * x.numel() * es + weights
    if name in ("linear_attention_block", "linear_attention_block_v1"):
        ops = Bn * Nn * (2 * C * 3 * hd + 2 * 2 * 32 * 32 * 4 + 2 * hd * C)
    else:  # attention_block_small
        ops = Bn * (2 * Nn * C * 3 * hd + 2 * 2 * Nn * Nn * hd + 2 * Nn * hd * C)
    return io_bytes, ops, "bf16"


def library_fn(name, args):
    """One PyTorch call (or the sdpa composition) computing the same
    function, timed as a yardstick; None where there is none."""
    import torch
    import torch.nn.functional as F

    if name.startswith("group_norm_silu"):
        x, gamma, beta, groups, eps = args[:5]
        g, b = gamma.to(x.dtype), beta.to(x.dtype)
        xc = x.permute(0, 3, 1, 2)
        if len(args) == 5 or args[5] is None:
            return lambda: F.silu(F.group_norm(xc, groups, g, b, eps))
        sc1, sh = ((a.to(x.dtype) + d).permute(0, 3, 1, 2) for a, d in ((args[5], 1), (args[6], 0)))
        return lambda: F.silu(torch.addcmul(sh, F.group_norm(xc, groups, g, b, eps), sc1))
    if name == "attention":
        q, k, v = (a.transpose(1, 2) for a in args)  # [B, h, N, d] views
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)
    if name == "attention_block_small":
        x, ng, nb, wqkv, wout, bout, heads, dh, scale, eps = args
        Bn, Nn, C = x.shape
        dt = x.dtype
        ng_, nb_, wq, wo, bo = ng.to(dt), nb.to(dt), wqkv.t().to(dt), wout.t().to(dt), bout.to(dt)

        def run():
            h = F.group_norm(x.transpose(1, 2), 1, ng_, nb_, eps).transpose(1, 2)
            qkv = F.linear(h, wq).reshape(Bn, Nn, 3, heads, dh).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=scale)
            return F.linear(o.transpose(1, 2).reshape(Bn, Nn, heads * dh), wo, bo) + x

        return run
    return None


def check_kernels(port, calls_by_cfg):
    import torch

    table = kernel_table(port)
    rows = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0, "bytes_s": 0.0, "ops_s": 0.0, "shapes": 0,
                   "dev": 0.0, "plain_dev": 0.0, "library_dev": 0.0}
            for name in table}
    for cfg_name, calls in calls_by_cfg.items():
        for name, shapes in calls.items():
            mod, attr, plain, _src, _rep = table[name]
            wrapper = getattr(mod, attr)
            for key, (count, args) in sorted(shapes.items()):
                tol = TOL if args[0].dtype == torch.bfloat16 else F32_TOL
                out_k = wrapper(*args).float()
                out_p = plain(*args).float()
                torch.cuda.synchronize()
                err = (out_k - out_p).abs()
                max_err = float(err.max())
                ok = bool((err <= tol + tol * out_p.abs()).all()) and bool(torch.isfinite(out_k).all())
                k_ms = time_ms(lambda: wrapper(*args))
                p_ms = time_ms(lambda: plain(*args))
                lib = library_fn(name, args)
                l_ms = time_ms(lib) if lib is not None else None
                d_k = device_ms(lambda: wrapper(*args))
                d_p = device_ms(lambda: plain(*args))
                d_l = device_ms(lib) if lib is not None else None
                nbytes, ops, kind = work(name, args)
                t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
                bound = max(t_bytes, t_ops)
                log(
                    f"[kernel] {cfg_name} {name} {list(key)} {str(args[0].dtype)[6:]} x{count}/forward "
                    f"max_abs_err={max_err:.3e} ok={ok} (tol {tol}) ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"library_ms={'null' if l_ms is None else f'{l_ms:.4f}'} "
                    f"bound_ms={bound:.5f} ({'bytes' if t_bytes >= t_ops else 'operations'}) "
                    f"device_ms(kernel/plain/library)={fmt(d_k)}/{fmt(d_p)}/"
                    f"{'null' if lib is None else fmt(d_l)}"
                )
                if not ok:
                    raise AssertionError(
                        f"{name} at {list(key)} disagrees with its plain version "
                        f"(max |diff| {max_err:.3e}, rtol=atol={tol})"
                    )
                r = rows[name]
                r["max_abs_err"] = max(r["max_abs_err"], max_err)
                r["shapes"] += 1
                if cfg_name == MAIN_CFG[name]:  # per-forward sums on the main path
                    r["ms"] += count * k_ms
                    r["plain_ms"] += count * p_ms
                    r["bound_ms"] += count * bound
                    r["bytes_s"] += count * t_bytes
                    r["ops_s"] += count * t_ops
                    r["dev"] = add(r["dev"], None if d_k is None else count * d_k)
                    r["plain_dev"] = add(r["plain_dev"], None if d_p is None else count * d_p)
                    if l_ms is None:
                        r["library_ms"] = r["library_dev"] = None
                    elif r["library_ms"] is not None:
                        r["library_ms"] += count * l_ms
                        r["library_dev"] = add(r["library_dev"], None if d_l is None else count * d_l)
    return rows


# --------------------------------------------------------------------- phases --
def redraw_zero_leaves(model, std: float = 0.02) -> None:
    """adaLN-Zero makes a freshly initialised DiT output exactly zero (every
    image constant, every kernel check vacuous): redraw each all-zero leaf
    from a seeded N(0, std²), in params and ema_params alike."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    for name in sorted(model.params):
        p = model.params[name]
        if bool((p == 0).all()):
            draw = (torch.randn(p.shape, generator=g) * std).to(p.device)
            p.copy_(draw)
            model.ema_params[name].copy_(draw)


def build_models(port, device):
    from diffusion_model_nemo_tpu_torch.config import (
        dit_small_model_config, flagship_model_config, unet_small_model_config,
    )

    f32 = unet_small_model_config()
    f32["diffusion_model"]["dtype"] = "float32"
    dit = port.DDPM(dit_small_model_config(), device=device, seed=SEED)
    redraw_zero_leaves(dit)
    return {
        "unet_small": port.DDPM(unet_small_model_config(), device=device, seed=SEED),
        "flagship": port.DDPM(flagship_model_config(), device=device, seed=SEED),
        "unet_small_f32": port.DDPM(f32, device=device, seed=SEED),
        "dit_s2": dit,
    }


def model_inputs(device, size, batch=B):
    import torch

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(batch, size, size, 3, generator=g, device=device)
    t = torch.randint(0, 1000, (batch,), generator=g, device=device, dtype=torch.int32)
    return x, t


def per_forward_counts(calls):
    """{kernel: launches per forward} for the kernels a forward launched."""
    return {k: n for k, v in calls.items() if (n := sum(c for c, _ in v.values())) > 0}


def derived_calls(calls):
    """Kernel checks beyond the recorded dtypes: #7 at the DiT's shapes in
    float32, #8 in bf16 at the float32 U-Net's N=256 shape."""
    import torch

    att = {k: [c, tuple(copy_arg(a, torch.float32) for a in args)]
           for k, (c, args) in calls["dit_s2"]["attention"].items()}
    lin = {k: [c, (copy_arg(args[0], torch.bfloat16),) + args[1:]]
           for k, (c, args) in calls["unet_small_f32"]["linear_attention_qkv"].items() if k[1] == 256}
    return {"dit_s2_f32": {"attention": att}, "linattn_bf16": {"linear_attention_qkv": lin}}


def log_profile(tag, model, x, t):
    wall = time_ms(lambda: model.forward(x, t), iters=10)
    total, by_name = device_profile(lambda: model.forward(x, t), iters=5)
    hand = sum(v for n, v in by_name.items() if any(k in n for k in HAND_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {tag} forward B={B}: wall {wall:.3f} ms (CUDA events), device busy "
        f"{total:.3f} ms ({100 * total / wall:.1f}%), hand kernels {hand:.3f} ms, "
        f"other {total - hand:.3f} ms in {len(by_name)} kernel names")
    for n, v in top:
        log(f"[profile]   {v:.4f} ms  {n[:110]}")


def check_forward(port, name, model, x, t, tol):
    """Forward with kernels against the plain path: relative L2 <= tol."""
    import torch

    out_k = model.forward(x, t)
    with plain_path(port):
        out_p = model.forward(x, t)
    torch.cuda.synchronize()
    rel = float((out_k - out_p).norm() / out_p.norm())
    max_abs = float((out_k - out_p).abs().max())
    finite = bool(torch.isfinite(out_k).all())
    std = float(out_k.std())
    log(f"[forward] {name} B={x.shape[0]} kernels vs plain: rel_l2={rel:.3e} max_abs={max_abs:.3e} "
        f"finite={finite} std={std:.4f} shape={list(out_k.shape)} (tol rel_l2 <= {tol})")
    if not finite or rel > tol or tuple(out_k.shape) != tuple(x.shape) or not std > 0:
        raise AssertionError(f"{name} forward with kernels disagrees with the plain path")


def check_networks(port, models, inputs):
    """Phase 3 for the bf16 networks: U-Nets and DiT-S/2."""
    log_profile("unet_small", models["unet_small"], *inputs["unet_small"])
    log_profile("dit_s2", models["dit_s2"], *inputs["dit_s2"])
    for name in ("unet_small", "flagship", "dit_s2"):
        check_forward(port, name, models[name], *inputs[name], UNET_REL_TOL)


def check_float32_route(port, model, x, t, per_forward):
    """float32 on CUDA: the GroupNorm kernel takes f32 and agrees with its
    plain version; the float32 unet_small forward agrees with its plain path
    and launches kernel #8 five times (down 0-2, up 1-2); a 10-step DDIM
    chain launches it 5 x 10 times. Returns the chain's launch counts."""
    import torch

    g = torch.Generator(device=x.device).manual_seed(SEED)
    xs = torch.randn(B, 32, 32, 32, generator=g, device=x.device)
    gamma = 1.0 + 0.1 * torch.randn(32, generator=g, device=x.device)
    beta = 0.1 * torch.randn(32, generator=g, device=x.device)
    out_k = port.ops.norm.group_norm_silu_cuda(xs, gamma, beta, 8)
    out_p = port.ops.norm.group_norm_silu_reference(xs, gamma, beta, 8)
    err = float((out_k - out_p).abs().max())
    log(f"[f32] group_norm_silu float32 [64, 32, 32, 32]: max_abs_err={err:.3e} (tol {F32_TOL})")
    assert err <= F32_TOL, err
    assert per_forward.get("linear_attention_qkv") == 5, per_forward
    port.ops.reset_launch_counts()
    model.forward(x, t)
    torch.cuda.synchronize()
    counts = port.ops.launch_counts()
    log(f"[f32] unet_small float32 forward launches: {counts}")
    assert all(counts[k] == per_forward.get(k, 0) for k in counts), (counts, per_forward)
    check_forward(port, "unet_small_f32", model, x, t, F32_REL_TOL)

    steps = 10
    sampler_cfg = dict(model.cfg.sampler, eta=0.0, ddim_timesteps=steps,
                       _target_="diffusion_model_nemo.modules.GeneralizedGaussianDiffusion")
    model.change_sampler(sampler_cfg)
    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.sample(B, 32, generator=torch.Generator(device=x.device).manual_seed(SEED))
    torch.cuda.synchronize()
    counts = port.ops.launch_counts()
    finite = bool(torch.isfinite(out).all())
    log(f"[f32] DDIM-{steps} float32 unet_small B={B}: {time.perf_counter() - t0:.3f} s, "
        f"finite={finite}, std={float(out.std()):.4f}, launches={counts}")
    assert finite and tuple(out.shape) == (B, 32, 32, 3) and float(out.std()) > 0
    assert all(counts[k] == per_forward.get(k, 0) * steps for k in counts), (counts, per_forward)
    return counts


def http(method, url, payload=None, timeout=600):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def check_serving(port, tag, model, per_forward, max_batch, size):
    """/healthz, concurrent png + npy requests, one seed twice, /stats; every
    kernel's launches equal per-forward x DDIM_STEPS x batches (0 off the path)."""
    import numpy as np

    from diffusion_model_nemo_tpu_torch.serving import serve
    from diffusion_model_nemo_tpu_torch.utils.image import decode_png

    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(model, port=0, max_batch=max_batch, ddim_timesteps=DDIM_STEPS, use_ema=True)
    log(f"[serve] {tag} DDIM-{DDIM_STEPS} max_batch={max_batch} warm-up batch "
        f"{time.perf_counter() - t0:.2f} s")
    server.start_background()
    base = f"http://{server.host}:{server.port}"
    try:
        code, body = http("GET", base + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok" and health["warm"], health
        results = {}

        def request(key, payload):
            results[key] = http("POST", base + "/sample", payload)

        t1 = time.perf_counter()
        threads = [
            threading.Thread(target=request, args=("png", {"num_images": 5, "format": "png"})),
            threading.Thread(target=request, args=("npy", {"num_images": 40, "format": "npy"})),
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
            assert not th.is_alive(), "a concurrent request did not finish"
        request("seed_a", {"num_images": 3, "seed": 1234, "format": "npy"})
        request("seed_b", {"num_images": 3, "seed": 1234, "format": "npy"})
        wall = time.perf_counter() - t1
        code, body = http("GET", base + "/stats")
        stats = json.loads(body)
    finally:
        server.shutdown()

    assert all(r[0] == 200 for r in results.values()), {k: r[0] for k, r in results.items()}
    pngs = json.loads(results["png"][1])["images"]
    assert len(pngs) == 5
    for p in pngs:
        img = decode_png(base64.b64decode(p))
        assert img.shape == (size, size, 3) and img.dtype == np.uint8, img.shape
    npy = np.load(io.BytesIO(results["npy"][1]))
    assert npy.shape == (40, size, size, 3) and npy.dtype == np.uint8, (npy.shape, npy.dtype)
    a = np.load(io.BytesIO(results["seed_a"][1]))
    b = np.load(io.BytesIO(results["seed_b"][1]))
    assert a.shape == (3, size, size, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b), "the seeded request did not repeat bit for bit"
    assert npy.std() > 0, "served images are constant"

    counts = port.ops.launch_counts()
    batches = stats["batches"] + 1  # + the warm-up batch
    images = stats["images"]
    log(f"[serve] {tag} stats={json.dumps(stats)}")
    log(f"[serve] {tag} {stats['requests']} requests, {images} images in {wall:.3f} s: "
        f"{images / wall:.2f} images/s requested, {max_batch * stats['batches'] / wall:.2f} images/s "
        f"computed, mean latency {stats['avg_request_latency_ms']:.1f} ms; seeded repeat bit-exact")
    for name, n in counts.items():
        per = per_forward.get(name, 0)
        expect = per * DDIM_STEPS * batches
        log(f"[serve] {tag} launches {name}: {n} (expected {per}/forward x {DDIM_STEPS} x {batches})")
        assert n == expect, (name, n, expect)
    assert all(counts[name] > 0 for name in per_forward), counts
    return counts


def check_ancestral(port, model, per_forward):
    import torch

    steps = 10
    sampler_cfg = {k: v for k, v in model.cfg.sampler.items() if k not in ("eta", "ddim_timesteps")}
    sampler_cfg["_target_"] = "diffusion_model_nemo.modules.GaussianDiffusion"
    model.change_sampler(sampler_cfg)
    port.ops.reset_launch_counts()
    g = torch.Generator(device=model.device).manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = model.sampler.p_sample_loop(
            model.get_model_fn(), model.params, (B, 32, 32, 3), g, num_steps=steps
        )
    torch.cuda.synchronize()
    counts = port.ops.launch_counts()
    finite = bool(torch.isfinite(out).all())
    log(f"[ancestral] p_sample_loop(num_steps={steps}) B={B}: {time.perf_counter() - t0:.3f} s, "
        f"finite={finite}, shape={list(out.shape)}, launches={counts}")
    assert finite and tuple(out.shape) == (B, 32, 32, 3)
    for name, n in counts.items():
        assert n == per_forward.get(name, 0) * steps, (name, n, per_forward.get(name, 0) * steps)


# --------------------------------------------------------- the training slice --
def switches(env):
    """The JAX package's opt-in switches, read by the port at call time."""
    return mock.patch.dict(os.environ, env)


def kernel_name(kernel) -> str:
    return kernel.__name__.removesuffix("_cuda")


def derived_counts(port, model, B, size):
    """Launches per forward the gates choose at this batch under the current
    switches: a shapes-only forward of the same network on meta tensors,
    every differentiable kernel call recorded by its wrapper's name."""
    import torch

    cfg = dict(model.cfg.diffusion_model)
    net = port.config.get_target(cfg.pop("_target_"))(**cfg).to("meta")
    counts = {}

    def record(kernel, plain, *args):
        counts[kernel_name(kernel)] = counts.get(kernel_name(kernel), 0) + 1
        return plain(*args)

    with mock.patch.object(port.ops.norm, "kernel_call", record), \
            mock.patch.object(port.ops.attention, "kernel_call", record):
        net(torch.empty(B, size, size, 3, device="meta"), torch.empty(B, dtype=torch.int32, device="meta"))
    return counts


def assert_counts(tag, counts, expect):
    full = {k: expect.get(k, 0) for k in counts}
    log(f"[train] {tag} launches {json.dumps({k: v for k, v in counts.items() if v})} "
        f"(expected {json.dumps({k: v for k, v in full.items() if v})})")
    assert counts == full, (tag, counts, full)


def check_switched_forwards(port, models, inputs):
    """6a: unet_small and flagship at B=128 under each switch: launches per
    forward equal the gates' derivation; output against the plain path."""
    import torch

    derived = {}
    for name in ("unet_small", "flagship"):
        model, (x, t) = models[name], inputs[name]
        for tag, env in (("NORM_BM", NORM_BM), ("LINATTN_BLOCK", LINATTN_BLOCK)):
            with switches(env):
                expect = derived_counts(port, model, x.shape[0], x.shape[1])
                port.ops.reset_launch_counts()
                model.forward(x, t)
                torch.cuda.synchronize()
                assert_counts(f"{name} B={x.shape[0]} {tag} forward", port.ops.launch_counts(), expect)
                check_forward(port, f"{name} {tag}", model, x, t, UNET_REL_TOL)
            derived[(name, tag)] = expect
    return derived


class FilmPath:
    """``Block(x, scale_shift)`` at each GroupNorm site of a network: per
    site a bf16 conv3x3 -> GroupNorm -> FiLM -> SiLU block whose per-sample
    (scale, shift) [B, 1, 1, C] come from a time MLP (Dense of a sinusoidal
    embedding), seeded random weights. One pass = every site once, forward,
    then the backward of the mean square of the outputs."""

    def __init__(self, port, sites, device):
        import torch

        parts = port.modules.parts
        self.ops = port.ops
        g = torch.Generator().manual_seed(SEED)
        dg = torch.Generator(device=device).manual_seed(SEED)
        self.sites = []
        for (Bn, H, W, C) in sites:
            block = parts.Block(C, C, groups=8, dtype=torch.bfloat16)
            mlp = parts.Dense(128, 2 * C, dtype=torch.bfloat16)
            block.proj.reset_parameters(g)
            mlp.reset_parameters(g)
            x = torch.randn(Bn, H, W, C, generator=dg, device=device).to(torch.bfloat16)
            self.sites.append((block.to(device), mlp.to(device), x))
        self.temb = parts.SinusoidalPositionEmbeddings(128)(
            torch.randint(0, 1000, (sites[0][0],), generator=dg, device=device))

    def forward(self):
        outs = []
        for block, mlp, x in self.sites:
            scale, shift = mlp(self.temb)[:, None, None, :].chunk(2, dim=-1)
            outs.append(block(x, (scale, shift)))
        return outs

    def run(self):
        """Forward and backward; returns (outputs, launches in the forward,
        launches in the backward)."""
        import torch

        self.ops.reset_launch_counts()
        outs = self.forward()
        torch.cuda.synchronize()
        fwd = self.ops.launch_counts()
        loss = sum(o.float().square().mean() for o in outs)
        self.ops.reset_launch_counts()
        loss.backward()
        torch.cuda.synchronize()
        return outs, fwd, self.ops.launch_counts()


def check_film_path(port, path):
    """6b: the FiLM Block pass with kernels against the plain path; #5 at
    every site (#6 at the batch-minor ones under NORM_BM); no launch in the
    backward. Returns the launches of its main run (the forward)."""
    import torch

    sites = [tuple(x.shape) for _b, _m, x in path.sites]
    out_k, fwd, bwd = path.run()
    assert_counts("FiLM Block pass forward", fwd, {"group_norm_silu_film": len(sites)})
    assert_counts("FiLM Block pass backward", bwd, {})
    with plain_path(port):
        out_p = path.forward()
    k = torch.cat([o.detach().float().flatten() for o in out_k])
    p = torch.cat([o.float().flatten() for o in out_p])
    rel = float((k - p).norm() / p.norm())
    log(f"[train] FiLM Block pass ({len(sites)} sites, B={sites[0][0]}) kernels vs plain: rel_l2={rel:.3e} "
        f"(tol {UNET_REL_TOL}), finite={bool(torch.isfinite(k).all())}")
    assert rel <= UNET_REL_TOL and bool(torch.isfinite(k).all())
    with switches(NORM_BM):
        n_bm = sum(port.ops.norm.use_norm_bm(s, torch.bfloat16, s[0] * s[3]) for s in sites)
        _out, fwd_bm, bwd_bm = path.run()
    assert_counts("FiLM Block pass under NORM_BM forward", fwd_bm,
                  {"group_norm_silu_bm": n_bm, "group_norm_silu_film": len(sites) - n_bm})
    assert_counts("FiLM Block pass under NORM_BM backward", bwd_bm, {})
    return fwd


def training_batch(model, B):
    """A synthetic uint8 batch and seeded draws for one training step."""
    import numpy as np
    import torch

    from diffusion_model_nemo_tpu_torch.data import SyntheticVisionDataset

    ds = SyntheticVisionDataset(image_size=32, channels=3, length=B, seed=SEED)
    batch = {"image": np.stack([ds[i]["image"] for i in range(B)])}
    draws = model.draw_training_inputs(batch["image"].shape, torch.Generator(device=model.device).manual_seed(SEED))
    return batch, draws


def step_loss_and_grads(port, model, batch, draws):
    """(loss, flat gradient, launches in the forward, in the backward)."""
    import torch

    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.params.items()}
    port.ops.reset_launch_counts()
    loss, _ = model.training_step(params, batch, draws)
    torch.cuda.synchronize()
    fwd = port.ops.launch_counts()
    port.ops.reset_launch_counts()
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    bwd = port.ops.launch_counts()
    return float(loss), torch.cat([g.float().flatten() for g in grads]), fwd, bwd


def check_training_step(port, model, per_forward):
    """6c: one unet_small training step at B=128, kernels against the plain
    path from the same weights and draws."""
    batch, draws = training_batch(model, TRAIN_B)
    loss_k, g_k, fwd, bwd = step_loss_and_grads(port, model, batch, draws)
    assert_counts("training step forward", fwd, per_forward)
    assert_counts("training step backward", bwd, {})
    with plain_path(port):
        loss_p, g_p, _, _ = step_loss_and_grads(port, model, batch, draws)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    rel_grad = float((g_k - g_p).norm() / g_p.norm())
    log(f"[train] unet_small step B={TRAIN_B}: loss kernels {loss_k:.6f} plain {loss_p:.6f} "
        f"(rel {rel_loss:.3e}, tol {LOSS_REL_TOL}); whole gradient ({g_k.numel()} values) rel_l2="
        f"{rel_grad:.3e} (tol {GRAD_REL_TOL}), |g| {float(g_k.norm()):.4f}")
    assert rel_loss <= LOSS_REL_TOL and rel_grad <= GRAD_REL_TOL
    return batch, draws


def training_kernel_costs(port, model, batch, draws):
    """Per kernel call of one training step: the kernel's time (forward)
    against its backward, which recomputes the plain version and
    differentiates it (CUDA events, summed over the step's calls)."""
    import torch

    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.params.items()}
    calls = record_calls(port, None, None, None, run=lambda: model.training_step(params, batch, draws))
    table = kernel_table(port)
    fwd_total = bwd_total = 0.0
    for name, shapes in calls.items():
        mod, attr, plain, _src, _rep = table[name]
        for key, (count, args) in sorted(shapes.items()):
            kernel = getattr(mod, attr)
            leaves = [a.detach().requires_grad_(True) if torch.is_tensor(a) and a.is_floating_point() else a
                      for a in args]
            wrt = [a for a in leaves if torch.is_tensor(a) and a.requires_grad]
            out = plain(*leaves)
            cot = torch.randn_like(out)

            def backward():
                with torch.enable_grad():
                    torch.autograd.grad(plain(*leaves), wrt, cot)

            k_ms, b_ms = time_ms(lambda: kernel(*args)), time_ms(backward)
            fwd_total += count * k_ms
            bwd_total += count * b_ms
            log(f"[train-cost] {name} {list(key)} x{count}/step kernel {k_ms:.4f} ms, "
                f"backward (plain recompute + vjp) {b_ms:.4f} ms")
    log(f"[train-cost] per step at B={TRAIN_B}: hand kernels {fwd_total:.3f} ms (forward), their "
        f"backwards {bwd_total:.3f} ms (CUDA events, call by call)")
    return fwd_total, bwd_total


def check_fit(port, device, steps, env, expect_per_step):
    """6d: ``Trainer.fit`` of unet_small at B=128 on the synthetic set."""
    import torch

    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config

    cfg = unet_small_model_config()
    cfg["train_ds"]["name"] = "synthetic"
    model = port.DDPM(cfg, device=device, seed=SEED)
    ema0 = {k: v.clone() for k, v in model.ema_params.items()}
    trainer = port.Trainer(max_steps=steps, log_every_n_steps=5, devices=1, seed=SEED)
    with switches(env):
        port.ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = port.ops.launch_counts()
    tag = "+".join(env) or "default routes"
    losses = [m["train_loss"] for m in trainer.logged]
    moved = max(float((model.ema_params[k] - ema0[k]).abs().max()) for k in ema0)
    log(f"[train] fit {steps} steps B={TRAIN_B} ({tag}): {wall:.2f} s with set-up; logged "
        f"{json.dumps(trainer.logged)}; EMA moved max |d| {moved:.3e}")
    assert len(losses) == steps // 5 and all(map(lambda v: v == v and abs(v) < 1e6, losses)), losses
    assert moved > 0
    assert_counts(f"fit {steps} steps ({tag})", counts, {k: v * steps for k, v in expect_per_step.items()})
    return model, trainer, counts


def step_profile(port, model):
    """Wall time per optimizer step (CUDA events over 20 steps), device busy
    per step (torch.profiler) and its share."""
    trainer = port.Trainer(max_steps=TRAIN_STEPS, devices=1)
    state = trainer.init_state(model, TRAIN_STEPS)
    batch, draws = training_batch(model, TRAIN_B)
    run = lambda: trainer.train_step(model, state, batch, draws)  # noqa: E731
    wall = time_ms(run, iters=20)
    total, by_name = device_profile(run, iters=5)
    hand = sum(v for n, v in by_name.items() if any(k in n for k in HAND_KERNELS))
    log(f"[train] step B={TRAIN_B}: wall {wall:.3f} ms (CUDA events), {TRAIN_B / wall * 1e3:.1f} samples/s; "
        f"device busy {total:.3f} ms ({100 * total / wall:.1f}%), hand kernels {hand:.3f} ms, "
        f"other {total - hand:.3f} ms in {len(by_name)} kernel names")
    for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[train]   {v:.4f} ms  {n[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    import diffusion_model_nemo_tpu_torch as port
    from diffusion_model_nemo_tpu_torch.ops import _build

    banned = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "diffusion_model_nemo_tpu"))
    assert not banned, f"the port loaded {banned}"
    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.load_kernels()
    log(f"[build] {len(libs)} kernel libraries ({len(kernel_table(port))} kernels) built and loaded "
        f"in {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds['total']:.2f} s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[setup] TF32 off for convolutions and matmuls (cudnn.allow_tf32 = matmul.allow_tf32 = False)")

    models = build_models(port, device)
    inputs = {name: model_inputs(device, DIT_IMG if name == "dit_s2" else 32) for name in models}
    calls = {name: record_calls(port, m, *inputs[name]) for name, m in models.items()}
    # The training slice's shapes at B=128: the default routes (#1-#4), both
    # switches (#6, #9), and the FiLM Block pass at unet_small's GroupNorm
    # sites (#5, and #6 FiLM under NORM_BM).
    inputs128 = {name: model_inputs(device, 32, TRAIN_B) for name in ("unet_small", "flagship")}
    calls["unet_small_128"] = record_calls(port, models["unet_small"], *inputs128["unet_small"])
    new = ("group_norm_silu_bm", "linear_attention_block_v1")
    with switches(BOTH):
        for name in ("unet_small", "flagship"):
            rec = record_calls(port, models[name], *inputs128[name])
            calls[f"{name}_128_switched"] = {k: (v if k in new else {}) for k, v in rec.items()}
    sites = [key for key, (count, _a) in sorted(calls["unet_small_128"]["group_norm_silu"].items())
             for _ in range(count)]
    film = FilmPath(port, sites, device)
    calls["film_block"] = record_calls(port, None, None, None, run=film.forward)
    with switches(NORM_BM):
        rec = record_calls(port, None, None, None, run=film.forward)
    calls["film_block_bm"] = {k: (v if k == "group_norm_silu_bm" else {}) for k, v in rec.items()}
    per_forward = {name: per_forward_counts(c) for name, c in calls.items()}
    log(f"[path] launches per forward (B={B}; *_128*: B={TRAIN_B}; film_block: per pass): {per_forward}")
    assert per_forward["dit_s2"] == {"attention": 12}, per_forward["dit_s2"]
    rows = check_kernels(port, {**calls, **derived_calls(calls)})
    check_networks(port, models, inputs)
    f32_counts = check_float32_route(
        port, models["unet_small_f32"], *inputs["unet_small_f32"], per_forward["unet_small_f32"]
    )
    counts = check_serving(port, "unet_small", models["unet_small"], per_forward["unet_small"], B, 32)
    dit_counts = check_serving(
        port, "dit_s2", models["dit_s2"], per_forward["dit_s2"], DIT_MAX_BATCH, DIT_IMG
    )
    check_ancestral(port, models["unet_small"], per_forward["unet_small"])

    # 6. The training slice.
    derived = check_switched_forwards(port, models, inputs128)
    film_counts = check_film_path(port, film)
    train_per = per_forward["unet_small_128"]
    batch, draws = check_training_step(port, models["unet_small"], train_per)
    training_kernel_costs(port, models["unet_small"], batch, draws)
    step_profile(port, models["unet_small"])
    check_fit(port, device, TRAIN_STEPS, {}, train_per)
    with switches(BOTH):
        switched_per = derived_counts(port, models["unet_small"], TRAIN_B, 32)
    log(f"[train] per forward under both switches at B={TRAIN_B} (gates): {switched_per}; "
        f"each switch alone: {json.dumps({'+'.join(k): v for k, v in derived.items()})}")
    assert switched_per.get("group_norm_silu_bm") == 27 and switched_per.get("linear_attention_block_v1") == 1
    assert "linear_attention_tokens" not in switched_per, switched_per
    _m, _t, sw_counts = check_fit(port, device, SWITCHED_STEPS, BOTH, switched_per)

    # Launches from each kernel's main-path run: unet_small serving for #1-#4,
    # DiT-S/2 serving for #7, the float32 DDIM-10 chain for #8, the FiLM
    # Block pass for #5, the 5-step training run under both switches for #6
    # and #9.
    main_counts = dict(counts, attention=dit_counts["attention"],
                       linear_attention_qkv=f32_counts["linear_attention_qkv"],
                       group_norm_silu_film=film_counts["group_norm_silu_film"],
                       group_norm_silu_bm=sw_counts["group_norm_silu_bm"],
                       linear_attention_block_v1=sw_counts["linear_attention_block_v1"])
    main_per = {name: per_forward[MAIN_CFG[name]].get(name, 0) for name in rows}
    table = kernel_table(port)
    log(f"[summary] per forward on each kernel's main path (ms: CUDA events; dev: "
        f"torch.profiler device time); main path: {MAIN_CFG}")
    log("[summary] | kernel | launches/forward on its path (flagship) | launches in the path's run "
        "| ms | dev ms | bound ms (by) | plain ms | plain dev ms | library ms | library dev ms |")
    for name, r in rows.items():
        by = "bytes" if r["bytes_s"] >= r["ops_s"] else "operations"
        lib_ms = "—" if r["library_ms"] is None else fmt(r["library_ms"])
        lib_dev = "—" if r["library_ms"] is None else fmt(r["library_dev"])
        flag = per_forward["flagship_128_switched" if name in new else "flagship"].get(name, 0)
        log(f"[summary] | {name} | {main_per[name]} ({flag}) | "
            f"{main_counts[name]} | {fmt(r['ms'])} | {fmt(r['dev'])} | "
            f"{fmt(r['bound_ms'], 5)} ({by}) | {fmt(r['plain_ms'])} | {fmt(r['plain_dev'])} | "
            f"{lib_ms} | {lib_dev} |")
    kernels = []
    for name, r in rows.items():
        _mod, _attr, _plain, src, rep = table[name]
        assert main_counts[name] > 0, (name, main_counts)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": main_counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_s"] >= r["ops_s"] else "operations",
            "library_ms": r["library_ms"],
        })
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card_line())  # as nvidia-smi gives it, on its own line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
