#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one GPU and check it.

    python3 chip_smoke.py            # all phases, one card

Phases:
  1. Print the card (``nvidia-smi`` name and power limit) and build the
     hand-written Hopper kernels from ``diffusion_model_nemo_tpu_torch/csrc``.
  2. Hold every kernel against its plain PyTorch version on the card, at
     every shape the unet_small and flagship U-Nets send it at B=64 (inputs
     recorded from a real forward), in bf16 at rtol = atol = 2e-2 (the JAX
     package's kernel-test tolerance); time kernel, plain version, a
     one-call PyTorch yardstick where one exists (CUDA events around 20
     back-to-back calls, so host launch gaps count where the host is the
     limit; the logs add the device time per call from torch.profiler), and
     the least time the card could take (bytes at 3.35 TB/s or operations at
     the peak rate of their type, whichever is larger).
  3. One U-Net forward at B=64 per configuration with the kernels, against
     the same forward with every kernel swapped for its plain version
     (TF32 off for both); a device-time breakdown of the unet_small forward;
     the GroupNorm kernel in float32, and a float32 U-Net raising
     NotImplementedError for the unported kernel #8.
  4. The main path: ``SamplingServer`` on unet_small (full width, random
     weights from a seed) with DDIM-50 and max_batch=64 answers /healthz,
     /stats and /sample requests (concurrent png + npy, one seed twice); the
     images decode, the seeded one repeats bit for bit, and every kernel's
     launch count equals its per-forward count x 50 steps x batches.
  5. A short ancestral chain (p_sample_loop, 10 steps).

The last two lines are a JSON object with one entry per kernel and the
result line {"ok": true, "device": {...}}. Any failure exits non-zero and
prints no result. Without a CUDA device, or outside the repository, it fails.
"""

from __future__ import annotations

import base64
import io
import json
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
UNET_REL_TOL = 3e-2  # whole U-Net, kernels vs plain path, relative L2 in bf16
DDIM_STEPS = 50
SEED = 0


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
    "outnorm_kernel", "attn_block_small_kernel",
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
    }


def record_calls(port, model, x, t):
    """One forward; returns {kernel: {shape: [count, cloned args]}}."""
    import torch

    table = kernel_table(port)
    calls = {name: {} for name in table}
    with ExitStack() as stack:
        for name, (mod, attr, _plain, _src, _rep) in table.items():
            real = getattr(mod, attr)

            def recorder(*args, _name=name, _real=real):
                key = tuple(args[0].shape)
                slot = calls[_name].setdefault(key, [0, None])
                slot[0] += 1
                if slot[1] is None:
                    slot[1] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                return _real(*args)

            stack.enter_context(mock.patch.object(mod, attr, recorder))
        model.forward(x, t)
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
    x = args[0]
    es = x.element_size()
    if name == "group_norm_silu":
        Bn, H, W, C = x.shape
        n = x.numel()
        return 2 * n * es + 2 * C * 4, 11 * n, "f32"
    Bn, Nn, C = x.shape
    hd = 128
    if name == "linear_attention_tokens":
        io_bytes = x.numel() * es + Bn * Nn * hd * es + C * 3 * hd * 4
        return io_bytes, Bn * Nn * (2 * C * 3 * hd + 2 * 2 * 32 * 32 * 4), "bf16"
    weights = (C * 3 * hd + hd * C + 3 * C) * 4 + 2 * C * 4
    io_bytes = 2 * x.numel() * es + weights
    if name == "linear_attention_block":
        ops = Bn * Nn * (2 * C * 3 * hd + 2 * 2 * 32 * 32 * 4 + 2 * hd * C)
    else:  # attention_block_small
        ops = Bn * (2 * Nn * C * 3 * hd + 2 * 2 * Nn * Nn * hd + 2 * Nn * hd * C)
    return io_bytes, ops, "bf16"


def library_fn(name, args):
    """One PyTorch call (or the sdpa composition) computing the same
    function, timed as a yardstick; None where there is none."""
    import torch
    import torch.nn.functional as F

    if name == "group_norm_silu":
        x, gamma, beta, groups, eps = args
        g, b = gamma.to(x.dtype), beta.to(x.dtype)
        xc = x.permute(0, 3, 1, 2)
        return lambda: F.silu(F.group_norm(xc, groups, g, b, eps))
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
                out_k = wrapper(*args).float()
                out_p = plain(*args).float()
                torch.cuda.synchronize()
                err = (out_k - out_p).abs()
                max_err = float(err.max())
                ok = bool((err <= TOL + TOL * out_p.abs()).all()) and bool(torch.isfinite(out_k).all())
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
                    f"[kernel] {cfg_name} {name} {list(key)} x{count}/forward "
                    f"max_abs_err={max_err:.3e} ok={ok} ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"library_ms={'null' if l_ms is None else f'{l_ms:.4f}'} "
                    f"bound_ms={bound:.5f} ({'bytes' if t_bytes >= t_ops else 'operations'}) "
                    f"device_ms(kernel/plain/library)={fmt(d_k)}/{fmt(d_p)}/"
                    f"{'null' if lib is None else fmt(d_l)}"
                )
                if not ok:
                    raise AssertionError(
                        f"{name} at {list(key)} disagrees with its plain version "
                        f"(max |diff| {max_err:.3e}, rtol=atol={TOL})"
                    )
                r = rows[name]
                r["max_abs_err"] = max(r["max_abs_err"], max_err)
                r["shapes"] += 1
                if cfg_name == "unet_small":  # per-forward sums on the main path
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
def build_models(port, device):
    from diffusion_model_nemo_tpu_torch.config import flagship_model_config, unet_small_model_config

    return {
        "unet_small": port.DDPM(unet_small_model_config(), device=device, seed=SEED),
        "flagship": port.DDPM(flagship_model_config(), device=device, seed=SEED),
    }


def unet_inputs(device):
    import torch

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(B, 32, 32, 3, generator=g, device=device)
    t = torch.randint(0, 1000, (B,), generator=g, device=device, dtype=torch.int32)
    return x, t


def check_unet(port, models, x, t):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[unet] TF32 off for convolutions and matmuls (cudnn.allow_tf32 = matmul.allow_tf32 = False)")
    wall = time_ms(lambda: models["unet_small"].forward(x, t), iters=10)
    total, by_name = device_profile(lambda: models["unet_small"].forward(x, t), iters=5)
    hand = sum(v for n, v in by_name.items() if any(k in n for k in HAND_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] unet_small forward B={B}: wall {wall:.3f} ms (CUDA events), device busy "
        f"{total:.3f} ms ({100 * total / wall:.1f}%), hand kernels {hand:.3f} ms, "
        f"other {total - hand:.3f} ms in {len(by_name)} kernel names")
    for n, v in top:
        log(f"[profile]   {v:.4f} ms  {n[:110]}")
    for name, model in models.items():
        out_k = model.forward(x, t)
        with plain_path(port):
            out_p = model.forward(x, t)
        torch.cuda.synchronize()
        rel = float((out_k - out_p).norm() / out_p.norm())
        max_abs = float((out_k - out_p).abs().max())
        finite = bool(torch.isfinite(out_k).all())
        log(f"[unet] {name} B={B} kernels vs plain: rel_l2={rel:.3e} max_abs={max_abs:.3e} "
            f"finite={finite} shape={list(out_k.shape)} (tol rel_l2 <= {UNET_REL_TOL})")
        if not finite or rel > UNET_REL_TOL or tuple(out_k.shape) != (B, 32, 32, 3):
            raise AssertionError(f"{name} U-Net forward with kernels disagrees with the plain path")
    check_float32_route(port, x, t)


def check_float32_route(port, x, t):
    """float32 on CUDA: the GroupNorm kernel takes f32 and agrees with its
    plain version; the U-Net raises NotImplementedError naming TPU kernel #8
    (the JAX package's float32 linear-attention route), with no torch
    substitute."""
    import torch

    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config

    g = torch.Generator(device=x.device).manual_seed(SEED)
    xs = torch.randn(B, 32, 32, 32, generator=g, device=x.device)
    gamma = 1.0 + 0.1 * torch.randn(32, generator=g, device=x.device)
    beta = 0.1 * torch.randn(32, generator=g, device=x.device)
    out_k = port.ops.norm.group_norm_silu_cuda(xs, gamma, beta, 8)
    out_p = port.ops.norm.group_norm_silu_reference(xs, gamma, beta, 8)
    err = float((out_k - out_p).abs().max())
    log(f"[f32] group_norm_silu float32 [64, 32, 32, 32]: max_abs_err={err:.3e} (tol 1e-4)")
    assert err <= 1e-4, err
    cfg = unet_small_model_config()
    cfg["diffusion_model"]["dtype"] = "float32"
    model = port.DDPM(cfg, device=x.device, seed=SEED)
    try:
        model.forward(x, t)
    except NotImplementedError as e:
        assert "#8" in str(e), e
        log(f"[f32] float32 unet_small forward raises NotImplementedError: {e}")
    else:
        raise AssertionError("a float32 CUDA U-Net ran without TPU kernel #8's port")


def http(method, url, payload=None, timeout=600):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def check_serving(port, model, per_forward):
    import numpy as np

    from diffusion_model_nemo_tpu_torch.serving import serve
    from diffusion_model_nemo_tpu_torch.utils.image import decode_png

    port.ops.reset_launch_counts()
    t0 = time.perf_counter()
    server = serve(model, port=0, max_batch=B, ddim_timesteps=DDIM_STEPS, use_ema=True)
    log(f"[serve] DDIM-{DDIM_STEPS} max_batch={B} warm-up batch {time.perf_counter() - t0:.2f} s")
    server.start_background()
    base = f"http://{server.host}:{server.port}"
    try:
        code, body = http("GET", base + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok" and health["warm"], health
        results = {}

        def request(tag, payload):
            results[tag] = http("POST", base + "/sample", payload)

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
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8, img.shape
    npy = np.load(io.BytesIO(results["npy"][1]))
    assert npy.shape == (40, 32, 32, 3) and npy.dtype == np.uint8, (npy.shape, npy.dtype)
    a = np.load(io.BytesIO(results["seed_a"][1]))
    b = np.load(io.BytesIO(results["seed_b"][1]))
    assert a.shape == (3, 32, 32, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b), "the seeded request did not repeat bit for bit"
    assert npy.std() > 0, "served images are constant"

    counts = port.ops.launch_counts()
    batches = stats["batches"] + 1  # + the warm-up batch
    images = stats["images"]
    log(f"[serve] stats={json.dumps(stats)}")
    log(f"[serve] {stats['requests']} requests, {images} images in {wall:.3f} s: "
        f"{images / wall:.2f} images/s requested, {B * stats['batches'] / wall:.2f} images/s "
        f"computed, mean latency {stats['avg_request_latency_ms']:.1f} ms; seeded repeat bit-exact")
    for name, per in per_forward.items():
        expect = per * DDIM_STEPS * batches
        log(f"[serve] launches {name}: {counts[name]} (expected {per}/forward x {DDIM_STEPS} x {batches})")
        assert counts[name] == expect and counts[name] > 0, (name, counts[name], expect)
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
    for name, per in per_forward.items():
        assert counts[name] == per * steps, (name, counts[name], per * steps)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    import diffusion_model_nemo_tpu_torch as port
    from diffusion_model_nemo_tpu_torch.ops import _build

    banned = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "diffusion_model_nemo_tpu"))
    assert not banned, f"the port loaded {banned}"
    device = torch.device("cuda")
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_kernels()
    log(f"[build] 3 kernel libraries (4 kernels) built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds['total']:.2f} s)")

    models = build_models(port, device)
    x, t = unet_inputs(device)
    calls = {name: record_calls(port, m, x, t) for name, m in models.items()}
    per_forward = {k: sum(c for c, _ in v.values()) for k, v in calls["unet_small"].items()}
    log(f"[path] unet_small launches per forward: {per_forward}; flagship: "
        f"{ {k: sum(c for c, _ in v.values()) for k, v in calls['flagship'].items()} }")
    rows = check_kernels(port, calls)
    check_unet(port, models, x, t)
    counts = check_serving(port, models["unet_small"], per_forward)
    check_ancestral(port, models["unet_small"], per_forward)

    table = kernel_table(port)
    per_flagship = {k: sum(c for c, _ in v.values()) for k, v in calls["flagship"].items()}
    log("[summary] per unet_small forward at B=64 (ms: CUDA events; dev: torch.profiler device time)")
    log("[summary] | kernel | launches/forward unet_small (flagship) | launches per DDIM-50 batch "
        "| ms | dev ms | bound ms (by) | plain ms | plain dev ms | library ms | library dev ms |")
    for name, r in rows.items():
        by = "bytes" if r["bytes_s"] >= r["ops_s"] else "operations"
        lib_ms = "—" if r["library_ms"] is None else fmt(r["library_ms"])
        lib_dev = "—" if r["library_ms"] is None else fmt(r["library_dev"])
        log(f"[summary] | {name} | {per_forward[name]} ({per_flagship[name]}) | "
            f"{per_forward[name] * DDIM_STEPS} | {fmt(r['ms'])} | {fmt(r['dev'])} | "
            f"{fmt(r['bound_ms'], 5)} ({by}) | {fmt(r['plain_ms'])} | {fmt(r['plain_dev'])} | "
            f"{lib_ms} | {lib_dev} |")
    kernels = []
    for name, r in rows.items():
        _mod, _attr, _plain, src, rep = table[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_s"] >= r["ops_s"] else "operations",
            "library_ms": r["library_ms"],
        })
    log(card_line())  # as nvidia-smi gives it, on its own line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
