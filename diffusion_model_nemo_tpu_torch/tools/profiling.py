"""How the port's card checks measure a kernel: CUDA-event times, torch.profiler
device time by kernel name, and the least time the card could take for the
same work. ``chip_smoke.py``, ``check_attention`` and ``check_conv_norm`` all
measure through these functions, and ``ab_chip.py`` lends them to another
checkout's ``chip_smoke.py`` so that an A/B run reads both trees alike.

It imports torch alone, so that a script can load it by file path without
importing the package it sits in.
"""

from __future__ import annotations

import torch

__all__ = [
    "PEAK_BYTES_PER_S", "PEAK_OPS", "time_ms", "queued_us", "traced", "device_profile",
    "device_ms", "kernel_launches", "work", "bound_us",
]

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 on CUDA cores


def time_ms(fn, iters: int = 20) -> float:
    """ms per call by CUDA events around ``iters`` back-to-back calls after
    three warm-up calls; the host's launch time counts where it exceeds the
    device's."""
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


def queued_us(fn, iters: int = 20) -> float:
    """Device time per call by CUDA events around ``iters`` calls queued
    behind a ~6 ms spin kernel (``torch.cuda._sleep``), so that the host's
    launch time is hidden and back-to-back device time is what is left."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def traced(fn, calls: int = 1):
    """(name, us) of every device event of ``calls`` calls of ``fn`` in one
    torch.profiler trace. A trace now and then comes back without device
    events: it is taken again, four times at most."""
    from torch.profiler import ProfilerActivity, profile

    events = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    return events


def device_profile(fn, iters: int = 10):
    """Device time per call of everything ``fn`` runs on the card, from
    torch.profiler traces: (total ms per call, {kernel name: ms per call}).
    A trace also drops some of its events now and then (a kernel's time was
    seen to halve), so a kernel's time per call is the mean of its events
    that were kept times its launches per call (the most that a one-call
    trace or the ``iters``-call trace shows)."""
    fn()
    torch.cuda.synchronize()
    per_call = {}
    for name, _us in traced(fn):
        per_call[name] = per_call.get(name, 0) + 1
    times = {}
    for name, us in traced(fn, iters):
        times.setdefault(name, []).append(us)
    by_name = {name: sum(t) / len(t) / 1e3 * max(per_call.get(name, 0), round(len(t) / iters), 1)
               for name, t in times.items()}
    return sum(by_name.values()), by_name


def device_ms(fn):
    """Device time per call from the profiler; None ("not measured") when
    the traces hold no device time."""
    total = device_profile(fn)[0]
    return total if total > 0 else None


def kernel_launches(fn):
    """Names of the device kernels one call of ``fn`` runs, in order."""
    fn()
    torch.cuda.synchronize()
    return [name for name, _us in traced(fn)]


def work(name, args):
    """(bytes, operations, operation type) that the function of kernel
    ``name`` (a key of ``ops.KERNELS``) must move and do on ``args``: each
    input read once, each output written once."""
    x = args[0]
    es = x.element_size()
    kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
    if name == "attention":  # q, k, v in, out out; q·kᵀ and p·v
        Bn, Nn, h, d = x.shape
        return 4 * x.numel() * es, 4 * Bn * h * Nn * Nn * d, kind
    if name == "linear_attention_qkv":  # qkv in, out out; kᵀv and q·gram per head, in f32 in both dtypes
        Bn, Nn, C3 = x.shape
        hd, dh = C3 // 3, 32
        return x.numel() * es + Bn * Nn * hd * es, Bn * Nn * 2 * 2 * hd * dh, "f32"
    if name.startswith("group_norm_silu"):
        Bn, H, W, C = x.shape
        n = x.numel()
        film = args[5:7] if len(args) > 5 and args[5] is not None else ()
        film_bytes = sum(a.numel() * a.element_size() for a in film)
        return 2 * n * es + 2 * C * 4 + film_bytes, (14 if film else 11) * n, "f32"
    if name == "conv3x3":  # x, w, b in, y out; 9·C MACs per output
        w, b = args[1], args[2]
        Bn, H, W, C = x.shape
        y_bytes = Bn * H * W * w.shape[-1] * es
        wb_bytes = sum(a.numel() * a.element_size() for a in (w, b) if a is not None)
        return x.numel() * es + y_bytes + wb_bytes, 2 * Bn * H * W * 9 * C * w.shape[-1], kind
    if name == "transpose2d":  # each element read once and written once
        return 2 * x.numel() * es, 0, kind
    if name == "linear_attention_v4":  # x is [B, N·C/128, 128]; N is args[2]
        Bn, Nn = x.shape[0], args[2]
        C = x.numel() // (Bn * Nn)
    else:
        Bn, Nn, C = x.shape
    hd = 128
    if name in ("linear_attention_tokens", "linear_attention_v4"):
        io_bytes = x.numel() * es + Bn * Nn * hd * es + C * 3 * hd * 4
        return io_bytes, Bn * Nn * (2 * C * 3 * hd + 2 * 2 * 32 * 32 * 4), kind
    weights = (C * 3 * hd + hd * C + 3 * C) * 4 + 2 * C * 4
    io_bytes = 2 * x.numel() * es + weights
    if name in ("linear_attention_block", "linear_attention_block_v1", "linear_attention_block_v2"):
        ops = Bn * Nn * (2 * C * 3 * hd + 2 * 2 * 32 * 32 * 4 + 2 * hd * C)
    else:  # attention_block_small
        ops = Bn * (2 * Nn * C * 3 * hd + 2 * 2 * Nn * Nn * hd + 2 * Nn * hd * C)
    return io_bytes, ops, kind


def bound_us(name, args) -> float:
    """The least time in µs the card could take for ``work(name, args)``:
    bytes at ``PEAK_BYTES_PER_S`` or operations at ``PEAK_OPS``, the larger."""
    nbytes, ops, kind = work(name, args)
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS[kind]) * 1e6
