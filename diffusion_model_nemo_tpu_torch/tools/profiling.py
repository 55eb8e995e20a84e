"""How the port's card checks measure a kernel: CUDA-event times, torch.profiler
device time by kernel name, and the least time the card could take for the
same work. ``chip_smoke.py``, ``check_attention`` and ``check_conv_norm`` all
measure through these functions, and ``ab_chip.py`` lends them to another
checkout's ``chip_smoke.py`` so that an A/B run reads both trees alike.

It imports torch alone, so that a script can load it by file path without
importing the package it sits in.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "PEAK_BYTES_PER_S", "PEAK_OPS", "EmptyTraceError", "tracing", "time_ms", "queued_us", "traced", "WindowTrace",
    "device_profile",
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


class EmptyTraceError(RuntimeError):
    """A trace that a measurement needs held none of its calls' device
    events."""


# torch.cuda._sleep's kernel: each trace opens with one spin of LEAD_US and a
# run of short spins (the markers), all left out of the events (no measured
# function launches it).
MARKER_KERNEL = "spin_kernel"
LEAD_US = 1024
SPIN_CYCLES_PER_US = 1980  # the H100 SXM's top SM clock, MHz
MIN_MARKERS, MAX_MARKERS = 8, 1 << 14
ATTEMPTS = 6  # traces taken at most for one measurement
COUNT_CALLS = 10  # calls a trace holds where launches per call are counted
# The markers the next trace opens with (twice what the last trace dropped,
# at least MIN_MARKERS), and what tracing has cost so far: traces taken,
# those taken again, host seconds, the most markers a trace dropped.
tracing = {"markers": MIN_MARKERS, "traces": 0, "retakes": 0, "seconds": 0.0, "dropped_max": 0}


def traced(fn, calls: int = 1):
    """(name, us) of every device event of ``calls`` calls of ``fn`` in one
    torch.profiler trace.

    torch.profiler drops device events on the H100 machine
    (``tools/check_profiler.py``): the first events of a trace, more of
    them as the process lives on, and now and then every event of a
    trace; a run of short kernels launched first is dropped more than one
    queued behind a long one, and waiting on the host first changes
    nothing. So each trace opens with a spin of ``LEAD_US`` and then
    ``tracing["markers"]`` short spins, all left out of the result: a trace
    that kept one of the short spins lost none of the calls' events, which
    come after them on the stream. The next trace opens with twice the
    markers this one dropped (at least ``MIN_MARKERS``), so the run shrinks
    again when drops do. A trace that kept the calls' events but no marker
    is taken again with four times the markers (up to ``MAX_MARKERS``), one that
    kept nothing is taken again as it was, ``ATTEMPTS`` traces in all; then
    ``EmptyTraceError`` is raised: a measurement never reads a trace that
    dropped its events. On the H100 a marker costs 73-104 us of host time
    in a trace (event processing), the lead 1 ms on the card."""
    import time

    from torch.profiler import ProfilerActivity, profile

    for attempt in range(ATTEMPTS):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            n = _open_markers()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        tracing["retakes"] += attempt > 0
        kept, events = _device_events(prof, t0)
        if kept and events:
            _kept_markers(n, kept)
            return events
        if events:  # the drop reached past the markers
            tracing["markers"] = min(4 * n, MAX_MARKERS)
    raise EmptyTraceError(f"{ATTEMPTS} torch.profiler traces of {calls} call(s) kept none of the calls' device "
                          f"events after {tracing['markers']} markers")


def _open_markers(n: Optional[int] = None) -> int:
    """A trace's opening on the card: the lead spin, then ``n`` (default
    ``tracing["markers"]``) short spins; returns their number."""
    n = tracing["markers"] if n is None else n
    torch.cuda._sleep(LEAD_US * SPIN_CYCLES_PER_US)
    for _ in range(n):
        torch.cuda._sleep(1)
    return n


def _device_events(prof, t0: float):
    """(markers kept, the other device events as (name, us)) of a finished
    trace, counted in ``tracing`` with the host seconds since ``t0``."""
    import time

    device = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    tracing["traces"] += 1
    tracing["seconds"] += time.perf_counter() - t0
    kept = sum(MARKER_KERNEL in name and us < LEAD_US / 2 for name, us in device)
    return kept, [(name, us) for name, us in device if MARKER_KERNEL not in name]


def _kept_markers(n: int, kept: int) -> None:
    """The next trace opens with twice the markers this one dropped."""
    tracing["dropped_max"] = max(tracing["dropped_max"], n - kept)
    tracing["markers"] = min(max(2 * (n - kept), MIN_MARKERS), MAX_MARKERS)


class WindowTrace:
    """A torch.profiler trace of a window of a loop's iterations (the
    Trainer's ``profile_dir`` steps), opened and checked by ``traced``'s
    rules: on CUDA it opens with the lead spin and short spins, and ``stop``
    raises ``EmptyTraceError`` unless a marker and some of the window's
    device events were kept. A window cannot be taken again, so it opens
    with four times the markers the next trace would, or that any trace of
    the process dropped (late in a long process a trace drops 40 or more,
    where the next trace may open with 8); on the CPU it holds the host
    events, and ``stop`` raises when there are none. ``stop(path)`` writes the trace (Chrome trace JSON)
    only after that check and returns the window's events as (name, us)."""

    def __init__(self, device: torch.device, first_step: int = 0):
        self.cuda = torch.device(device).type == "cuda"
        self.first_step = int(first_step)
        self.prof = None
        self.markers = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.cuda:
            self.markers = _open_markers(min(4 * max(tracing["markers"], tracing["dropped_max"]), MAX_MARKERS))

    def stop(self, path: str):
        import time

        t0 = time.perf_counter()
        if self.cuda:
            torch.cuda.synchronize()
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        if self.cuda:
            kept, events = _device_events(prof, t0)
            if not (kept and events):
                raise EmptyTraceError(f"the trace of the window kept {kept} of {self.markers} markers and "
                                      f"{len(events)} device events; nothing was written to {path}")
            _kept_markers(self.markers, kept)
        else:
            events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()]
            if not events:
                raise EmptyTraceError(f"the trace of the window holds no events; nothing was written to {path}")
        prof.export_chrome_trace(str(path))
        return events


def device_profile(fn, iters: int = 10):
    """Device time per call of everything ``fn`` runs on the card, from one
    torch.profiler trace of ``iters`` calls: (total ms per call, {kernel
    name: ms per call}). A kernel's time per call is the mean of its events
    that were kept times its launches per call (its events over ``iters``,
    rounded), so a dropped event changes neither."""
    fn()
    torch.cuda.synchronize()
    times = {}
    for name, us in traced(fn, iters):
        times.setdefault(name, []).append(us)
    by_name = {name: sum(t) / len(t) / 1e3 * max(round(len(t) / iters), 1) for name, t in times.items()}
    return sum(by_name.values()), by_name


def device_ms(fn):
    """Device time per call from the profiler (``EmptyTraceError`` when no
    trace holds the call's device events)."""
    return device_profile(fn)[0]


def kernel_launches(fn):
    """Names of the device kernels one call of ``fn`` runs, in the order of
    their first launch, each as many times as it runs a call (counted over
    ``COUNT_CALLS`` calls)."""
    fn()
    torch.cuda.synchronize()
    names = [name for name, _us in traced(fn, COUNT_CALLS)]
    per_call = {name: max(round(names.count(name) / COUNT_CALLS), 1) for name in dict.fromkeys(names)}
    return [name for name, n in per_call.items() for _ in range(n)]


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
