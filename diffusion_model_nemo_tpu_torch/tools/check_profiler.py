"""Card check of how torch.profiler keeps a trace's device events, and of
what the marker kernels that ``profiling.traced`` opens each trace with
cost:

    python -m diffusion_model_nemo_tpu_torch.tools.check_profiler [seconds]

``[cost]`` lines: host seconds per trace of a small matmul opening with 0,
8, 128, 1024 and 2048 markers (``torch.cuda._sleep(1)``), the median of 5
traces each, and the slope per marker. ``[drift]`` lines, for ``seconds``
(default 240): a probe trace opening with 4096 markers, how many of them
it dropped, and the least (device start - host launch start) over the
markers it kept, in us, after rounds that alternate 15 s without a trace
and 200 traces of 8 markers: whether the drop follows the process's time
or its count of traces. ``[lead]`` lines: traces opening with one long spin
(0 to 8 ms) and then 8 markers: whether the markers after the spin are
kept where a run of markers is dropped. ``[host]`` lines: traces opening
with a host wait (0 to 16 ms) and then 8 markers, each after a probe: whether
the drop is a window of host time from the trace's start or a count of its
first events. Needs a card; a few minutes.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from .profiling import MARKER_KERNEL

PROBE_MARKERS = 4096


def trace(fn, n_markers: int, lead_cycles: int = 0, wait_s: float = 0.0):
    """One trace of an optional host wait of ``wait_s``, an optional spin of
    ``lead_cycles``, ``n_markers`` markers and ``fn``: (host seconds, device
    events (name, start us, us) in start order, host start us of each
    kernel launch in order)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(wait_s)
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        for _ in range(n_markers):
            torch.cuda._sleep(1)
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    seconds = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    device = sorted(((e.name, e.time_range.start, e.time_range.elapsed_us()) for e in events
                     if e.device_type == cuda), key=lambda e: e[1])
    launches = sorted(e.time_range.start for e in events
                      if e.device_type != cuda and e.name == "cudaLaunchKernel")
    return seconds, device, launches


def probe(fn):
    """(markers dropped of ``PROBE_MARKERS``, least device - launch start
    over the kept ones in us, or None where none was kept)."""
    _s, device, launches = trace(fn, PROBE_MARKERS)
    kept = [start for name, start, _us in device if MARKER_KERNEL in name]
    dropped = PROBE_MARKERS - len(kept)
    # The drop is a prefix: the kept markers are the last ones launched.
    offsets = [start - launches[dropped + j] for j, start in enumerate(kept) if dropped + j < len(launches)]
    return dropped, (min(offsets) if offsets else None)


def cycles_per_us() -> float:
    """The spin kernel's clock, from CUDA events around one long spin."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    torch.cuda.synchronize()
    return 50_000_000 / (start.elapsed_time(end) * 1e3)


def main() -> int:
    if not torch.cuda.is_available():
        print("check_profiler: no CUDA device", file=sys.stderr)
        return 2
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 240.0
    a = torch.randn(256, 256, device="cuda")
    fn = lambda: a @ a  # noqa: E731
    fn()
    torch.cuda.synchronize()
    t_start, traces = time.perf_counter(), 0
    costs = {}
    for n in (0, 8, 128, 1024, 2048):
        costs[n] = statistics.median(trace(fn, n)[0] for _ in range(5))
        traces += 5
        print(f"[cost] {n} markers: {costs[n] * 1e3:.3f} ms a trace", flush=True)
    print(f"[cost] {(costs[2048] - costs[0]) / 2048 * 1e6:.2f} us a marker (2048 against none)", flush=True)
    rnd = 0
    while time.perf_counter() - t_start < seconds:
        dropped, offset = probe(fn)
        traces += 1
        print(f"[drift] t={time.perf_counter() - t_start:.1f} s traces={traces} dropped={dropped} of "
              f"{PROBE_MARKERS} least device-launch offset {'none kept' if offset is None else f'{offset:.1f}'} us",
              flush=True)
        if rnd % 2:
            for _ in range(200):
                trace(fn, 8)
            traces += 200
        else:
            time.sleep(15)
        rnd += 1
    cpu = cycles_per_us()
    print(f"[lead] the spin kernel runs {cpu:.1f} cycles a us", flush=True)
    for lead_us in (0, 500, 2000, 8000):
        _s, device, _l = trace(fn, 8, int(lead_us * cpu))
        spins = [us for name, _start, us in device if MARKER_KERNEL in name]
        long_kept = any(us >= 50 for us in spins)
        short_kept = sum(us < 50 for us in spins)
        print(f"[lead] a {lead_us} us spin, then 8 markers: spin kept {long_kept}, markers kept {short_kept} of 8, "
              f"other events {len(device) - len(spins)}", flush=True)
    for wait_ms in (0, 1, 4, 16):
        for _ in range(4):
            dropped, _offset = probe(fn)
            _s, device, _l = trace(fn, 8, wait_s=wait_ms / 1e3)
            kept = sum(MARKER_KERNEL in name for name, _start, _us in device)
            print(f"[host] a probe dropped {dropped}; then a {wait_ms} ms host wait, then 8 markers: markers kept "
                  f"{kept} of 8, other events {len(device) - kept}", flush=True)
    dropped, offset = probe(fn)
    print(f"[drift] end t={time.perf_counter() - t_start:.1f} s dropped={dropped} least offset "
          f"{'none kept' if offset is None else f'{offset:.1f}'} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
