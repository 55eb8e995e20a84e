"""One side of an A/B comparison on the card: a checkout's own package and
``chip_smoke.py``, read with the measurement of the checkout this file is in
(``profiling.py`` beside it), so that parent and change are measured alike.

    python3 diffusion_model_nemo_tpu_torch/tools/ab_chip.py TREE [--requests N] [--no-smoke]

TREE is the root of a checkout, this one or another one (for example a
parent commit unpacked by ``git archive`` into a git-ignored directory). Run
it as a file, not with ``-m``: the package it measures is TREE's. Give
parent, change, change, parent in one call to the card.

1. A serving load on TREE's ``BatchingSampler`` (unet_small, random weights
   from seed 0, DDIM-50, max_batch 64; no HTTP): one full batch alone, then
   two full-batch requests at once (the first one's latency against the
   lone batch's), then ``--requests`` full-batch requests at once, which
   keep the queue full (images/s, every request's latency).
2. TREE's ``chip_smoke.main()``, with its measurement functions
   (``device_profile``, ``device_ms``, ``time_ms`` and, where it has them,
   ``traced``, ``kernel_launches``, ``queued_us``) replaced by this
   checkout's.

Lines of part 1 start with ``[ab]``. Exits non-zero if TREE's chip_smoke
fails, or without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path

MEASUREMENT = ("device_profile", "device_ms", "time_ms", "traced", "kernel_launches", "queued_us")
MAX_BATCH, DDIM_STEPS, SEED = 64, 50, 0


def load(name: str, path: Path):
    """The module at ``path``, imported under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def concurrent(batcher, n: int):
    """Submit ``n`` full-batch requests at once from ``n`` threads; (wall s,
    each request's latency in s, in the order they were answered)."""
    done, lock = [], threading.Lock()

    def one():
        t = time.perf_counter()
        out = batcher.submit(MAX_BATCH)
        assert out.shape[0] == MAX_BATCH, out.shape
        with lock:
            done.append(time.perf_counter() - t)

    threads = [threading.Thread(target=one) for _ in range(n)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        assert not th.is_alive(), "a request did not finish"
    return time.perf_counter() - t0, done


def serve_load(requests: int) -> None:
    import diffusion_model_nemo_tpu_torch as port
    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config
    from diffusion_model_nemo_tpu_torch.serving import serve

    model = port.DDPM(unet_small_model_config(), device="cuda", seed=SEED)
    server = serve(model, port=0, max_batch=MAX_BATCH, ddim_timesteps=DDIM_STEPS, use_ema=True)
    try:
        batcher = server.batcher
        lone, _ = concurrent(batcher, 1)
        _wall2, lat2 = concurrent(batcher, 2)
        wall, lat = concurrent(batcher, requests)
        stats = batcher.snapshot_stats()
    finally:
        server.shutdown()
    print(f"[ab] serve unet_small DDIM-{DDIM_STEPS} max_batch={MAX_BATCH}: one batch alone {lone * 1e3:.1f} ms; "
          f"two at once: answered after {lat2[0] * 1e3:.1f} / {lat2[1] * 1e3:.1f} ms "
          f"(first / lone batch {lat2[0] / lone:.3f}); {requests} at once: {requests * MAX_BATCH / wall:.3f} "
          f"images/s, wall {wall:.3f} s, mean latency {sum(lat) / len(lat) * 1e3:.1f} ms, "
          f"latencies ms {[round(v * 1e3, 1) for v in lat]}; stats {json.dumps(stats)}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree", help="root of the checkout to measure")
    p.add_argument("--requests", type=int, default=12, help="full-batch requests of the steady-state load")
    p.add_argument("--no-smoke", action="store_true", help="the serving load only")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ab_chip: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    here = Path(__file__).resolve().parent
    profiling = load("dmn_ab_profiling", here / "profiling.py")
    sys.path = [str(tree)] + [s for s in sys.path if Path(s or ".").resolve() != here]
    os.chdir(tree)
    print(f"[ab] tree {tree}; measurement from {here / 'profiling.py'}", flush=True)
    serve_load(args.requests)
    if args.no_smoke:
        return 0
    smoke = load("chip_smoke", tree / "chip_smoke.py")
    replaced = [name for name in MEASUREMENT if hasattr(smoke, name)]
    for name in replaced:
        setattr(smoke, name, getattr(profiling, name))
    print(f"[ab] chip_smoke measurement replaced: {replaced}", flush=True)
    return smoke.main()


if __name__ == "__main__":
    sys.exit(main())
