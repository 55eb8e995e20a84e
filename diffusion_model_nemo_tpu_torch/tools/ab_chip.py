"""One side of an A/B comparison on the card: a checkout's own package and
``chip_smoke.py``, read with the measurement of the checkout this file is in
(``profiling.py`` beside it), so that parent and change are measured alike.

    python3 diffusion_model_nemo_tpu_torch/tools/ab_chip.py TREE [--requests N] [--no-smoke] [--dump FILE]
    python3 diffusion_model_nemo_tpu_torch/tools/ab_chip.py --compare FILE_A FILE_B

TREE is the root of a checkout, this one or another one (for example a
parent commit unpacked by ``git archive`` into a git-ignored directory). Run
it as a file, not with ``-m``: the package it measures is TREE's. Give
parent, change, change, parent in one call to the card.

1. A serving load on TREE's ``BatchingSampler`` (unet_small, random weights
   from seed 0, DDIM-50, max_batch 64; no HTTP): one full batch alone, then
   two full-batch requests at once (the first one's latency against the
   lone batch's), then ``--requests`` full-batch requests at once, which
   keep the queue full (images/s, every request's latency).
   Then the float32 unet_small at B=64, the path of kernel #8 (TF32 off, as
   chip_smoke sets it): a forward's wall and device time, and three DDIM-10
   chains' walls (the first pays one-time costs).
2. TREE's ``chip_smoke.main()``, with its measurement functions
   (``device_profile``, ``device_ms``, ``time_ms`` and, where it has them,
   ``traced``, ``kernel_launches``, ``queued_us``) replaced by this
   checkout's.
3. With ``--dump FILE``: the SHA-256 of the bytes of each output of the
   whole-block linear-attention kernel's block and core modes (#2, #9, #10,
   #3, #12) at TREE's ``check_linattn`` path shapes in bf16 and its float32
   shapes, each from seeded inputs (seed 0 a call), as JSON. ``--compare``
   then holds two such files equal (no card needed), so that a change to
   the kernel's source can show that it left those modes' bits alone.

Lines of parts 1 and 3 start with ``[ab]``. Exits non-zero if TREE's
chip_smoke fails, if two compared files differ, or without a CUDA device.
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


BLOCK_MODES = ("linear_attention_block", "linear_attention_block_v1", "linear_attention_block_v2",
               "linear_attention_tokens", "linear_attention_v4")


def dump_outputs(path: Path) -> None:
    """Part 3: digests of the block and core modes' outputs at TREE's check shapes."""
    import hashlib

    import torch

    from diffusion_model_nemo_tpu_torch.ops import attention as A
    from diffusion_model_nemo_tpu_torch.tools import check_linattn as CL

    outs = {}
    for name in BLOCK_MODES:
        shapes = [(s, torch.bfloat16) for s in CL.PATH_SHAPES[name]]
        shapes += [(s, torch.float32) for s in CL.F32_SHAPES.get(name, ())]
        for shape, dtype in shapes:
            gen = torch.Generator(device="cuda").manual_seed(0)
            args = CL.core_args(name, shape, dtype, gen) if name in CL.CORE else CL.block_args(shape, dtype, gen)
            out = getattr(A, CL.KERNELS[name][0])(*args).contiguous().view(-1).view(torch.uint8).cpu()
            outs[f"{name} {list(shape)} {str(dtype).removeprefix('torch.')}"] = hashlib.sha256(out.numpy()).hexdigest()
    path.write_text(json.dumps(outs, indent=1))
    print(f"[ab] saved digests of {len(outs)} outputs of the block and core modes to {path}", flush=True)


def compare(path_a: str, path_b: str) -> int:
    """0 when every output the two files share is equal bit for bit."""
    a, b = (json.loads(Path(f).read_text()) for f in (path_a, path_b))
    same = {k: a[k] == b[k] for k in sorted(a) if k in b}
    print(f"[ab] {path_a} vs {path_b}: {sum(same.values())} of {len(same)} outputs equal bit for bit"
          + "".join(f"; DIFFERS: {k}" for k, v in same.items() if not v), flush=True)
    return 0 if same and all(same.values()) else 1


def f32_path(profiling) -> None:
    """Part 1's float32 unet_small (kernel #8's path), measured with ``profiling``."""
    import torch

    import diffusion_model_nemo_tpu_torch as port
    from diffusion_model_nemo_tpu_torch.config import unet_small_model_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = unet_small_model_config()
    cfg["diffusion_model"]["dtype"] = "float32"
    model = port.DDPM(cfg, device="cuda", seed=SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(MAX_BATCH, 32, 32, 3, generator=g, device="cuda")
    t = torch.randint(0, 1000, (MAX_BATCH,), generator=g, device="cuda", dtype=torch.int32)
    wall = profiling.time_ms(lambda: model.forward(x, t), iters=10)
    busy = profiling.device_profile(lambda: model.forward(x, t), iters=5)[0]
    model.change_sampler(dict(model.cfg.sampler, eta=0.0, ddim_timesteps=10,
                              _target_="diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"))
    chains = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(MAX_BATCH, 32, generator=torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        chains.append(round(time.perf_counter() - t0, 3))
    print(f"[ab] float32 unet_small B={MAX_BATCH} (#8's path): forward wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms; DDIM-10 chains {chains} s", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree", nargs="?", help="root of the checkout to measure")
    p.add_argument("--requests", type=int, default=12, help="full-batch requests of the steady-state load")
    p.add_argument("--no-smoke", action="store_true", help="the serving load only")
    p.add_argument("--dump", metavar="FILE", help="then save the block and core modes' outputs (part 3)")
    p.add_argument("--compare", nargs=2, metavar=("FILE_A", "FILE_B"), help="compare two --dump files and exit")
    args = p.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if args.tree is None:
        p.error("TREE is needed unless --compare is given")
    import torch

    if not torch.cuda.is_available():
        print("ab_chip: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    dump = Path(args.dump).resolve() if args.dump else None  # before the chdir into TREE
    here = Path(__file__).resolve().parent
    profiling = load("dmn_ab_profiling", here / "profiling.py")
    sys.path = [str(tree)] + [s for s in sys.path if Path(s or ".").resolve() != here]
    os.chdir(tree)
    print(f"[ab] tree {tree}; measurement from {here / 'profiling.py'}", flush=True)
    serve_load(args.requests)
    f32_path(profiling)
    rc = 0
    if not args.no_smoke:
        smoke = load("chip_smoke", tree / "chip_smoke.py")
        replaced = [name for name in MEASUREMENT if hasattr(smoke, name)]
        for name in replaced:
            setattr(smoke, name, getattr(profiling, name))
        print(f"[ab] chip_smoke measurement replaced: {replaced}", flush=True)
        rc = smoke.main()
    if dump:
        dump_outputs(dump)
    return rc


if __name__ == "__main__":
    sys.exit(main())
