"""Batched sampling daemon over the port's samplers (sample mode).

Counterpart of ``diffusion_model_nemo_tpu/serving/server.py``:

- **Fixed shapes.** Every device call samples exactly ``max_batch`` images;
  a partial batch is padded and the surplus discarded.
- **Request coalescing.** Unseeded requests coalesce into one device batch (linger window + size cap); a seeded request runs in
  a batch of its own, so its images are a function of (weights, seed, n).
- **One device owner; a batch is answered when its own chain ends.** One
  worker thread runs a batch's sampling chain (here the host loop that
  enqueues its steps, not one asynchronous call as in the JAX server), then
  answers that batch's requests before it starts the next chain. On CUDA
  the device → host copy of a batch is enqueued, non-blocking into pinned
  memory, right behind its last step, with an event that marks its end.

Endpoints (standard library ``http.server``):
  GET  /healthz  → {"status": "ok", "warm": ..., "mode": "sample"}
  GET  /stats    → request / batch / latency counters
  POST /sample   → JSON {"num_images": N, "seed": S?, "format": "png"|"npy"}
                   → {"images": [b64 PNG, ...]} or raw .npy bytes
Client faults (bad payload, failed validation) answer 400, timeouts 504,
faults in the worker or the response path 500. The super-resolution, edit,
vocoder and text modes, class labels and ``.dmn`` archives are not ported
yet: those routes answer 501.
"""

from __future__ import annotations

import base64
import binascii
import io
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.image import encode_png, to_uint8, to_uint8_tensor

__all__ = ["BatchingSampler", "SamplingServer", "serve"]

log = logging.getLogger(__name__)

_NOT_PORTED_ROUTES = ("/super_resolve", "/vocode", "/edit")


@dataclass
class _Request:
    num_images: int
    seed: Optional[int]
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    enqueued_at: float = field(default_factory=time.perf_counter)


class BatchingSampler:
    """Coalesces sample requests into fixed-shape device batches.

    ``submit(n)`` blocks until the worker thread has produced ``n`` images.
    Unseeded batches draw from a generator seeded by (``base_seed``, batch
    counter); a seeded request's batch from ``seed`` alone.
    """

    def __init__(
        self,
        model,
        image_size: int,
        max_batch: int = 64,
        linger_ms: float = 5.0,
        use_ema: bool = True,
        base_seed: int = 0,
    ):
        self.model = model
        self.device = torch.device(model.device)
        self.image_size = int(image_size)
        self.max_batch = int(max_batch)
        self.linger_s = float(linger_ms) / 1e3
        self.use_ema = bool(use_ema)
        self.base_seed = int(base_seed)
        self._batch_counter = 0
        self._queue: List[_Request] = []
        self._cv = threading.Condition()
        self._stop = False
        self._warm = False
        self.stats: Dict[str, Any] = {
            "requests": 0,
            "images": 0,
            "batches": 0,
            "batch_fill_sum": 0.0,
            "latency_ms_sum": 0.0,
            "device_ms_sum": 0.0,
        }
        self._worker = threading.Thread(target=self._run, daemon=True)

    # ---- lifecycle -----------------------------------------------------------
    def start(self, warmup: bool = True) -> "BatchingSampler":
        """Optionally run one full batch (builds the kernels, warms the
        allocator), then start the worker."""
        if warmup:
            self._to_host(self._dispatch_sample(self._next_generator()))
            self._warm = True
        self._worker.start()
        return self

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._worker.is_alive():
            self._worker.join(timeout=60.0)

    @property
    def warm(self) -> bool:
        return self._warm

    # ---- client surface ------------------------------------------------------
    def submit(
        self,
        num_images: int,
        seed: Optional[int] = None,
        label: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> np.ndarray:
        if label is not None:
            raise ValueError("labels need a class-conditional model, which is not ported yet")
        if num_images < 1:
            raise ValueError("num_images must be >= 1")
        if seed is not None:
            seed = int(seed)
        if num_images > self.max_batch:
            # Large requests are served in max_batch chunks: fixed shapes.
            parts, remaining, chunk = [], num_images, 0
            while remaining > 0:
                n = min(remaining, self.max_batch)
                parts.append(self.submit(n, None if seed is None else seed + chunk, None, timeout))
                remaining -= n
                chunk += 1
            return np.concatenate(parts, axis=0)
        req = _Request(num_images=num_images, seed=seed)
        with self._cv:
            self._queue.append(req)
            self._cv.notify_all()
        if not req.done.wait(timeout=timeout):
            raise TimeoutError(f"sample request not served within {timeout}s")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    # ---- worker --------------------------------------------------------------
    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _next_generator(self) -> torch.Generator:
        self._batch_counter += 1
        seed = np.random.SeedSequence([self.base_seed, self._batch_counter]).generate_state(1)[0]
        return self._generator(int(seed))

    def _dispatch_sample(self, generator: torch.Generator):
        """Enqueue one fixed-shape batch, quantized to uint8 on the device (4x
        fewer bytes to copy than float32), and its copy to the host; returns
        (host tensor, event) without waiting: on CUDA the copy goes into
        pinned memory, non-blocking, and the event marks its end; elsewhere
        the tensor is already on the host and the event is None."""
        out = self.model.sample(
            batch_size=self.max_batch,
            image_size=self.image_size,
            generator=generator,
            use_ema=self.use_ema,
        )
        images = to_uint8_tensor(out)
        if images.device.type != "cuda":
            return images.cpu(), None
        host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
        host.copy_(images, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _to_host(dispatched) -> np.ndarray:
        host, done = dispatched
        if done is not None:
            done.synchronize()  # waits for the batch's chain and its copy
        return host.numpy()

    def _take_group(self) -> List[_Request]:
        """Pop a coalescable group; seeded requests go alone."""
        head = self._queue[0]
        if head.seed is not None:
            return [self._queue.pop(0)]
        group: List[_Request] = []
        total, i = 0, 0
        while i < len(self._queue):
            r = self._queue[i]
            if r.seed is None and total + r.num_images <= self.max_batch:
                group.append(self._queue.pop(i))
                total += r.num_images
            else:
                i += 1
            if total >= self.max_batch:
                break
        return group

    def _complete(self, group: List[_Request], dispatched, t0: float) -> None:
        """Wait for a dispatched batch's copy and hand out the slices."""
        try:
            images = self._to_host(dispatched)
            device_ms = (time.perf_counter() - t0) * 1e3
            total, off, now = sum(r.num_images for r in group), 0, time.perf_counter()
            for r in group:
                r.result = images[off : off + r.num_images]
                off += r.num_images
                self.stats["latency_ms_sum"] += (now - r.enqueued_at) * 1e3
                r.done.set()
            self.stats["requests"] += len(group)
            self.stats["images"] += total
            self.stats["batches"] += 1
            self.stats["batch_fill_sum"] += total / self.max_batch
            self.stats["device_ms_sum"] += device_ms
        except Exception as e:  # worker boundary: report to every waiter
            log.exception("sample batch failed")
            for r in group:
                r.error = f"{type(e).__name__}: {e}"
                r.done.set()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    queued, self._queue = self._queue, []
                    for r in queued:
                        r.error = "server shutting down"
                        r.done.set()
                    return
                deadline = self._queue[0].enqueued_at + self.linger_s
                while (remaining := deadline - time.perf_counter()) > 0:
                    self._cv.wait(timeout=remaining)
                group = self._take_group()
            try:
                gen = (
                    self._generator(group[0].seed)
                    if group[0].seed is not None
                    else self._next_generator()
                )
                t0 = time.perf_counter()
                dispatched = self._dispatch_sample(gen)
            except Exception as e:  # worker boundary: report to every waiter
                log.exception("sample dispatch failed")
                for r in group:
                    r.error = f"{type(e).__name__}: {e}"
                    r.done.set()
                continue
            self._complete(group, dispatched, t0)

    def snapshot_stats(self) -> Dict[str, Any]:
        s = dict(self.stats)
        b, r = max(s["batches"], 1), max(s["requests"], 1)
        return {
            "requests": s["requests"],
            "images": s["images"],
            "batches": s["batches"],
            "avg_batch_fill": round(s["batch_fill_sum"] / b, 4),
            "avg_request_latency_ms": round(s["latency_ms_sum"] / r, 3),
            "avg_device_ms_per_batch": round(s["device_ms_sum"] / b, 3),
            "max_batch": self.max_batch,
        }


def _png_b64(image: np.ndarray) -> str:
    arr = image if image.dtype == np.uint8 else to_uint8(image[None])[0]
    return base64.b64encode(encode_png(arr)).decode("ascii")


class SamplingServer:
    """HTTP front end over :class:`BatchingSampler` (standard library only)."""

    def __init__(self, batcher: BatchingSampler, host: str = "127.0.0.1", port: int = 8000):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.batcher = batcher
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.info("serving: " + fmt % args)

            def _send(self, code: int, body: bytes, content_type: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj) -> None:
                self._send(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok", "warm": server.batcher.warm, "mode": "sample"})
                elif self.path == "/stats":
                    self._json(200, server.batcher.snapshot_stats())
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def _decode_and_submit(self):
                """Payload decode + submit; the exceptions it lets out of
                the ValueError/TypeError/KeyError/binascii.Error family are
                the client's fault (400). Worker faults arrive as
                RuntimeError (500)."""
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("the request body must be a JSON object")
                images = server.batcher.submit(
                    int(payload.get("num_images", 1)),
                    seed=payload.get("seed"),
                    label=payload.get("label"),
                    timeout=float(payload.get("timeout", 600.0)),
                )
                return images, payload.get("format", "png")

            def do_POST(self):
                if self.path in _NOT_PORTED_ROUTES:
                    self._json(501, {"error": f"{self.path} is not ported yet"})
                    return
                if self.path != "/sample":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    try:
                        images, fmt = self._decode_and_submit()
                    except (ValueError, TypeError, KeyError, binascii.Error) as e:
                        self._json(400, {"error": f"{type(e).__name__}: {e}"})
                        return
                    except TimeoutError as e:
                        self._json(504, {"error": f"{type(e).__name__}: {e}"})
                        return
                    if fmt == "npy":
                        buf = io.BytesIO()
                        np.save(buf, images)
                        self._send(200, buf.getvalue(), "application/octet-stream")
                    elif fmt == "png":
                        self._json(200, {"images": [_png_b64(im) for im in images]})
                    else:
                        self._json(400, {"error": f"unknown format {fmt!r}"})
                except Exception as e:  # request boundary: answer 500
                    log.exception("sample request failed")
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def serve_forever(self) -> None:
        log.info(f"Sampling server listening on http://{self.host}:{self.port}")
        try:
            self._httpd.serve_forever()
        finally:
            self.batcher.stop()

    def start_background(self) -> threading.Thread:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self._thread

    def shutdown(self) -> None:
        # shutdown() handshakes with a running serve_forever loop and would
        # block forever if none was started.
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10.0)
            self._thread = None
        self._httpd.server_close()
        self.batcher.stop()


def serve(
    model,
    host: str = "127.0.0.1",
    port: int = 8000,
    max_batch: int = 64,
    linger_ms: float = 5.0,
    use_ema: bool = True,
    use_ddim_sampler: bool = True,
    ddim_timesteps: int = 50,
    ddim_eta: float = 0.0,
    base_seed: int = 0,
) -> SamplingServer:
    """Serve a model object: optionally swap in DDIM (the default, as in
    ``examples/serve.py``), warm up with one batch, and return the server
    (not yet listening: call ``serve_forever`` or ``start_background``)."""
    if use_ddim_sampler:
        sampler_cfg = dict(model.cfg.sampler)
        sampler_cfg["_target_"] = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
        sampler_cfg["eta"] = ddim_eta
        sampler_cfg["ddim_timesteps"] = ddim_timesteps
        model.change_sampler(sampler_cfg)
    batcher = BatchingSampler(
        model,
        image_size=int(model.cfg.image_size),
        max_batch=max_batch,
        linger_ms=linger_ms,
        use_ema=use_ema,
        base_seed=base_seed,
    ).start()
    return SamplingServer(batcher, host=host, port=port)
