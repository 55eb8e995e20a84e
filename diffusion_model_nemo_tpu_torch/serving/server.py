"""Batched sampling daemon over the port's samplers (sample mode).

Counterpart of ``diffusion_model_nemo_tpu/serving/server.py``:

- **Fixed shapes.** Every device call samples exactly ``max_batch`` images;
  a partial batch is padded and the surplus discarded.
- **Request coalescing.** Unseeded requests with the same class label
  and guidance scale coalesce into one device batch (linger window + size
  cap); a seeded request runs in a batch of its own, so its images are a
  function of (weights, seed, label, guidance scale, n) and its prompts.
  Prompts are data, not part of a graph: requests with different prompts
  coalesce.
- **One device owner; a batch is answered when its own chain ends.** One
  worker thread runs a batch's sampling chain (on CUDA replays of the
  sampler's captured chain, ``ops/graphs.py``, where the JAX server makes
  one asynchronous call), then answers that batch's requests before it
  starts the next chain. The warm-up batch of ``start`` captures the
  graph (its steps run eagerly first), so requests only replay. On CUDA
  the device → host copy of a batch is enqueued, non-blocking into pinned
  memory, right behind its last step, with an event that marks its end.

Endpoints (standard library ``http.server``):
  GET  /healthz  → {"status": "ok", "warm": ...,
                   "mode": "sample"|"super_resolve"|"vocode"}
  GET  /stats    → request / batch / latency counters
  POST /sample   → JSON {"num_images": N, "seed": S?, "label": L?,
                   "guidance_scale": W?, "text": prompt?,
                   "negative_text": anchor?, "format": "png"|"npy"}
                   → {"images": [b64 PNG, ...]} or raw .npy bytes
  POST /super_resolve → (SR3 archives) JSON {"images_npy": b64 of an
                   np.save'd [N, h, w, C] array (uint8, or floats in [0, 1])
                   at the archive's LR size (image_size / scale_factor),
                   "seed": S?, "format": "png"|"npy"} → [N, h·s, w·s, C]
                   outputs (``SR3.super_resolve``: the LR batch padded to
                   ``max_batch`` rows, its upsampled condition a static
                   buffer of the captured chain). An SR3 archive serves
                   only this route (/sample answers it 400, naming the
                   route), and a generation archive answers it 400.
  POST /vocode   → (WaveGrad vocoder archives) JSON {"mel_npy": b64 of an
                   np.save'd [N, F, n_mels] float log-mel array, "seed": S?}
                   → raw .npy [N, F·hop] float32 waveforms (always npy).
                   F must equal the server's ``mel_frames`` (default the
                   archive's ``segment_frames``: fixed shapes). A vocoder
                   archive serves only this route; /sample answers it 400,
                   and /vocode answers any other archive 400.
  POST /edit     → (DDPM-family archives) JSON {"images_npy": b64 of an
                   np.save'd [N, H, W, C] array (uint8, or floats in [0, 1])
                   at the model's image size, "strength": s in [0, 1],
                   "seed": S?, "format": "png"|"npy"} → SDEdit outputs
                   (``DDPM.edit``: the input noised to t0 = round(s·(T − 1)),
                   then the ancestral partial chain, captured once for each
                   strength). Unseeded requests coalesce per strength.
``label`` and ``guidance_scale`` need a class-conditional archive
(``ConditionalDDPM``): a label in [0, K), no label = the null class, and
a guidance scale only with a label (one network call on the 2B batch a
step). ``text`` and ``negative_text`` need a text-conditional archive
(``TextConditionalDDPM``): each image of a batch gets its request's prompt
as a row of tokens, the rows padded with "" (the null context) to
``max_batch``; on it a guidance scale needs a prompt, and a negative prompt
(the guidance anchor) needs a guidance scale; without guidance the anchor
rows are not sent. The prompt rows, the anchor rows and the scale are
static buffers of the captured chain, so a new prompt or scale captures
nothing. Client faults (bad payload, failed validation: a label outside
[0, K) or sent to an unconditional archive, a guidance scale without a
label or prompt, prompts to an archive that takes none, a negative prompt
without guidance) answer 400, timeouts 504, faults in the worker or the
response path 500.
A ScoreSDE archive is served with its own sampler (the predictor–corrector
chain of its config, captured as in ``modules/sde_samplers.py``); DDIM
cannot re-grid it and ``serve(use_ddim_sampler=True)`` raises, as the JAX
server does. A WaveGrad vocoder archive keeps its own (searchable)
schedule: ``serve(use_ddim_sampler=True)`` raises for it too, as in the
JAX server; its batches are vocoded on the ancestral chain (captured, the
mel inputs a static buffer), and the waveforms stay float32. A
``WavegradDDPM`` archive serves /sample on its own ancestral chain under
``use_ddim_sampler=False``; with the DDIM swap its network reads DDIM's
integer t as its noise level, as the JAX server's does. ``serve`` swaps in
the JAX server's fast samplers with its precedence: UniPC, then Karras,
then DPM-Solver++, then DDIM (an SR3 archive takes them too: its condition
is bound into the model function every sampler calls). ``serve`` takes a
model object or
a ``.dmn`` archive path (or a local-hub model name), as the JAX
``serve(model_path, ...)`` does.
"""

from __future__ import annotations

import base64
import binascii
import contextlib
import io
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.image import encode_png, to_uint8, to_uint8_tensor

__all__ = ["BatchingSampler", "SamplingServer", "serve"]

log = logging.getLogger(__name__)

def _to_unit_float_images(images: np.ndarray, what: str) -> np.ndarray:
    """uint8 → [0, 1] floats; float inputs must already be in [0, 1] (a
    float array in [0, 255] is refused, naming the fix)."""
    if images.dtype == np.uint8:
        return images.astype(np.float32) / 255.0
    images = images.astype(np.float32)
    if images.size and float(images.max()) > 1.5:
        raise ValueError(f"float {what} must be in [0, 1] (got max {float(images.max()):.3g}); "
                         "divide by 255 or send uint8")
    return images


@dataclass
class _Request:
    num_images: int
    seed: Optional[int]
    label: Optional[int] = None
    guidance_scale: Optional[float] = None
    mel: Optional[np.ndarray] = None  # vocoder mode: log-mel [n, F, n_mels]
    images: Optional[np.ndarray] = None  # edit sources [n, H, W, C] or SR3 LR inputs, in [0, 1]
    strength: Optional[float] = None  # edit requests: SDEdit strength in [0, 1]
    text: Optional[str] = None  # text archives: the prompt ("" / None = the null context)
    neg_text: Optional[str] = None  # text archives: the negative prompt (the guidance anchor)
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    enqueued_at: float = field(default_factory=time.perf_counter)


class BatchingSampler:
    """Coalesces sample requests into fixed-shape device batches.

    ``submit(n)`` blocks until the worker thread has produced ``n`` images
    (``submit_vocode(mel)`` the waveforms of a vocoder archive,
    ``submit_sr(images)`` an SR3 archive's super-resolved inputs,
    ``submit_edit(images, strength)`` SDEdit outputs). Unseeded
    batches draw from a generator seeded by (``base_seed``, batch counter);
    a seeded request's batch from ``seed`` alone.
    """

    def __init__(
        self,
        model,
        image_size: int,
        max_batch: int = 64,
        linger_ms: float = 5.0,
        use_ema: bool = True,
        base_seed: int = 0,
        mel_frames: Optional[int] = None,
    ):
        self.model = model
        self.vocode_mode = hasattr(model, "vocode")
        self.mel_frames = int(mel_frames or model.segment_frames) if self.vocode_mode else None
        self.device = torch.device(model.device)
        self.image_size = int(image_size)
        # SR3 archives serve super-resolution: requests carry the LR inputs.
        self.sr_mode = hasattr(model, "super_resolve")
        self.lr_size = self.image_size // int(model.scale_factor) if self.sr_mode else None
        # Text-conditional archives take a prompt a request.
        self.text_mode = hasattr(model, "_tokens_array")
        self.max_batch = int(max_batch)
        self.linger_s = float(linger_ms) / 1e3
        self.use_ema = bool(use_ema)
        self.base_seed = int(base_seed)
        self._batch_counter = 0
        self._queue: List[_Request] = []
        self._cv = threading.Condition()
        self._stop = False
        self._held = 0
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
        """Optionally run one full batch (builds the kernels, captures the
        sampler's CUDA graph), then start the worker."""
        if warmup:
            if self.sr_mode:
                zeros = np.zeros((self.max_batch, self.lr_size, self.lr_size, int(self.model.channels)), np.float32)
                self._to_host(self._dispatch_sr(zeros, self._next_generator()))
            elif self.vocode_mode:
                zeros = np.zeros((self.max_batch, self.mel_frames, int(self.model.n_mels)), np.float32)
                self._to_host(self._dispatch_vocode(zeros, self._next_generator()))
            else:
                self._to_host(self._dispatch_sample(self._next_generator(), None, None))
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

    @contextlib.contextmanager
    def hold(self):
        """While held the worker starts no batch: requests queue up, and on
        release they are grouped as coalescing allows (a batch already
        running finishes)."""
        with self._cv:
            self._held += 1
        try:
            yield self
        finally:
            with self._cv:
                self._held -= 1
                self._cv.notify_all()

    def queued(self) -> int:
        """Requests waiting for a batch."""
        with self._cv:
            return len(self._queue)

    # ---- client surface ------------------------------------------------------
    def submit(
        self,
        num_images: int,
        seed: Optional[int] = None,
        label: Optional[int] = None,
        timeout: Optional[float] = None,
        guidance_scale: Optional[float] = None,
        text: Optional[str] = None,
        negative_text: Optional[str] = None,
    ) -> np.ndarray:
        if self.sr_mode:
            raise ValueError("this archive is an SR3 super-resolution model: POST /super_resolve with input "
                             "images (submit_sr), not /sample")
        if self.vocode_mode:
            raise ValueError("this archive is a WaveGrad vocoder: POST /vocode with log-mel inputs "
                             "(submit_vocode), not /sample")
        num_classes = getattr(self.model, "num_classes", None)
        if label is not None:
            if num_classes is None:
                raise ValueError(f"{type(self.model).__name__} is not class-conditional: it takes no label")
            label = int(label)
            if not 0 <= label < num_classes:
                raise ValueError(f"label must be in [0, {num_classes}), got {label}")
        if (text is not None or negative_text is not None) and not self.text_mode:
            raise ValueError(f"{type(self.model).__name__} is not text-conditional; text/negative_text need a "
                             "TextConditionalDDPM archive")
        if guidance_scale is not None:
            if self.text_mode and not text:
                raise ValueError("guidance_scale requires a text prompt on this archive")
            if not self.text_mode and label is None:
                raise ValueError("guidance_scale requires a class label")
            guidance_scale = float(guidance_scale)
        if negative_text is not None and guidance_scale is None:
            raise ValueError("negative_text requires guidance_scale")
        if num_images < 1:
            raise ValueError("num_images must be >= 1")
        if seed is not None:
            seed = int(seed)
        if num_images > self.max_batch:
            # Large requests are served in max_batch chunks: fixed shapes.
            parts, remaining, chunk = [], num_images, 0
            while remaining > 0:
                n = min(remaining, self.max_batch)
                parts.append(self.submit(n, None if seed is None else seed + chunk, label, timeout, guidance_scale,
                                         text, negative_text))
                remaining -= n
                chunk += 1
            return np.concatenate(parts, axis=0)
        req = _Request(num_images=num_images, seed=seed, label=label, guidance_scale=guidance_scale,
                       text=text, neg_text=negative_text)
        return self._wait(req, timeout, "sample")

    def submit_vocode(self, mel: np.ndarray, seed: Optional[int] = None,
                      timeout: Optional[float] = None) -> np.ndarray:
        """Vocode log-mel inputs [n, F, n_mels] → waveforms [n, F·hop]: the
        contract of ``submit`` (oversized requests in ``max_batch`` chunks,
        a seeded request alone, unseeded ones coalesced)."""
        if not self.vocode_mode:
            raise ValueError("submit_vocode requires a WaveGrad vocoder archive")
        mel = np.asarray(mel, dtype=np.float32)
        if mel.ndim != 3:
            raise ValueError(f"mel must be [n, F, n_mels], got {mel.shape}")
        expect = (self.mel_frames, int(self.model.n_mels))
        if tuple(mel.shape[1:]) != expect:
            raise ValueError(f"mel inputs must be [n, {expect[0]}, {expect[1]}] for this server "
                             f"(mel_frames={self.mel_frames}); got {mel.shape}")
        n = mel.shape[0]
        if n < 1:
            raise ValueError("need at least one mel input")
        if seed is not None:
            seed = int(seed)
        if n > self.max_batch:
            parts = [self.submit_vocode(mel[off: off + self.max_batch], None if seed is None else seed + i, timeout)
                     for i, off in enumerate(range(0, n, self.max_batch))]
            return np.concatenate(parts, axis=0)
        return self._wait(_Request(num_images=n, seed=seed, mel=mel), timeout, "vocode")

    def submit_sr(self, images: np.ndarray, seed: Optional[int] = None,
                  timeout: Optional[float] = None) -> np.ndarray:
        """Super-resolve LR inputs [n, h, w, C] (uint8, or floats in [0, 1])
        at the archive's LR size → [n, h·s, w·s, C]: the contract of
        ``submit`` (oversized requests in ``max_batch`` chunks, chunk i with
        seed + i; a seeded request alone in a zero-padded batch, so its
        output is a function of (archive, seed, images); unseeded ones
        coalesced)."""
        if not self.sr_mode:
            raise ValueError("/super_resolve requires an SR3 archive (this one generates: POST /sample)")
        images = np.asarray(images)
        if images.ndim != 4:
            raise ValueError(f"images must be [n, h, w, C], got {images.shape}")
        images = _to_unit_float_images(images, "LR inputs")
        expect = (self.lr_size, self.lr_size, int(self.model.channels))
        if tuple(images.shape[1:]) != expect:
            raise ValueError(f"LR inputs must be [n, {expect[0]}, {expect[1]}, {expect[2]}] for this archive "
                             f"(scale {self.model.scale_factor}); got {images.shape}")
        n = images.shape[0]
        if n < 1:
            raise ValueError("need at least one input image")
        if seed is not None:
            seed = int(seed)
        if n > self.max_batch:
            parts = [self.submit_sr(images[off: off + self.max_batch], None if seed is None else seed + i, timeout)
                     for i, off in enumerate(range(0, n, self.max_batch))]
            return np.concatenate(parts, axis=0)
        return self._wait(_Request(num_images=n, seed=seed, images=images), timeout, "super_resolve")

    def submit_edit(self, images: np.ndarray, strength: float = 0.5, seed: Optional[int] = None,
                    timeout: Optional[float] = None) -> np.ndarray:
        """SDEdit the inputs [n, H, W, C] (uint8, or floats in [0, 1]) at the
        model's image size: the contract of ``submit`` (oversized requests
        in ``max_batch`` chunks, a seeded request alone, unseeded ones
        coalesced, here per strength)."""
        if self.vocode_mode or self.sr_mode:
            raise ValueError("/edit requires a generation archive (DDPM family)")
        if not hasattr(self.model, "edit"):
            raise ValueError(f"{type(self.model).__name__} has no edit surface (SDEdit needs a DDPM-family "
                             "ancestral sampler)")
        if not 0.0 <= float(strength) <= 1.0:
            raise ValueError(f"strength must be in [0, 1], got {strength}")
        images = np.asarray(images)
        if images.ndim != 4:
            raise ValueError(f"images must be [n, H, W, C], got {images.shape}")
        images = _to_unit_float_images(images, "edit inputs")
        expect = (self.image_size, self.image_size, int(self.model.channels))
        if tuple(images.shape[1:]) != expect:
            raise ValueError(f"edit inputs must be [n, {expect[0]}, {expect[1]}, {expect[2]}] for this archive; "
                             f"got {images.shape}")
        n = images.shape[0]
        if n < 1:
            raise ValueError("need at least one input image")
        if seed is not None:
            seed = int(seed)
        if n > self.max_batch:
            parts = [self.submit_edit(images[off: off + self.max_batch], strength, None if seed is None else seed + i,
                                      timeout) for i, off in enumerate(range(0, n, self.max_batch))]
            return np.concatenate(parts, axis=0)
        req = _Request(num_images=n, seed=seed, images=images, strength=float(strength))
        return self._wait(req, timeout, "edit")

    def _wait(self, req: _Request, timeout: Optional[float], what: str) -> np.ndarray:
        """Queue ``req`` and wait for the worker to answer it."""
        with self._cv:
            self._queue.append(req)
            self._cv.notify_all()
        if not req.done.wait(timeout=timeout):
            raise TimeoutError(f"{what} request not served within {timeout}s")
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

    def _dispatch_sample(self, generator: torch.Generator, label: Optional[int],
                         guidance_scale: Optional[float], texts: Optional[List[str]] = None,
                         neg_texts: Optional[List[str]] = None):
        """Enqueue one fixed-shape batch (of ``label`` at ``guidance_scale``
        on a conditional model; of the prompt rows ``texts`` and anchor rows
        ``neg_texts`` on a text model), quantized to uint8 on the device (4x
        fewer bytes to copy than float32), and its copy to the host; returns
        (host tensor, event) without waiting: on CUDA the copy goes into
        pinned memory, non-blocking, and the event marks its end; elsewhere
        the tensor is already on the host and the event is None."""
        kwargs = {}
        if getattr(self.model, "num_classes", None) is not None:
            kwargs = {"label": label, "guidance_scale": guidance_scale}
        elif self.text_mode:
            kwargs = {"text": texts, "negative_text": neg_texts, "guidance_scale": guidance_scale}
        out = self.model.sample(
            batch_size=self.max_batch,
            image_size=self.image_size,
            generator=generator,
            use_ema=self.use_ema,
            **kwargs,
        )
        return self._copy_out(to_uint8_tensor(out))

    def _dispatch_vocode(self, mels: np.ndarray, generator: torch.Generator):
        """Enqueue one fixed-shape vocode batch: the stacked mel inputs
        padded to ``max_batch`` rows (the padding rows are computed and
        discarded); the waveforms stay float32. Returns (host tensor, event)
        as ``_dispatch_sample`` does."""
        out = self.model.vocode(torch.from_numpy(self._pad(mels)), generator=generator, use_ema=self.use_ema)
        return self._copy_out(out)

    def _pad(self, rows: np.ndarray) -> np.ndarray:
        """``rows`` padded with zeros to ``max_batch`` (fixed shapes: the
        padding rows are computed and discarded)."""
        n = rows.shape[0]
        if n < self.max_batch:
            rows = np.concatenate([rows, np.zeros((self.max_batch - n,) + rows.shape[1:], rows.dtype)], axis=0)
        return rows

    def _dispatch_sr(self, images: np.ndarray, generator: torch.Generator):
        """Enqueue one fixed-shape super-resolve batch: the stacked LR
        inputs padded to ``max_batch`` rows, quantized to uint8 on the
        device. Returns (host tensor, event) as ``_dispatch_sample`` does."""
        out = self.model.super_resolve(torch.from_numpy(self._pad(images)), generator=generator,
                                       use_ema=self.use_ema)
        return self._copy_out(to_uint8_tensor(out))

    def _dispatch_edit(self, images: np.ndarray, strength: float, generator: torch.Generator):
        """Enqueue one fixed-shape SDEdit batch: the stacked inputs padded
        to ``max_batch`` rows (computed and discarded), quantized to uint8
        on the device. Returns (host tensor, event) as ``_dispatch_sample``
        does."""
        out = self.model.edit(torch.from_numpy(self._pad(images)), strength=strength, generator=generator,
                              use_ema=self.use_ema)
        return self._copy_out(to_uint8_tensor(out))

    @staticmethod
    def _copy_out(out: torch.Tensor):
        """(host tensor, event): on CUDA a non-blocking copy into pinned
        memory and an event marking its end; elsewhere the tensor on the
        host and no event."""
        if out.device.type != "cuda":
            return out.cpu(), None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _to_host(dispatched) -> np.ndarray:
        host, done = dispatched
        if done is not None:
            done.synchronize()  # waits for the batch's chain and its copy
        return host.numpy()

    def _prompt_rows(self, group: List[_Request]):
        """(prompt rows, anchor rows) of a text model's batch: each image its
        request's prompt and negative prompt, padded with "" (the null
        context) to ``max_batch``; no anchor rows without guidance. (None,
        None) for any other model."""
        if not self.text_mode:
            return None, None
        texts = [r.text or "" for r in group for _ in range(r.num_images)]
        negs = [r.neg_text or "" for r in group for _ in range(r.num_images)]
        pad = [""] * (self.max_batch - len(texts))
        return texts + pad, (negs + pad if group[0].guidance_scale is not None else None)

    def _take_group(self) -> List[_Request]:
        """Pop a coalescable group: one label, guidance scale and edit
        strength (sample and edit requests apart); seeded requests go
        alone."""
        head = self._queue[0]
        if head.seed is not None:
            return [self._queue.pop(0)]
        group: List[_Request] = []
        total, i = 0, 0
        while i < len(self._queue):
            r = self._queue[i]
            if (r.seed is None and r.label == head.label and r.guidance_scale == head.guidance_scale
                    and r.strength == head.strength and (r.images is None) == (head.images is None)
                    and total + r.num_images <= self.max_batch):
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
            self.stats["requests"] += len(group)
            self.stats["images"] += total
            self.stats["batches"] += 1
            self.stats["batch_fill_sum"] += total / self.max_batch
            self.stats["device_ms_sum"] += device_ms
            for r in group:  # after the counts: /stats read by an answered client includes its batch
                r.done.set()
        except Exception as e:  # worker boundary: report to every waiter
            log.exception("sample batch failed")
            for r in group:
                r.error = f"{type(e).__name__}: {e}"
                r.done.set()

    def _run(self) -> None:
        while True:
            with self._cv:
                while (not self._queue or self._held) and not self._stop:
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
                if self.sr_mode:
                    dispatched = self._dispatch_sr(np.concatenate([r.images for r in group], axis=0), gen)
                elif self.vocode_mode:
                    dispatched = self._dispatch_vocode(np.concatenate([r.mel for r in group], axis=0), gen)
                elif group[0].images is not None:  # SDEdit requests
                    dispatched = self._dispatch_edit(np.concatenate([r.images for r in group], axis=0),
                                                     group[0].strength, gen)
                else:
                    dispatched = self._dispatch_sample(gen, group[0].label, group[0].guidance_scale,
                                                       *self._prompt_rows(group))
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
                    b = server.batcher
                    mode = "super_resolve" if b.sr_mode else "vocode" if b.vocode_mode else "sample"
                    self._json(200, {"status": "ok", "warm": server.batcher.warm, "mode": mode})
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
                def array(key: str, layout: str) -> np.ndarray:
                    blob = payload.get(key)
                    if not blob:
                        raise ValueError(f"{key} (base64 of an np.save'd {layout} array) is required")
                    return np.load(io.BytesIO(base64.b64decode(blob)), allow_pickle=False)

                if self.path == "/vocode":
                    waves = server.batcher.submit_vocode(array("mel_npy", "[N,F,n_mels]"), seed=payload.get("seed"),
                                                         timeout=float(payload.get("timeout", 600.0)))
                    return waves, "npy"  # waveforms have no PNG form
                if self.path == "/edit":
                    images = server.batcher.submit_edit(array("images_npy", "[N,H,W,C]"),
                                                        strength=float(payload.get("strength", 0.5)),
                                                        seed=payload.get("seed"),
                                                        timeout=float(payload.get("timeout", 600.0)))
                    return images, payload.get("format", "png")
                if self.path == "/super_resolve":
                    images = server.batcher.submit_sr(array("images_npy", "[N,h,w,C]"), seed=payload.get("seed"),
                                                      timeout=float(payload.get("timeout", 600.0)))
                    return images, payload.get("format", "png")
                images = server.batcher.submit(
                    int(payload.get("num_images", 1)),
                    seed=payload.get("seed"),
                    label=payload.get("label"),
                    timeout=float(payload.get("timeout", 600.0)),
                    guidance_scale=payload.get("guidance_scale"),
                    text=payload.get("text"),
                    negative_text=payload.get("negative_text"),
                )
                return images, payload.get("format", "png")

            def do_POST(self):
                if self.path not in ("/sample", "/super_resolve", "/vocode", "/edit"):
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
    use_dpm_solver: bool = False,
    dpm_steps: int = 20,
    dpm_order: int = 2,
    dpm_time_spacing: str = "strided",
    use_karras_sampler: bool = False,
    karras_steps: int = 18,
    karras_order: int = 2,
    karras_s_churn: float = 0.0,
    use_unipc: bool = False,
    unipc_steps: int = 20,
    unipc_order: int = 2,
    unipc_corrector: bool = True,
    base_seed: int = 0,
    image_size: Optional[int] = None,
    device: str = "cuda",
    mel_frames: Optional[int] = None,
) -> SamplingServer:
    """Serve a model object, or the archive at a path (or a local-hub model
    name, restored on ``device``): optionally swap in a sampler, with the
    JAX server's precedence UniPC > Karras > DPM-Solver++ > DDIM (DDIM is
    the default, as in ``examples/serve.py``; a ScoreSDE archive refuses
    every swap and serves with its own sampler under
    ``use_ddim_sampler=False``, and so does a WaveGrad vocoder archive,
    whose ``mel_frames`` default to its segment's), warm up with one batch,
    and return the server (not yet listening: call ``serve_forever`` or
    ``start_background``)."""
    if isinstance(model, (str, os.PathLike)):
        from ..models import restore_model_from_archive

        model = restore_model_from_archive(str(model), use_ema=False, device=device)
    swap = use_unipc or use_karras_sampler or use_dpm_solver or use_ddim_sampler
    if swap and hasattr(model, "vocode"):
        # The vocoder's schedule is its sampler (searchable, level-conditioned):
        # DDIM would condition its network on a discrete t.
        raise ValueError(
            "vocoder archives keep their own (searchable) WaveGrad schedule: pass use_ddim_sampler=false "
            "(and no dpm/karras/unipc flags); use the schedule search of the vocode CLI for fast sampling"
        )
    if swap and not hasattr(model.sampler, "constants"):
        # A score SDE has no discrete noise schedule to re-grid: it serves
        # with its own sampler (the JAX server's refusal).
        raise ValueError(
            f"{type(model).__name__} archives use their own ODE sampler; "
            "DDIM/DPM/Karras swaps only apply to DDPM-family archives"
        )
    swaps = (
        (use_unipc, "UniPCDiffusion", {"solver_steps": unipc_steps, "solver_order": unipc_order,
                                       "use_corrector": unipc_corrector}),
        (use_karras_sampler, "KarrasDiffusion", {"solver_steps": karras_steps, "solver_order": karras_order,
                                                 "s_churn": karras_s_churn}),
        (use_dpm_solver, "DPMSolverDiffusion", {"solver_steps": dpm_steps, "solver_order": dpm_order,
                                                "time_spacing": dpm_time_spacing}),
        (use_ddim_sampler, "GeneralizedGaussianDiffusion", {"eta": ddim_eta, "ddim_timesteps": ddim_timesteps}),
    )
    for on, target, fields in swaps:
        if on:
            model.change_sampler(dict(model.cfg.sampler, _target_=f"diffusion_model_nemo.modules.{target}",
                                      **fields))
            break
    batcher = BatchingSampler(
        model,
        image_size=int(image_size or model.cfg.image_size),
        max_batch=max_batch,
        linger_ms=linger_ms,
        use_ema=use_ema,
        base_seed=base_seed,
        mel_frames=mel_frames,
    ).start()
    return SamplingServer(batcher, host=host, port=port)
