"""Background-thread batch prefetcher.

Counterpart of ``diffusion_model_nemo_tpu/data/prefetch.py``: while the
device runs step N, a thread builds the next batches (up to ``depth``
ahead), so that the host's dataset reads and collation overlap the device.
numpy's copies release the GIL, so a thread suffices. ``pin``: each batch is
copied into page-locked host memory in the thread (a CUDA run's host → device
copies then overlap the card's work). An exception in the thread is raised
again in the consumer, never swallowed; a consumer that stops early stops
the thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

__all__ = ["ThreadedPrefetcher", "pin_batch"]

_END = object()


def pin_batch(batch: Any) -> Any:
    """A batch (a dict of arrays, or a list of them) with every array as a
    tensor in page-locked memory."""
    if isinstance(batch, dict):
        return {k: pin_batch(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(pin_batch(v) for v in batch)
    t = batch if torch.is_tensor(batch) else torch.as_tensor(np.ascontiguousarray(batch))
    return t.pin_memory()


class ThreadedPrefetcher:
    """Wrap any batch iterable; ``iter()`` yields its batches, produced
    ahead of time by a daemon thread through a queue of ``depth``, each
    passed through ``pin_batch`` first when ``pin`` is set."""

    def __init__(self, loader: Iterable, depth: int = 2, pin: bool = False):
        self.loader = loader
        self.depth = int(depth)
        self.pin = bool(pin)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Any]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(pin_batch(batch) if self.pin else batch):
                        return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                put(_END)

        t = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            t.join()
