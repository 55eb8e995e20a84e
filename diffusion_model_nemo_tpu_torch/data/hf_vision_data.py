"""Training data: the synthetic image set, the host batcher and the
on-device preprocessing.

Counterpart of the parts of ``diffusion_model_nemo_tpu/data/hf_vision_data.py``
the training slice needs, in numpy (the JAX package's module imports JAX):
``SyntheticVisionDataset`` draws the same ``RandomState`` images and labels,
and ``DataLoader`` shuffles with the same epoch-seeded ``RandomState``, so
both packages give bit-identical uint8 batches; ``set_position`` replays the
stream from (epoch, batch) for a deterministic resume. The synthetic set
has no splits: its ``test`` loader (``mode="test"``, no shuffle) reads the
same images in order, as in the JAX package. Hugging Face, file and
audio datasets, captions and multi-process sharding are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Union

import numpy as np
import torch

from ..modules.parts import not_ported

__all__ = ["SyntheticVisionDataset", "DataLoader", "build_dataloader", "preprocess_batch"]


class SyntheticVisionDataset:
    """Deterministic random uint8 images (at most 512 distinct) and labels."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 length: int = 512, seed: int = 0):
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.length = length
        rng = np.random.RandomState(seed)
        n = min(length, 512)
        self._images = rng.randint(0, 256, size=(n, image_size, image_size, channels), dtype=np.uint8)
        self._labels = rng.randint(0, num_classes, size=(n,)).astype(np.int32)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        i = int(idx) % self._images.shape[0]
        return {"image": self._images[i], "label": self._labels[i]}


class DataLoader:
    """Host-side batcher: epoch-seeded shuffle, drop-remainder, numpy collate.
    ``num_workers`` and ``pin_memory`` are accepted for config parity; the
    synthetic images are already in memory, so items are fetched in order."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, num_workers: int = 0, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self._epoch = 0
        self._skip = 0  # batches to skip at the start of the next epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_position(self, epoch: int, batch_offset: int) -> None:
        """Fast-forward for a deterministic resume: the order is a function
        of (seed, epoch, batch index), so the next ``__iter__`` replays epoch
        ``epoch`` from batch ``batch_offset`` (the skipped batches are never
        fetched); later epochs start at 0."""
        self._epoch, self._skip = int(epoch), int(batch_offset)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        skip, self._skip = self._skip, 0
        for b in range(skip, len(self)):
            items = [self.dataset[i] for i in order[b * self.batch_size : (b + 1) * self.batch_size]]
            yield {key: np.stack([it[key] for it in items]) for key in items[0]}


def build_dataloader(cfg: Mapping, mode: str) -> DataLoader:
    """From a reference-style ``train_ds`` block; only ``name: synthetic``."""
    name = str(cfg.get("name"))
    if name != "synthetic":
        raise not_ported("build_dataloader", f"name={name!r}", "datasets")
    if cfg.get("caption_len") or cfg.get("resize_to"):
        raise not_ported("build_dataloader", "caption_len / resize_to", "datasets")
    dataset = SyntheticVisionDataset(
        image_size=int(cfg.get("image_size", 32)),
        channels=int(cfg.get("channels", 3)),
        num_classes=int(cfg.get("num_classes", 10) or 10),
        length=int(cfg.get("length", 512)),
    )
    return DataLoader(
        dataset,
        batch_size=int(cfg.get("batch_size", 32)),
        shuffle=bool(cfg.get("shuffle", mode == "train")),
        seed=int(cfg.get("seed", 0)),
        num_workers=int(cfg.get("num_workers", 0) or 0),
        pin_memory=bool(cfg.get("pin_memory", False)),
    )


def preprocess_batch(
    batch: Mapping[str, np.ndarray],
    device: Union[str, torch.device],
    flip: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """uint8 NHWC (a numpy array, or a tensor already on ``device``) →
    float32 in [-1, 1] on ``device``, then a horizontal flip of the samples
    where ``flip`` (a [B] bool tensor, drawn by the caller) is true — the
    JAX package draws it with ``bernoulli(key, 0.5)``."""
    img = batch["image"]
    if not torch.is_tensor(img):
        img = torch.as_tensor(np.ascontiguousarray(img))
    img = img.to(device, non_blocking=True)
    x = img.float() / 127.5 - 1.0
    if flip is not None:
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
    out = {"pixel_values": x}
    if "label" in batch:
        label = batch["label"]
        label = label if torch.is_tensor(label) else torch.as_tensor(np.asarray(label, np.int32))
        out["label"] = label.to(device=device, dtype=torch.int32)
    return out
