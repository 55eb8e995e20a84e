"""Training data: the synthetic image and audio sets, the offline file
datasets, the host batcher and the on-device preprocessing.

Counterpart of ``diffusion_model_nemo_tpu/data/hf_vision_data.py`` in numpy
(the JAX package's module imports JAX): ``SyntheticVisionDataset`` draws the
same ``RandomState`` images and labels, ``SyntheticAudioDataset`` the same
waveforms (``{"audio": [T]}``, for the vocoder), ``FileVisionDataset``
(``name: file``) reads npz / npy arrays and image directories (PNG through
the port's own decoder, ``utils/image.py``: no Pillow on the card's path;
JPEG and BMP only where Pillow imports), and ``DataLoader`` shuffles with the
same epoch-seeded ``RandomState``, resizes under ``resize_to`` as Pillow's
BILINEAR does (``utils/image.py:resize_bilinear_uint8``, byte for byte) and
fetches items on ``num_workers`` threads, so both packages give
bit-identical batches; ``set_position`` replays the stream from (epoch,
batch) for a deterministic resume. The synthetic sets have no splits: a
``test`` loader (``mode="test"``, no shuffle) reads the same items in order,
as in the JAX package. ``caption_len = L`` adds byte-tokenized captions
(``tokens`` [L] int32 an item, ``utils/text.py``): the synthetic set's
``"a photo of class {label}"``, an image directory's ``captions.txt`` (one
line an image, in the sorted file order). Not ported: Hugging Face datasets
(they need a download) and multi-process sharding.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional, Union

import numpy as np
import torch

from ..utils.image import decode_png, resize_bilinear_uint8
from ..utils.text import ByteTokenizer

__all__ = ["SyntheticVisionDataset", "SyntheticAudioDataset", "FileVisionDataset", "DataLoader",
           "build_dataloader", "preprocess_batch", "to_uint8_nhwc", "read_image_rgb"]


class SyntheticVisionDataset:
    """Deterministic random uint8 images (at most 512 distinct) and labels;
    with ``caption_len`` the tokens of ``"a photo of class {label}"`` too."""

    def __init__(self, image_size: int = 32, channels: int = 3, num_classes: int = 10,
                 length: int = 512, seed: int = 0, caption_len: int = 0):
        self.image_size, self.channels, self.num_classes = image_size, channels, num_classes
        self.length = length
        rng = np.random.RandomState(seed)
        n = min(length, 512)
        self._images = rng.randint(0, 256, size=(n, image_size, image_size, channels), dtype=np.uint8)
        self._labels = rng.randint(0, num_classes, size=(n,)).astype(np.int32)
        self._tokens = None
        if caption_len:
            self._tokens = ByteTokenizer(int(caption_len)).encode_batch(
                [f"a photo of class {int(label)}" for label in self._labels])

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        i = int(idx) % self._images.shape[0]
        out = {"image": self._images[i], "label": self._labels[i]}
        if self._tokens is not None:
            out["tokens"] = self._tokens[i]
        return out


def to_uint8_nhwc(arr: np.ndarray) -> np.ndarray:
    """[N, ...] images in any common layout and dtype → uint8 NHWC: [N, H,
    W] grey gains a channel; NCHW turns NHWC where axis 1 looks like
    channels (1, 3 or 4) and the last does not; floats in [-1, 1] (a minimum
    below -0.001) or [0, 1] (a maximum at most 1.001) are scaled, rounded
    and clipped (JAX ``_to_uint8_nhwc``)."""
    if arr.ndim == 3:  # [N, H, W] grey
        arr = arr[..., None]
    if arr.ndim != 4:
        raise ValueError(f"Expected [N,H,W,C] / [N,C,H,W] / [N,H,W] images, got {arr.shape}")
    if arr.shape[1] in (1, 3, 4) and arr.shape[-1] not in (1, 3, 4):
        arr = np.transpose(arr, (0, 2, 3, 1))
    if arr.dtype != np.uint8:
        a = arr.astype(np.float32)
        if a.min() < -0.001:  # [-1, 1]
            a = (a + 1.0) * 127.5
        elif a.max() <= 1.001:  # [0, 1]
            a = a * 255.0
        arr = np.clip(np.round(a), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(arr)


def read_image_rgb(path: Union[str, Path]) -> np.ndarray:
    """An image file as [H, W, 3] uint8, converted as Pillow's
    ``Image.convert("RGB")`` converts it: PNG by the port's decoder (grey
    repeated, alpha dropped, a palette looked up); JPEG and BMP through
    Pillow, which must then be installed (it is not on the card's path)."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        img = decode_png(path.read_bytes())
        if img.shape[-1] in (1, 2):  # grey (+ alpha)
            return np.repeat(img[..., :1], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path.name}: only PNG files are read without Pillow; install Pillow for "
                          f"{path.suffix} files or convert them to PNG") from None
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


class FileVisionDataset:
    """Offline dataset from local files (``train_ds.name: file``), JAX
    ``FileVisionDataset`` on the port's readers. ``path`` is:

    - ``*.npz``: arrays under ``image_key`` (and ``label_key``, optional);
    - ``*.npy``: one image array (no labels);
    - a directory of image files (png / jpg / jpeg / bmp, sorted by name),
      read lazily as RGB (``read_image_rgb``), with an optional
      ``labels.npy`` aligned to the sorted files and, under
      ``caption_len``, an optional ``captions.txt`` (one caption a line,
      in the same order), byte-tokenized.

    Arrays may be NCHW or NHWC, uint8 or floats in [0, 1] / [-1, 1]
    (``to_uint8_nhwc``)."""

    _IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")

    def __init__(self, path: str, image_key: str = "images", label_key: str = "labels", caption_len: int = 0):
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"FileVisionDataset path does not exist: {path}")
        self._files = self._images = self._labels = self._tokens = None
        if p.is_dir():
            self._files = sorted(f for f in p.iterdir() if f.suffix.lower() in self._IMG_EXTS)
            if not self._files:
                raise ValueError(f"No image files ({self._IMG_EXTS}) found under {path}")
            lbl = p / "labels.npy"
            if lbl.exists():
                self._labels = np.load(lbl).astype(np.int32)
                if len(self._labels) != len(self._files):
                    raise ValueError(f"labels.npy has {len(self._labels)} entries for {len(self._files)} image files")
            cap = p / "captions.txt"
            if caption_len and cap.exists():
                lines = cap.read_text().splitlines()
                if len(lines) != len(self._files):
                    raise ValueError(f"captions.txt has {len(lines)} lines for {len(self._files)} image files")
                self._tokens = ByteTokenizer(int(caption_len)).encode_batch(lines)
        elif p.suffix == ".npz":
            data = np.load(p)
            if image_key not in data:
                raise KeyError(f"`{image_key}` not in {path} (has {list(data.keys())}); set train_ds.image_key")
            self._images = to_uint8_nhwc(data[image_key])
            if label_key in data:
                self._labels = data[label_key].astype(np.int32).reshape(-1)
        elif p.suffix == ".npy":
            self._images = to_uint8_nhwc(np.load(p))
        else:
            raise ValueError(f"Unsupported dataset file type: {path}")

    def __len__(self) -> int:
        return len(self._files) if self._files is not None else self._images.shape[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        i = int(idx)
        out = {"image": read_image_rgb(self._files[i]) if self._files is not None else self._images[i]}
        if self._labels is not None:
            out["label"] = np.int32(self._labels[i])
        if self._tokens is not None:
            out["tokens"] = self._tokens[i]
        return out


class SyntheticAudioDataset:
    """Deterministic waveforms (sums of four harmonics and a little noise,
    at most 64 distinct) in [-1, 1]; yields ``{"audio": float32 [T]}``."""

    def __init__(self, segment_length: int = 7200, length: int = 256, seed: int = 0, mode: str = "train"):
        self.segment_length, self.length = segment_length, length
        rng = np.random.RandomState(seed)
        t = np.arange(segment_length) / 24000.0
        waves = []
        for _ in range(min(length, 64)):
            f0 = rng.uniform(80, 400)
            w = sum(
                rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6.28))
                for k in range(4)
            )
            w = w + rng.randn(segment_length) * 0.01
            waves.append((w / (np.abs(w).max() + 1e-6) * 0.95).astype(np.float32))
        self._waves = np.stack(waves)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {"audio": self._waves[int(idx) % self._waves.shape[0]]}


class DataLoader:
    """Host-side batcher: epoch-seeded shuffle, drop-remainder, numpy collate.
    ``image_size`` (the config's ``resize_to``) resizes each item whose
    height differs as Pillow's BILINEAR does (the JAX loader's rule);
    ``num_workers > 0`` fetches (decodes, resizes) a batch's items on that
    many threads, in order, so the batches are the serial loader's.
    ``pin_memory`` is accepted for config parity (the Trainer's prefetcher
    pins)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, image_size: Optional[int] = None, num_workers: int = 0,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.image_size = None if image_size is None else int(image_size)
        self.num_workers = max(int(num_workers or 0), 0)
        self._pool = None
        self._epoch = 0
        self._skip = 0  # batches to skip at the start of the next epoch

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="data-worker")
        return self._pool

    def _fetch(self, idx) -> Dict[str, np.ndarray]:
        item = self.dataset[idx]
        if "image" in item and self.image_size is not None and item["image"].shape[0] != self.image_size:
            item = dict(item, image=resize_bilinear_uint8(item["image"], self.image_size))
        return item

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
            idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
            if self.num_workers > 0:
                items = list(self._executor().map(self._fetch, idxs))
            else:
                items = [self._fetch(i) for i in idxs]
            yield {key: np.stack([it[key] for it in items]) for key in items[0]}


def build_dataloader(cfg: Mapping, mode: str) -> DataLoader:
    """From a reference-style ``train_ds`` block: ``name: synthetic``,
    ``synthetic_audio`` or ``file`` (``path``, ``image_key``,
    ``label_key``), with ``resize_to``, ``num_workers`` and
    ``caption_len`` (the image sets' tokenized captions). A Hugging Face
    dataset name raises: it needs a download."""
    name = str(cfg.get("name"))
    caption_len = int(cfg.get("caption_len", 0) or 0)
    if name == "synthetic_audio":
        dataset = SyntheticAudioDataset(segment_length=int(cfg.get("segment_length", 7200)),
                                        length=int(cfg.get("length", 256)), mode=mode)
    elif name == "file":
        dataset = FileVisionDataset(path=str(cfg.get("path")), image_key=str(cfg.get("image_key", "images")),
                                    label_key=str(cfg.get("label_key", "labels")), caption_len=caption_len)
    elif name.startswith("synthetic"):
        dataset = SyntheticVisionDataset(
            image_size=int(cfg.get("image_size", 32)),
            channels=int(cfg.get("channels", 3)),
            num_classes=int(cfg.get("num_classes", 10) or 10),
            length=int(cfg.get("length", 512)),
            caption_len=caption_len,
        )
    else:
        raise NotImplementedError(
            f"build_dataloader(name={name!r}): Hugging Face datasets need a download, which the port does not "
            "do; use name: file (an npz, an npy or an image directory) or synthetic")
    return DataLoader(
        dataset,
        batch_size=int(cfg.get("batch_size", 32)),
        shuffle=bool(cfg.get("shuffle", mode == "train")),
        seed=int(cfg.get("seed", 0)),
        image_size=cfg.get("resize_to"),
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
    JAX package draws it with ``bernoulli(key, 0.5)``. Labels and caption
    tokens go along as int32."""
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
    if "tokens" in batch:
        tokens = batch["tokens"]
        tokens = tokens if torch.is_tensor(tokens) else torch.as_tensor(np.asarray(tokens, np.int32))
        out["tokens"] = tokens.to(device=device, dtype=torch.int32)
    return out
