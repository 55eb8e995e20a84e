"""Checkpointing: step checkpoints for resume and single-file ``.dmn`` archives.

Counterpart of ``diffusion_model_nemo_tpu/training/checkpoints.py``. Two
formats:

- **``.dmn`` archive** (``save_archive`` / ``load_archive`` /
  ``load_aux_weights``): the JAX package's tar layout member for member:
  ``model_config.yaml``, ``model_weights.msgpack``, ``ema_weights.msgpack``,
  ``aux_<name>.msgpack`` and ``extra.yaml``, the weights as flax parameter
  trees in flax's msgpack encoding (``utils/msgpack.py``), the YAML through
  ``config/yaml_config.py``. An archive either package writes restores in
  the other.
- **Step checkpoints** (``CheckpointManager``): the JAX package's
  constructor and ``save`` / ``restore`` / ``latest_step`` / ``wait`` /
  ``close``, with ``max_to_keep``, ``monitor`` / ``mode`` and
  ``save_interval_steps``. orbax has no torch counterpart, so the on-disk
  format is the port's own: ``<dir>/<step>/state.pt`` (``torch.save`` of
  the state dict) and ``<dir>/<step>/metrics.json``. JAX step checkpoints
  and the port's do not cross over; archives do.
"""

from __future__ import annotations

import io
import json
import shutil
import tarfile
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..config.yaml_config import from_dict, parse_yaml, to_yaml
from ..utils import msgpack

__all__ = ["CheckpointManager", "save_archive", "load_archive", "load_aux_weights"]


class CheckpointManager:
    """Step checkpoints in ``directory``: one sub-directory per step.

    A save at ``step`` happens when ``step`` is a multiple of
    ``save_interval_steps`` and later than the latest saved step (orbax's
    ``should_save``). Retention: the ``max_to_keep`` best by ``monitor``
    (``mode`` min or max) among the steps saved with that metric, every step
    saved without it (orbax's ``keep_checkpoints_without_metrics``), and the
    latest step, which resume reads. Saves are synchronous: ``wait`` has
    nothing to wait for.
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 1,
        monitor: str = "train_loss",
        mode: str = "min",
        save_interval_steps: int = 1,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min or max, got {mode!r}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.monitor, self.mode = monitor, mode
        self.save_interval_steps = max(int(save_interval_steps), 1)

    def all_steps(self):
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / "state.pt").is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any], metrics: Optional[Dict[str, float]] = None,
             force: bool = False) -> bool:
        """Write ``state`` (tensors are copied to the CPU) at ``step``;
        returns whether it was written. ``force`` skips the interval check
        (the final save of a run)."""
        latest = self.latest_step()
        if (latest is not None and step <= latest) or (not force and step % self.save_interval_steps):
            return False
        step_dir = self.directory / str(int(step))
        tmp = self.directory / f".{int(step)}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save(_to_cpu(state), tmp / "state.pt")
        (tmp / "metrics.json").write_text(json.dumps({k: float(v) for k, v in (metrics or {}).items()}))
        tmp.rename(step_dir)
        self._prune()
        return True

    def _metrics(self, step: int) -> Dict[str, float]:
        return json.loads((self.directory / str(step) / "metrics.json").read_text())

    def _prune(self) -> None:
        steps = self.all_steps()
        if self.max_to_keep <= 0 or not steps:
            return
        scored = [(self._metrics(s).get(self.monitor), s) for s in steps]
        ranked = sorted(((m, s) for m, s in scored if m is not None),
                        key=lambda ms: ms[0], reverse=self.mode == "max")
        keep = {s for _m, s in ranked[: self.max_to_keep]}
        keep |= {s for m, s in scored if m is None} | {steps[-1]}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.directory / str(s))

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (default the latest) on the CPU, or
        None when there is none (the saved state carries its own structure:
        no template, unlike orbax)."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        return torch.load(self.directory / str(step) / "state.pt", map_location="cpu", weights_only=True)

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


def _to_cpu(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_archive(
    path: str,
    cfg: Any,
    params: Any,
    ema_params: Optional[Any] = None,
    extra: Optional[Dict[str, Any]] = None,
    aux_weights: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a single-file ``.dmn`` archive (config + weights [+ EMA]).

    ``params`` / ``ema_params`` / each ``aux_weights`` value are flax
    parameter trees (nested dicts of numpy arrays or tensors); each
    ``aux_weights`` entry becomes an ``aux_<name>.msgpack`` member."""
    path = str(path)
    members: Dict[str, bytes] = {
        "model_config.yaml": to_yaml(cfg).encode(),
        "model_weights.msgpack": msgpack.packb(params),
    }
    if ema_params is not None:
        members["ema_weights.msgpack"] = msgpack.packb(ema_params)
    for name, tree in (aux_weights or {}).items():
        members[f"aux_{name}.msgpack"] = msgpack.packb(tree)
    if extra:
        members["extra.yaml"] = to_yaml(extra).encode()
    with tarfile.open(path, "w") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def load_archive(path: str):
    """Read a ``.dmn`` archive → (cfg, params, ema_params or None, extra)."""
    with tarfile.open(str(path), "r") as tar:
        names = tar.getnames()

        def read(name: str) -> bytes:
            f = tar.extractfile(name)
            if f is None:
                raise ValueError(f"{path}: archive member {name} is not a file")
            return f.read()

        cfg = from_dict(parse_yaml(read("model_config.yaml").decode(), name=f"{path}:model_config.yaml"))
        params = msgpack.unpackb(read("model_weights.msgpack"))
        ema = msgpack.unpackb(read("ema_weights.msgpack")) if "ema_weights.msgpack" in names else None
        extra = (parse_yaml(read("extra.yaml").decode(), name=f"{path}:extra.yaml")
                 if "extra.yaml" in names else None)
    return cfg, params, ema, extra


def load_aux_weights(path: str) -> Dict[str, Any]:
    """The ``aux_<name>.msgpack`` members of a ``.dmn`` archive →
    {name: parameter tree}; empty when the archive carries none."""
    out: Dict[str, Any] = {}
    with tarfile.open(str(path), "r") as tar:
        for name in tar.getnames():
            if name.startswith("aux_") and name.endswith(".msgpack"):
                f = tar.extractfile(name)
                out[name[len("aux_") : -len(".msgpack")]] = msgpack.unpackb(f.read())
    return out
