"""Local model hub: name → archive resolution for ``from_pretrained``.

Counterpart of ``diffusion_model_nemo_tpu/utils/hub.py``, with the same
directory layout, so that a model either package publishes is found by the
other:

    $DMN_MODEL_HUB (default ~/.cache/dmn_hub)/
        ddpm_cifar10.dmn            # flat archive, or
        ddpm_cifar10/ddpm_cifar10.dmn

The hub is a local directory of ``.dmn`` archives (the reference publishes
no checkpoints); nothing is downloaded.
"""

from __future__ import annotations

import logging
import os
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

__all__ = [
    "PretrainedModelInfo",
    "hub_dir",
    "resolve_model_name",
    "list_hub_models",
    "publish_archive",
]

log = logging.getLogger(__name__)

_ENV_VAR = "DMN_MODEL_HUB"


@dataclass(frozen=True)
class PretrainedModelInfo:
    """A hub entry: its name and where its archive lives."""

    pretrained_model_name: str
    location: str
    description: str = ""


def hub_dir() -> Path:
    return Path(os.environ.get(_ENV_VAR) or os.path.join("~", ".cache", "dmn_hub")).expanduser()


def resolve_model_name(model_name: str) -> Optional[Path]:
    """``name`` → archive path if installed (flat or per-model directory)."""
    root = hub_dir()
    for cand in (root / f"{model_name}.dmn", root / model_name / f"{model_name}.dmn"):
        if cand.is_file():
            return cand
    return None


def list_hub_models() -> List[PretrainedModelInfo]:
    root = hub_dir()
    if not root.is_dir():
        return []
    out, seen = [], set()
    for p in sorted(root.glob("*.dmn")) + sorted(root.glob("*/*.dmn")):
        if p.parent != root and p.parent.name != p.stem:
            continue  # only <hub>/<name>.dmn or <hub>/<name>/<name>.dmn
        if p.stem in seen:
            continue  # both layouts installed: the flat one wins, as in resolve_model_name
        seen.add(p.stem)
        out.append(PretrainedModelInfo(
            pretrained_model_name=p.stem, location=str(p),
            description=f"local archive ({p.stat().st_size // 1024} KiB)",
        ))
    return out


def publish_archive(archive_path: str, model_name: Optional[str] = None) -> Path:
    """Install an existing ``.dmn`` archive into the hub under ``name``."""
    src = Path(archive_path)
    if not src.is_file():
        raise FileNotFoundError(f"no archive at {archive_path}")
    name = model_name or src.stem
    if not name or "/" in name or name.startswith("."):
        raise ValueError(f"bad hub model name {name!r}")
    root = hub_dir()
    root.mkdir(parents=True, exist_ok=True)
    dst = root / f"{name}.dmn"
    shutil.copyfile(src, dst)
    log.info(f"Published {src} to the local hub as {name!r} ({dst})")
    return dst
