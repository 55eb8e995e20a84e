"""The ``@hydra_runner`` surface of ``examples/common.py`` for the port's CLIs.

``--config-path`` / ``--config-name`` (also ``--flag=value``), dotted
overrides (``a.b=v``, ``+a.b=v`` to add a key), and the dataclass-schema
mode of the eval / test / serve scripts. A relative config path is looked
up as given, then against the repository root, so
``--config-path=examples/configs/ddpm`` works from anywhere.
A value still ``???`` after the overrides raises, naming its key.

    @hydra_runner(config_path="examples/configs/ddpm", config_name="unet_small.yaml")
    def main(cfg): ...

    main()                     # sys.argv[1:]
    main(["model.image_size=32", ...])
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import sys
from pathlib import Path
from typing import Any, List, Mapping, Optional, Sequence

from ..config.yaml_config import MISSING, Config, apply_overrides, from_dict, load_config, resolve_interpolations

__all__ = ["hydra_runner", "parse_args", "training_batches", "REPO_ROOT"]

REPO_ROOT = Path(__file__).resolve().parents[2]


def _split_flags(argv: Sequence[str], config_path, config_name):
    cpath, cname, overrides = config_path, config_name, []
    it = iter(argv)
    for arg in it:
        if arg in ("--config-path", "--config-name"):
            try:
                value = next(it)
            except StopIteration:
                raise ValueError(f"{arg} needs a value") from None
            cpath, cname = (value, cname) if arg == "--config-path" else (cpath, value)
        elif arg.startswith("--config-path="):
            cpath = arg.split("=", 1)[1]
        elif arg.startswith("--config-name="):
            cname = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    return cpath, cname, overrides


def _find_config(cpath: Optional[str], cname: str) -> Path:
    path = Path(cpath) / cname if cpath else Path(cname)
    if path.is_absolute() or path.exists():
        return path
    if (REPO_ROOT / path).exists():
        return REPO_ROOT / path
    raise FileNotFoundError(f"config {path} not found (also looked under {REPO_ROOT})")


def _missing(cfg: Any, prefix: str = "") -> List[str]:
    if isinstance(cfg, Mapping):
        return [m for k, v in cfg.items() for m in _missing(v, f"{prefix}{k}.")]
    if isinstance(cfg, list):
        return [m for i, v in enumerate(cfg) for m in _missing(v, f"{prefix}{i}.")]
    return [prefix[:-1]] if cfg == MISSING else []


def parse_args(argv: Sequence[str], config_path: Optional[str] = None, config_name: Optional[str] = None,
               schema=None) -> Config:
    """The config a ``hydra_runner`` script gets for ``argv``."""
    cpath, cname, overrides = _split_flags(argv, config_path, config_name)
    if schema is not None:
        cfg = resolve_interpolations(apply_overrides(from_dict(dataclasses.asdict(schema())), overrides))
    else:
        if not cname:
            raise ValueError("no config: pass --config-name (and --config-path)")
        cfg = load_config(_find_config(cpath, cname), overrides=overrides)
    missing = _missing(cfg)
    if missing:
        raise ValueError(f"missing mandatory value(s) (???): {', '.join(missing)}")
    return cfg


def hydra_runner(config_path: Optional[str] = None, config_name: Optional[str] = None, schema=None):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(argv: Optional[Sequence[str]] = None):
            logging.basicConfig(level=logging.INFO, format="[dmn-torch %(levelname)s %(asctime)s] %(message)s",
                                datefmt="%H:%M:%S")
            argv = sys.argv[1:] if argv is None else list(argv)
            return fn(parse_args(argv, config_path, config_name, schema))

        return wrapper

    return deco


def training_batches(model, cfg):
    """An endless iterator of the batches a fine-tuning CLI trains on: the
    model's ``train_ds`` (``synthetic`` when it names none) or
    ``cfg.dataset_name`` (``cfg.file_dir`` its path), at ``cfg.batch_size``,
    a synthetic set ``cfg.dataset_length`` long unless the archive says."""
    ds_cfg = dict(model.cfg.get("train_ds") or {})
    if cfg.dataset_name:
        ds_cfg["name"] = cfg.dataset_name
    if ds_cfg.get("name") is None:
        ds_cfg["name"] = "synthetic"
    ds_cfg["batch_size"] = cfg.batch_size
    if str(ds_cfg["name"]).startswith("synthetic"):
        ds_cfg.setdefault("length", cfg.dataset_length)
    if cfg.file_dir:
        ds_cfg["path"] = cfg.file_dir
    model.setup_training_data(ds_cfg)
    loader = model._train_dl
    if loader is None:
        raise ValueError(f"could not build a dataloader from {ds_cfg}")

    def batches():
        while True:
            yield from loader

    return batches()
