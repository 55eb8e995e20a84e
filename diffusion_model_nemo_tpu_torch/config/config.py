"""Plain-dict configs with attribute access (the subset of the JAX
package's ``config/yaml_config.py`` the port needs; YAML parsing waits)."""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional

__all__ = ["Config", "from_dict", "to_dict"]


class Config(dict):
    """A dict whose keys also read as attributes."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def from_dict(d: Optional[Mapping]) -> Config:
    """Deep copy of ``d`` as nested :class:`Config`."""
    return _wrap(copy.deepcopy(dict(d)) if d else {})


def to_dict(cfg: Any) -> Any:
    if isinstance(cfg, Mapping):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg
