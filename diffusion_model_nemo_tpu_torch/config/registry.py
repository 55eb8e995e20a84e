"""``_target_`` registry and ``instantiate`` for the port.

Counterpart of ``diffusion_model_nemo_tpu/config/registry.py``: configs keep
the reference's ``_target_`` spellings (``diffusion_model_nemo.modules.Unet``
and so on), and the registry maps each to the port's class. Only the targets
of the ported slice are known; any other name raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

__all__ = ["register_target", "get_target", "instantiate", "TARGET_REGISTRY"]

TARGET_REGISTRY: Dict[str, Callable] = {}


def register_target(*names: str) -> Callable:
    """Class decorator registering ``_target_`` names, plus the class's own
    dotted path and short name."""

    def deco(obj: Callable) -> Callable:
        for name in names:
            if name in TARGET_REGISTRY and TARGET_REGISTRY[name] is not obj:
                raise ValueError(f"_target_ `{name}` already registered")
            TARGET_REGISTRY[name] = obj
        TARGET_REGISTRY.setdefault(f"{obj.__module__}.{obj.__qualname__}", obj)
        TARGET_REGISTRY.setdefault(obj.__qualname__, obj)
        return obj

    return deco


def get_target(name: str) -> Callable:
    if name not in TARGET_REGISTRY:
        raise KeyError(
            f"_target_ `{name}` is not ported yet (known: {sorted(TARGET_REGISTRY)})"
        )
    return TARGET_REGISTRY[name]


def instantiate(cfg: Optional[Mapping], *args: Any, **kwargs: Any) -> Any:
    """Build the object named by ``cfg['_target_']`` with ``args`` and the
    other fields as keyword arguments; call-site ``kwargs`` override config
    fields (``hydra.utils.instantiate``'s non-recursive subset)."""
    if cfg is None:
        return None
    if "_target_" not in cfg:
        raise ValueError(f"instantiate() requires a `_target_` key; got {sorted(cfg)}")
    target = get_target(str(cfg["_target_"]))
    cfg_kwargs = {k: v for k, v in cfg.items() if k != "_target_"}
    cfg_kwargs.update(kwargs)
    return target(*args, **cfg_kwargs)
