from .dit_small import DIT_SMALL_MODEL, dit_small_model_config
from .registry import TARGET_REGISTRY, get_target, instantiate, register_target
from .unet_small import UNET_SMALL_MODEL, flagship_model_config, unet_small_model_config
from .yaml_config import (
    MISSING,
    Config,
    YAMLError,
    apply_overrides,
    from_dict,
    load_config,
    merge,
    parse_value,
    parse_yaml,
    resolve_interpolations,
    to_dict,
    to_yaml,
)

__all__ = [
    "MISSING",
    "Config",
    "YAMLError",
    "apply_overrides",
    "from_dict",
    "load_config",
    "merge",
    "parse_value",
    "parse_yaml",
    "resolve_interpolations",
    "to_dict",
    "to_yaml",
    "TARGET_REGISTRY",
    "get_target",
    "instantiate",
    "register_target",
    "UNET_SMALL_MODEL",
    "unet_small_model_config",
    "flagship_model_config",
    "DIT_SMALL_MODEL",
    "dit_small_model_config",
]
