from .config import Config, from_dict, to_dict
from .dit_small import DIT_SMALL_MODEL, dit_small_model_config
from .registry import TARGET_REGISTRY, get_target, instantiate, register_target
from .unet_small import UNET_SMALL_MODEL, flagship_model_config, unet_small_model_config

__all__ = [
    "Config",
    "from_dict",
    "to_dict",
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
