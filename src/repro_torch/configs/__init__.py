"""Architecture configs ported so far: ``qwen2-1.5b``, ``mixtral-8x22b``,
``rwkv6-3b``, ``jamba-v0.1-52b``."""
from .base import ModelConfig, list_configs, register, scale_down
from .base import get_config as _get_config

_LOADED = False

_ARCH_MODULES = ("qwen2_1_5b", "mixtral_8x22b", "rwkv6_3b",
                 "jamba_v01_52b")


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in _ARCH_MODULES:       # import for the register() side effect
        importlib.import_module(f".{mod}", __name__)
    _LOADED = True


def get_config(name: str) -> ModelConfig:
    try:
        return _get_config(name)
    except KeyError:
        raise KeyError(f"architecture {name!r} is not yet ported to "
                       f"repro_torch (ported: {', '.join(list_configs())})"
                       ) from None


__all__ = ["ModelConfig", "get_config", "list_configs", "register",
           "scale_down"]
