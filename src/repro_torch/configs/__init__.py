"""Architecture configs: every config of the reference, the decoders
(``qwen2-1.5b``, ``qwen3-8b``, ``deepseek-coder-33b``,
``mistral-large-123b``, ``internvl2-26b``, ``mixtral-8x22b``,
``kimi-k2-1t-a32b``, ``rwkv6-3b``, ``jamba-v0.1-52b``) and the
encoder-decoder ``seamless-m4t-medium``."""
from .base import ModelConfig, list_configs, register, scale_down
from .base import get_config as _get_config

_LOADED = False

_ARCH_MODULES = ("deepseek_coder_33b", "internvl2_26b", "jamba_v01_52b",
                 "kimi_k2_1t_a32b", "mistral_large_123b", "mixtral_8x22b",
                 "qwen2_1_5b", "qwen3_8b", "rwkv6_3b",
                 "seamless_m4t_medium")


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
        raise KeyError(f"unknown architecture {name!r} (known: "
                       f"{', '.join(list_configs())})") from None


__all__ = ["ModelConfig", "get_config", "list_configs", "register",
           "scale_down"]
