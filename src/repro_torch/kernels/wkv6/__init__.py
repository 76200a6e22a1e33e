from .ops import wkv6

__all__ = ["wkv6"]
