from .ops import grouped_swiglu

__all__ = ["grouped_swiglu"]
