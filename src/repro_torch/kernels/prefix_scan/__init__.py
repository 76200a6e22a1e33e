from .ops import prefix_scan

__all__ = ["prefix_scan"]
