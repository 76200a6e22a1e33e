from .ops import mamba_conv, mamba_scan

__all__ = ["mamba_conv", "mamba_scan"]
