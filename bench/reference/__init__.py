"""The benchmark's plain reference (fp32 PyTorch, torch only)."""
from .model import forward_logits

__all__ = ["forward_logits"]
