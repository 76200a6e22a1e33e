"""Plain PyTorch version of the prefix-scan kernel: what
``repro/kernels/prefix_scan/ref.py::prefix_scan_ref`` computes."""
from __future__ import annotations

import torch

__all__ = ["prefix_scan_plain", "acc_dtype"]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator of the reference kernel: fp32 for floats, int32 for
    integers."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def prefix_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, in the accumulator type,
    cast back to x's type.  Integers are summed in int64 and cut to 32
    bits, which is 32-bit arithmetic that wraps on overflow."""
    if x.dtype.is_floating_point:
        return torch.cumsum(x, -1, dtype=torch.float32).to(x.dtype)
    return torch.cumsum(x, -1, dtype=torch.int64).to(torch.int32).to(x.dtype)
