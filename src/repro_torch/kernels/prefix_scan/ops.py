"""Public wrapper: inclusive prefix sum along the last axis of a tensor of
any rank >= 1.

On a CUDA tensor ``prefix_scan`` launches the hand-written one-pass kernel
(``csrc/prefix_scan.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.prefix_scan_plain``).  ``prefix_scan.launches`` counts kernel
launches.

The signature is that of ``repro/kernels/prefix_scan/ops.py`` without its
TPU knobs (``block``, ``interpret``): the kernel picks its tile and masks
the ragged end of a row instead of padding it.
"""
from __future__ import annotations

import torch

from .ref import prefix_scan_plain

__all__ = ["prefix_scan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def prefix_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis: fp32 accumulation for
    fp32 and bf16 (each output rounded to x's type), 32-bit integer
    arithmetic that wraps for int32."""
    if x.dim() < 1:
        raise ValueError("prefix_scan needs a tensor of rank >= 1")
    if x.device.type == "cpu":
        return prefix_scan_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_scan runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"prefix_scan kernel takes float32, bfloat16 or "
                        f"int32, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    if n == 0 or rows == 0 or rows >= 2 ** 31:
        raise ValueError(f"kernel takes 1 <= rows < 2**31 and a non-empty "
                         f"last axis; got shape {tuple(x.shape)}")
    from .build import LIBRARY
    lib = LIBRARY.load()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.prefix_scan_fwd(_DTYPE_CODE[x.dtype], x.data_ptr(),
                               out.data_ptr(), rows, n, stream)
    if code != 0:
        raise RuntimeError("prefix_scan launch failed: "
                           + lib.prefix_scan_error_string(code).decode())
    prefix_scan.launches += 1
    return out


prefix_scan.launches = 0
