"""Public wrapper: inclusive prefix sum along the last axis of a tensor of
any rank >= 1.

On a CUDA tensor ``prefix_scan`` launches the hand-written one-pass kernel
(``csrc/prefix_scan.cu``, decoupled look-back) or raises; on a CPU tensor it
runs the plain version (``ref.prefix_scan_plain``).  ``prefix_scan.launches``
counts kernel launches.

The signature is that of ``repro/kernels/prefix_scan/ops.py`` without its
TPU knobs (``block``, ``interpret``): the kernel picks its tile from the row
length and masks the ragged end of a row instead of padding it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import refuse_autograd, refuse_dtensor
from .ref import prefix_scan_plain

__all__ = ["prefix_scan", "ScanPlan", "scan_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


class ScanPlan(NamedTuple):
    block: int            # threads a tile
    items: int            # elements a thread (a tile: block * items)
    tiles_per_row: int
    scratch_words: int    # zeroed int64 words: tile status + counter, or 0


def scan_plan(rows: int, n: int) -> ScanPlan:
    """The kernel's tiling of a [rows, n] scan: 128 x 8 elements for rows of
    at most 1024, 512 x 8 for rows of at most 4096 (one tile a row), else
    512 x 16 (half as many look-backs a row as 4096-element tiles); the
    look-back's scratch (one status word a tile, then the tile counter)
    only when a row spans more than one tile."""
    block, items = (128, 8) if n <= 1024 else (512, 8) if n <= 4096 \
        else (512, 16)
    tiles = -(-n // (block * items))
    return ScanPlan(block, items, tiles, rows * tiles + 1 if tiles > 1 else 0)


def prefix_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis: fp32 accumulation for
    fp32 and bf16 (each output rounded to x's type), 32-bit integer
    arithmetic that wraps for int32."""
    refuse_dtensor("prefix_scan", x)
    if x.dim() < 1:
        raise ValueError("prefix_scan needs a tensor of rank >= 1")
    if x.device.type == "cpu":
        return prefix_scan_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_scan runs on cuda or cpu, not {x.device}")
    refuse_autograd("prefix_scan", x)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"prefix_scan kernel takes float32, bfloat16 or "
                        f"int32, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    plan = scan_plan(rows, n) if n and rows else None
    if plan is None or rows * plan.tiles_per_row >= 2 ** 31:
        raise ValueError(f"kernel takes 1 <= rows * tiles < 2**31 and a "
                         f"non-empty last axis; got shape {tuple(x.shape)}")
    from .build import LIBRARY
    lib = LIBRARY.load()
    out = torch.empty_like(x)
    scratch = (torch.zeros(plan.scratch_words, dtype=torch.int64,
                           device=x.device) if plan.scratch_words else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.prefix_scan_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), rows, n,
        plan.block, plan.items,
        None if scratch is None else scratch.data_ptr(), stream)
    if code != 0:
        raise RuntimeError("prefix_scan launch failed: "
                           + lib.prefix_scan_error_string(code).decode())
    prefix_scan.launches += 1
    return out


prefix_scan.launches = 0
