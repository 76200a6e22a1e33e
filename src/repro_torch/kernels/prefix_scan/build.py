"""The prefix-scan CUDA library: ``csrc/prefix_scan.cu``, built and loaded
at first use by :class:`repro_torch.kernels._build.CudaLibrary`."""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import CudaLibrary

__all__ = ["SOURCE", "LIBRARY"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "prefix_scan.cu"
_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("prefix_scan", SOURCE, {
    "prefix_scan_fwd": ([_i, _p, _p, _i, ctypes.c_long, _p], _i),
    "prefix_scan_error_string": ([_i], ctypes.c_char_p),
})
