"""The Mamba mixer's CUDA library: ``csrc/mamba_scan.cu``, built and loaded
at first use by :class:`repro_torch.kernels._build.CudaLibrary`."""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import CudaLibrary

__all__ = ["SOURCE", "LIBRARY"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
_p, _i, _l, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
LIBRARY = CudaLibrary("mamba_scan", SOURCE, {
    "mamba_conv_fwd": ([_i, _p, _l, _p, _p, _p, _p, _p, _i, _i, _i, _i, _p],
                       _i),
    "mamba_scan_fwd": ([_i, _p, _p, _l, _p, _l, _p, _l, _p, _p, _p, _p, _p,
                        _f, _p, _p, _i, _i, _i, _i, _p], _i),
    "mamba_scan_error_string": ([_i], ctypes.c_char_p),
})
