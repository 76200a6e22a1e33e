"""The WKV-6 CUDA library: ``csrc/wkv6.cu``, built and loaded at first use
by :class:`repro_torch.kernels._build.CudaLibrary`."""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import CudaLibrary

__all__ = ["SOURCE", "LIBRARY"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("wkv6", SOURCE, {
    "wkv6_fwd": ([_i, _i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
                 _i),
    "wkv6_error_string": ([_i], ctypes.c_char_p),
})
