"""The flash-attention CUDA library: ``csrc/flash_attention.cu``, built and
loaded at first use by :class:`repro_torch.kernels._build.CudaLibrary`."""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import CudaLibrary

__all__ = ["SOURCE", "LIBRARY"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("flash_attention", SOURCE, {
    "flash_attention_fwd": ([_i, _i, _i, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                             _i, _i, _i, _i, _i, _i, _i, ctypes.c_float, _p],
                            _i),
    "flash_attention_error_string": ([_i], ctypes.c_char_p),
})
