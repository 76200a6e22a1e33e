"""The MoE dispatch CUDA library: ``csrc/moe_dispatch.cu``, built and loaded
at first use by :class:`repro_torch.kernels._build.CudaLibrary`."""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import CudaLibrary

__all__ = ["SOURCE", "LIBRARY"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_dispatch.cu"
_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("moe_dispatch", SOURCE, {
    "moe_route_fwd": ([_p, _p, _p, _p, _p, _p, _i, _i, _i, _p], _i),
    "moe_dispatch_fwd": ([_i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
                          _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i,
                          _i, _p], _i),
    "moe_combine_fwd": ([_i, _p, _p, _p, _p, _i, _i, _i, _p], _i),
    "moe_dispatch_error_string": ([_i], ctypes.c_char_p),
})
