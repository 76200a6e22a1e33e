"""The least time of one grouped-SwiGLU call (``[E, C, D]`` rows against
``[E, D, F]`` gate and up and ``[E, F, D]`` down weights): FLOPs on the
kept rows, and bytes of the weights of every expert that received a row,
the kept rows read and the whole ``[E, C, D]`` output written.

Frozen copy of ``chip_smoke.py::_gmm_bound`` at commit 55bfaa9."""
from typing import Sequence

from .peaks import ELEMENT_BYTES, HBM_BYTES_S, PEAK_FLOPS


def gmm_work(e: int, c: int, d: int, f: int, loads: Sequence[int],
             dtype: str = "bfloat16") -> tuple:
    """(FLOPs, bytes) of the call."""
    elt = ELEMENT_BYTES[dtype]
    rows = sum(loads)
    nbytes = (sum(1 for n in loads if n > 0) * 3 * d * f + rows * d
              + e * c * d) * elt
    return 6 * rows * d * f, nbytes


def gmm_bound_s(e: int, c: int, d: int, f: int, loads: Sequence[int],
                dtype: str = "bfloat16") -> float:
    flops, nbytes = gmm_work(e, c, d, f, loads, dtype)
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype])
