"""The least time of one flash-attention decode call (one query row a
sequence, ``split`` route): bytes of q read and o written once and of the
valid K and V rows of each sequence once, FLOPs of QK^T and PV over the
valid columns.

Frozen copy of ``chip_smoke.py::_bound`` at commit 55bfaa9, for S = 1
without a causal or window mask (the decode call's masks are its
``kv_valid``)."""
from typing import Sequence

from .peaks import ELEMENT_BYTES, HBM_BYTES_S, PEAK_FLOPS


def decode_work(heads: int, kv_heads: int, head_dim: int,
                kv_valid: Sequence[int], dtype: str = "bfloat16") -> tuple:
    """(FLOPs, bytes) of one call over ``len(kv_valid)`` sequences."""
    elt = ELEMENT_BYTES[dtype]
    b = len(kv_valid)
    cols = sum(kv_valid)
    nbytes = 2 * b * heads * head_dim * elt + 2 * cols * kv_heads \
        * head_dim * elt
    return 4 * head_dim * heads * cols, nbytes


def decode_bound_s(heads: int, kv_heads: int, head_dim: int,
                   kv_valid: Sequence[int], dtype: str = "bfloat16") -> float:
    flops, nbytes = decode_work(heads, kv_heads, head_dim, kv_valid, dtype)
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype])
