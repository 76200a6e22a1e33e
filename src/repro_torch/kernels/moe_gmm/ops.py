"""Public wrapper: expert buffers [E, C, D] and stacked expert weights in,
[E, C, D] out.

On a CUDA tensor ``grouped_swiglu`` launches the hand-written kernel
(``csrc/moe_gmm.cu``, two phases) or raises; on a CPU tensor it runs the
plain version (``ref.grouped_swiglu_plain``).  ``grouped_swiglu.launches``
counts the calls that launched the kernel and
``grouped_swiglu.kernel_launches`` the kernels they launched (two a call,
one a phase).

The signature is that of ``repro/kernels/moe_gmm/ops.py`` without its TPU
tiling knobs (``bc``, ``bf``, ``interpret``), plus the dispatch plan's
``load``: the CUDA kernel picks its own tiles, masks ragged edges instead of
padding, and skips the empty rows beyond each expert's load.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import grouped_swiglu_plain

__all__ = ["grouped_swiglu"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda(x, w_gate, w_up, w_down, load) -> None:
    dev = x.device
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if w.device != dev:
            raise ValueError(f"{name} is on {w.device}, x on {dev}")
        if w.dtype != x.dtype:
            raise TypeError(f"{name} is {w.dtype}, x is {x.dtype}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"grouped_swiglu kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    vec = 16 // x.element_size()
    d, f = x.shape[2], w_gate.shape[2]
    if d % vec or f % vec:
        raise ValueError(f"D={d} and F={f} must be multiples of {vec} for "
                         f"{x.dtype}")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if load is not None:
        if load.device != dev or load.dtype != torch.int32 \
                or load.shape != (x.shape[0],) or not load.is_contiguous():
            raise ValueError(f"load must be a contiguous int32 [E] tensor "
                             f"on {dev}")


def grouped_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor,
                   load: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [E, C, D]; w_gate/w_up: [E, D, F]; w_down: [E, F, D] -> [E, C, D].

    ``load``: optional [E] int32, expert e's kept rows.  They must be the
    prefix ``[0, load[e])`` of its slab, with zero rows after it (what
    ``priority_dispatch`` and ``gather_expert_inputs`` produce); the kernel
    skips the rows beyond and writes them as zeros.  None = every row."""
    if x.dim() != 3 or w_gate.dim() != 3 or w_gate.shape != w_up.shape \
            or w_down.dim() != 3:
        raise ValueError(f"x [E,C,D], w_gate/w_up [E,D,F], w_down [E,F,D]; "
                         f"got {tuple(x.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)}")
    e, c, d = x.shape
    f = w_gate.shape[2]
    if w_gate.shape[:2] != (e, d) or w_down.shape != (e, f, d):
        raise ValueError(f"mismatched x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_down "
                         f"{tuple(w_down.shape)}")
    if x.device.type == "cpu":
        return grouped_swiglu_plain(x, w_gate, w_up, w_down, load)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_swiglu runs on cuda or cpu, not "
                         f"{x.device}")
    _check_cuda(x, w_gate, w_up, w_down, load)
    from .build import LIBRARY
    lib = LIBRARY.load()
    h = torch.empty(e, c, f, dtype=x.dtype, device=x.device)   # phase (a)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.grouped_swiglu_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), w_down.data_ptr(),
        None if load is None else load.data_ptr(), h.data_ptr(),
        y.data_ptr(), e, c, d, f, stream)
    if code != 0:
        raise RuntimeError("grouped_swiglu launch failed: "
                           + lib.grouped_swiglu_error_string(code).decode())
    grouped_swiglu.launches += 1
    grouped_swiglu.kernel_launches += 2
    return y


grouped_swiglu.launches = 0
grouped_swiglu.kernel_launches = 0
