"""Public wrappers of the Mamba mixer's conv and selective scan.

On CUDA tensors they launch the hand-written kernels
(``csrc/mamba_scan.cu``) or raise; on CPU tensors they run the plain form
(``ref.py``).  A Mamba layer call takes the two, with the plain GEMMs
x_proj and dt_proj (and the Δ norm) between them: :func:`mamba_conv`,
then :func:`mamba_scan`.  Both take a sequence ``[B, T, ...]`` (a
prefill chunk) or one step ``[B, ...]`` (decode); on the card one kernel
serves both.

``mamba_scan.launches`` counts the kernels the two launched (two a layer
call), ``mamba_scan.route_launches`` the same by instantiation
(:func:`kernel_route`), and ``mamba_scan.tokens`` the rows x steps the
scan kernel scanned.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import refuse_autograd, refuse_dtensor
from .ref import mamba_conv_plain, mamba_scan_plain

__all__ = ["mamba_conv", "mamba_scan", "kernel_route"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the conv kernel keeps its window in registers: d_conv of 1 to MAX_CONV
MAX_CONV = 4
#: the scan kernel's d_state (4 states a thread, the lanes of a channel
#: within one warp): Mamba's published 16, and 8, the scaled-down configs'
STATES = (8, 16)


def kernel_route(dtype: torch.dtype) -> str:
    """The instantiation of the two kernels a CUDA call of ``dtype``
    takes: ``"fp32"`` or ``"bf16"``."""
    return "fp32" if dtype == torch.float32 else "bf16"


def _library():
    from .build import LIBRARY
    return LIBRARY.load()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} "
                         f"{list(shape)} tensor on {device}; got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")


def _row_stride(name: str, t: torch.Tensor, device, dtype, shape) -> int:
    """The distance between rows of ``t`` (``shape``: its leading dims
    flatten to rows of its last dim, which is contiguous), read in place:
    a view such as in_proj's halves or x_proj's B and C columns."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or t.stride(-1) != 1:
        raise ValueError(f"{name} must be a {dtype} {list(shape)} tensor "
                         f"on {device} with contiguous rows; got {t.dtype} "
                         f"{list(t.shape)} (strides {t.stride()}) on "
                         f"{t.device}")
    try:
        return t.view(-1, shape[-1]).stride(0)
    except RuntimeError:
        raise ValueError(f"{name}: rows {t.stride()} apart do not flatten "
                         f"to one stride") from None


def _raise(what: str, code: int, lib) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.mamba_scan_error_string(code).decode())


def _common(name: str, x: torch.Tensor) -> tuple:
    """(B, T, D) of a sequence [B, T, D] or one step [B, D] on CUDA."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if x.dim() not in (2, 3) or 0 in x.shape:
        raise ValueError(f"{name}: x [B, T, D] or one step [B, D]; got "
                         f"{list(x.shape)}")
    return x.shape[0], (x.shape[1] if x.dim() == 3 else 1), x.shape[-1]


def mamba_conv(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """The depthwise causal conv over ``[conv_state, x]``, its bias and
    SiLU.  x: [B, T, di] or one step [B, di] (rows may be strided: in_proj's
    first half); conv_state [B, dc-1, di]; w [dc, di]; b [di], all of x's
    type -> (xc shaped as x, contiguous; the next conv state [B, dc-1, di],
    the last dc - 1 rows).  The state passed in is not modified."""
    refuse_dtensor("mamba_conv", x, conv_state, w, b)
    if x.device.type == "cpu":
        return mamba_conv_plain(x, conv_state, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_conv runs on cuda or cpu, not {x.device}")
    refuse_autograd("mamba_conv", x, conv_state, w, b)
    bsz, t, di = _common("mamba_conv", x)
    dc = w.shape[0] if w.dim() == 2 else 0
    if not 1 <= dc <= MAX_CONV:
        raise ValueError(f"mamba_conv takes w [d_conv, di] with 1 <= d_conv "
                         f"<= {MAX_CONV}; got {list(w.shape)}")
    dev = x.device
    x_row = _row_stride("x", x, dev, x.dtype, tuple(x.shape))
    _check("conv_state", conv_state, dev, x.dtype, (bsz, dc - 1, di))
    _check("w", w, dev, x.dtype, (dc, di))
    _check("b", b, dev, x.dtype, (di,))
    xc = torch.empty(x.shape, dtype=x.dtype, device=dev)
    state = torch.empty(bsz, dc - 1, di, dtype=x.dtype, device=dev)
    lib = _library()
    _raise("mamba_conv", lib.mamba_conv_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), x_row, conv_state.data_ptr(),
        w.data_ptr(), b.data_ptr(), xc.data_ptr(), state.data_ptr(), bsz, t,
        di, dc, _stream(x)), lib)
    mamba_scan.launches += 1
    mamba_scan.route_launches[kernel_route(x.dtype)] += 1
    return xc, state


def mamba_scan(xc: torch.Tensor, dt: torch.Tensor, bc: torch.Tensor,
               z: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
               h0: torch.Tensor, b_norm: Optional[torch.Tensor] = None,
               c_norm: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """The selective scan from the conv's output to the gated y (see
    ``ref.mamba_scan_plain``).  xc [B, T, di] or one step [B, di]; dt
    (dt_proj's output, bias included) and z (in_proj's second half) shaped
    as xc; bc: x_proj's B and C columns [..., 2 ds]; dt, z and bc may have
    strided rows and are read in place; a_log [di, ds] and d_skip [di]
    fp32; h0 [B, di, ds] fp32; ``b_norm``, ``c_norm``: the inner norms'
    scales [ds] (xc's type), both or neither; ``eps`` theirs.  Returns (y
    shaped as xc, xc's type; h_end [B, di, ds] fp32); h0 is not modified.
    The kernel walks the steps one by one; the CPU form scans in chunks of
    at most ``mamba_scan_plain``'s default (a model's layer binds its
    ``cfg.ssm_chunk`` to the plain function instead)."""
    refuse_dtensor("mamba_scan", xc, dt, bc, z, a_log, d_skip, h0, b_norm,
                   c_norm)
    if xc.device.type == "cpu":
        return mamba_scan_plain(xc, dt, bc, z, a_log, d_skip, h0, b_norm,
                                c_norm, eps)
    if xc.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cuda or cpu, not {xc.device}")
    refuse_autograd("mamba_scan", xc, dt, bc, z, a_log, d_skip, h0, b_norm,
                    c_norm)
    bsz, t, di = _common("mamba_scan", xc)
    ds = h0.shape[-1]
    if ds not in STATES:
        raise ValueError(f"mamba_scan takes d_state in {STATES}; got h0 "
                         f"{list(h0.shape)}")
    if (b_norm is None) != (c_norm is None):
        raise ValueError("mamba_scan: b_norm and c_norm come together")
    dev, dtype = xc.device, xc.dtype
    _check("xc", xc, dev, dtype, tuple(xc.shape))
    dt_row = _row_stride("dt", dt, dev, dtype, tuple(xc.shape))
    z_row = _row_stride("z", z, dev, dtype, tuple(xc.shape))
    bc_row = _row_stride("bc", bc, dev, dtype, tuple(xc.shape[:-1])
                         + (2 * ds,))
    _check("a_log", a_log, dev, torch.float32, (di, ds))
    _check("d_skip", d_skip, dev, torch.float32, (di,))
    _check("h0", h0, dev, torch.float32, (bsz, di, ds))
    if b_norm is not None:
        _check("b_norm", b_norm, dev, dtype, (ds,))
        _check("c_norm", c_norm, dev, dtype, (ds,))
    y = torch.empty(xc.shape, dtype=dtype, device=dev)
    h_end = torch.empty(bsz, di, ds, dtype=torch.float32, device=dev)
    lib = _library()
    _raise("mamba_scan", lib.mamba_scan_fwd(
        _DTYPE_CODE[dtype], xc.data_ptr(), dt.data_ptr(), dt_row,
        bc.data_ptr(), bc_row, z.data_ptr(), z_row, a_log.data_ptr(),
        d_skip.data_ptr(), h0.data_ptr(),
        None if b_norm is None else b_norm.data_ptr(),
        None if c_norm is None else c_norm.data_ptr(), eps, y.data_ptr(),
        h_end.data_ptr(), bsz, t, di, ds, _stream(xc)), lib)
    mamba_scan.launches += 1
    mamba_scan.route_launches[kernel_route(dtype)] += 1
    mamba_scan.tokens += bsz * t
    return y, h_end


mamba_scan.launches = 0
mamba_scan.route_launches = {"fp32": 0, "bf16": 0}
mamba_scan.tokens = 0
