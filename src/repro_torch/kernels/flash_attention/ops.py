"""Public wrapper: model layout [B, S, H, d] in and out, GQA, masking knobs.

On a CUDA tensor ``flash_attention`` launches the hand-written kernels of
``csrc/flash_attention.cu`` or raises; :func:`kernel_route` picks the route
from the dtype and the query length, and :func:`decode_plan` cuts the kv
axis of a decode call.  On a CPU tensor it runs the plain version
(``ref.flash_attention_plain``).  ``flash_attention.launches`` counts the
calls that launched a route, ``flash_attention.kernel_launches`` the
kernels they launched (a split decode of several splits is two: the split
pass and the combine pass), and ``flash_attention.route_launches`` the
calls by route.

The signature is that of ``repro/kernels/flash_attention/ops.py`` without
its TPU tiling knobs (``bq``, ``bk``, ``interpret``): the CUDA kernel picks
its own tiles and needs no padding.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import refuse_autograd, refuse_dtensor
from .ref import flash_attention_plain

__all__ = ["flash_attention", "kernel_route", "decode_plan", "DecodePlan",
           "HEAD_DIMS"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODE = {"fma": 0, "mma": 1, "split": 2}
#: the longest query the split (decode) route takes
DECODE_ROWS = 4
#: kv columns a tile of the kernels; a split's chunk is a multiple of it
KV_TILE = 64
#: CTAs a split decode aims at: two on each of the H100's 132 SMs
TARGET_CTAS = 264


class DecodePlan(NamedTuple):
    """The kv axis [0, T) cut into ``splits`` chunks of ``chunk`` columns
    (the last may be short)."""
    splits: int
    chunk: int


def kernel_route(dtype: torch.dtype, s: int) -> str:
    """The kernel a CUDA call of S query rows takes: ``"split"`` for decode
    (S <= 4, either dtype: split-KV with the query heads of a kv head packed
    in one CTA), ``"mma"`` (tensor cores) for bf16 prefill, ``"fma"`` (CUDA
    cores) for fp32 prefill, which stays off the tensor cores while TF32 is
    off."""
    if s <= DECODE_ROWS:
        return "split"
    return "mma" if dtype == torch.bfloat16 else "fma"


def decode_plan(b: int, hkv: int, t: int) -> DecodePlan:
    """How a decode call over T kv columns is split: ``want`` =
    ceil(TARGET_CTAS / (B * Hkv)) chunks of ceil(T / want) columns, each
    rounded up to whole KV_TILE tiles (so at most ``want`` splits, and about
    TARGET_CTAS CTAs where T is long enough).  A pure function of the shapes:
    never of ``kv_valid``, which lives on the device, so a row's result
    depends only on T and the plan, not on other rows."""
    if b < 1 or hkv < 1 or t < 1:
        raise ValueError(f"decode_plan needs positive B, Hkv, T; got {b}, "
                         f"{hkv}, {t}")
    want = -(-TARGET_CTAS // (b * hkv))
    chunk = -(-t // want)
    chunk = -(-chunk // KV_TILE) * KV_TILE
    return DecodePlan(-(-t // chunk), chunk)


def _check_cuda(q, k, v, kv_valid) -> None:
    dev = q.device
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if kv_valid is not None:
        if kv_valid.device != dev or kv_valid.dtype != torch.int32 \
                or kv_valid.shape != (q.shape[0],) \
                or not kv_valid.is_contiguous():
            raise ValueError(f"kv_valid must be a contiguous int32 [B] "
                             f"tensor on {dev}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B, S, H, d]; k, v: [B, T, Hkv, d] -> [B, S, H, d].

    ``kv_valid``: optional [B] int32 per-sequence count of valid kv
    positions (None = T).  ``q_offset``: absolute position of query row 0
    for the causal and window masks (``T - S`` = bottom-right alignment)."""
    refuse_dtensor("flash_attention", q, k, v, kv_valid)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,S,H,d], k/v [B,T,Hkv,d]; got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"mismatched q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid, causal=causal,
                                     window=window, scale=scale,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    refuse_autograd("flash_attention", q, k, v)
    _check_cuda(q, k, v, kv_valid)
    from .build import LIBRARY
    lib = LIBRARY.load()
    out = torch.empty_like(q)
    route = kernel_route(q.dtype, s)
    plan, scratch = DecodePlan(1, t), None
    if route == "split":
        plan = decode_plan(b, hkv, t)
        if plan.splits > 1:   # per split and row: acc [d], then (m, l)
            scratch = torch.empty(plan.splits * b * s * h * (d + 2),
                                  dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_fwd(
        _DTYPE_CODE[q.dtype], d, _ROUTE_CODE[route],
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_valid is None else kv_valid.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        b, s, t, h, hkv, int(q_offset), int(bool(causal)),
        0 if window is None else int(window), plan.splits, plan.chunk,
        ctypes.c_float(scale), stream)
    if code != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(code).decode())
    flash_attention.launches += 1
    flash_attention.kernel_launches += 2 if plan.splits > 1 else 1
    flash_attention.route_launches[route] += 1
    return out


flash_attention.launches = 0
flash_attention.kernel_launches = 0
flash_attention.route_launches = dict.fromkeys(_ROUTE_CODE, 0)
