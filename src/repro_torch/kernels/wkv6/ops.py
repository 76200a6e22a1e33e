"""Public wrapper: the RWKV-6 recurrence over [B, T, H, N] inputs, with an
initial state in and the final state out.

On a CUDA tensor ``wkv6`` launches the hand-written kernel
(``csrc/wkv6.cu``, the chunked form on the tensor cores) or raises; on a CPU
tensor it runs the plain version (``ref.wkv6_plain``).  ``wkv6.launches``
counts kernel launches.

The signature is that of ``repro/kernels/wkv6/ops.py`` without its TPU
knobs (``chunk``, ``interpret``): the kernel's chunks are 64 steps and it
masks the ragged last one, so T needs no padding.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import refuse_autograd, refuse_dtensor
from .ref import CHUNK, wkv6_plain

__all__ = ["wkv6", "HEAD_SIZES", "WkvPlan", "wkv6_plan"]

#: head sizes N the kernel is instantiated for
HEAD_SIZES = (16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class WkvPlan(NamedTuple):
    chunks: int          # chunks of CHUNK steps a (b, h) sequence
    ctas: int            # one a (b, h, chunk)
    chain_words: int     # zeroed 64-bit words: two tagged states a head,
                         # then the chunk counter


def wkv6_plan(b: int, t: int, h: int, n: int) -> WkvPlan:
    """The kernel's launch: a CTA a (b, h, chunk); the states that cross
    chunks, and the counter that hands out chunks, only when a sequence has
    more than one chunk."""
    chunks = -(-t // CHUNK)
    return WkvPlan(chunks, b * h * chunks,
                   2 * b * h * n * n + 1 if chunks > 1 else 0)


def _check_cuda(r, k, v, w, u, s0) -> None:
    dev = r.device
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if s0 is not None:
        named.append(("s0", s0))
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, r on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    # the two combinations the model produces: r/k/v in the model's type,
    # the decay, bonus and state in fp32
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16 r, not "
                        f"{r.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != r.dtype:
            raise TypeError(f"{name} is {x.dtype}, r is {r.dtype}")
    for name, x in named[3:]:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {x.dtype}")
    if r.shape[-1] not in HEAD_SIZES:
        raise ValueError(f"head size {r.shape[-1]} not in {HEAD_SIZES}")
    b, t, h, n = r.shape
    if t == 0 or wkv6_plan(b, t, h, n).ctas >= 2 ** 31:
        raise ValueError(f"kernel takes 1 <= T and B H ceil(T / {CHUNK}) "
                         f"< 2**31; got B={b}, T={t}, H={h}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: Optional[torch.Tensor] = None):
    """r, k, v: [B, T, H, N]; w: [B, T, H, N] decay in (0, 1); u: [H, N];
    s0: optional [B, H, N, N] initial state (zeros when omitted).  Returns
    (y [B, T, H, N] in r's type, s_end [B, H, N, N] fp32)."""
    refuse_dtensor("wkv6", r, k, v, w, u, s0)
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or w.shape != r.shape:
        raise ValueError(f"r, k, v, w must share one [B, T, H, N] shape; "
                         f"got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    b, _, h, n = r.shape
    if u.shape != (h, n) or (s0 is not None and s0.shape != (b, h, n, n)):
        raise ValueError(f"u must be [H, N] = {(h, n)} and s0 [B, H, N, N] "
                         f"= {(b, h, n, n)}; got {tuple(u.shape)}, "
                         f"{None if s0 is None else tuple(s0.shape)}")
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    refuse_autograd("wkv6", r, k, v, w, u, s0)
    _check_cuda(r, k, v, w, u, s0)
    from .build import LIBRARY
    lib = LIBRARY.load()
    plan = wkv6_plan(b, r.shape[1], h, n)
    y = torch.empty_like(r)
    s_end = torch.empty(b, h, n, n, dtype=torch.float32, device=r.device)
    # zeroed: a state word's tag (its chunk + 1) must never match stale bits
    chain = torch.zeros(plan.chain_words, dtype=torch.int64,
                        device=r.device) if plan.chain_words else None
    stream = torch.cuda.current_stream(r.device).cuda_stream
    code = lib.wkv6_fwd(
        _DTYPE_CODE[r.dtype], n, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
        y.data_ptr(), s_end.data_ptr(),
        None if chain is None else chain.data_ptr(), b, r.shape[1], h,
        stream)
    if code != 0:
        raise RuntimeError("wkv6 launch failed: "
                           + lib.wkv6_error_string(code).decode())
    wkv6.launches += 1
    return y, s_end


wkv6.launches = 0
