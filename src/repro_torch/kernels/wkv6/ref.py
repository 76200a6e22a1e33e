"""Plain PyTorch version of the WKV-6 kernel: the recurrence of
``repro/kernels/wkv6/kernel.py``, step by step, in its order."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["wkv6_plain"]


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None):
    """r, k, v, w: [B, T, H, N]; u: [H, N]; s0: optional [B, H, N, N]
    (zeros when omitted).  Returns (y [B, T, H, N] in r's type, s_end
    [B, H, N, N] fp32).

    In fp32, per step: y from the state before the step, with the bonus
    term written as ``(r * u * k).sum() * v`` as the kernel writes it, then
    ``S = w S + k v^T``."""
    b, t, h, n = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    s = torch.zeros(b, h, n, n, dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float().clone()
    ys = torch.empty(b, t, h, n, dtype=torch.float32, device=r.device)
    for i in range(t):
        ri, ki, vi, wi = rf[:, i], kf[:, i], vf[:, i], wf[:, i]  # [B, H, N]
        ys[:, i] = (torch.einsum("bhk,bhkv->bhv", ri, s)
                    + (ri * uf * ki).sum(-1, keepdim=True) * vi)
        s = wi[..., None] * s + ki[..., None] * vi[..., None, :]
    return ys.to(r.dtype), s
