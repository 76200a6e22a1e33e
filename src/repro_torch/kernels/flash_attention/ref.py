"""Plain PyTorch versions of the flash-attention kernel.

``mha_ref`` is the softmax oracle of ``repro/kernels/flash_attention/ref.py``
in the kernel layout; ``flash_attention_plain`` computes exactly what the
kernel computes (-1e30 masked logits, p forced to 0, l clamped at 1e-30) in
the model layout, in one pass instead of blocks.  The CPU path of
:func:`..ops.flash_attention` runs it; on the card it is the yardstick the
kernel is held against.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mha_ref", "flash_attention_plain"]

_NEG = -1e30


def _mask(s: int, t: int, *, causal: bool, window: Optional[int],
          q_offset: int, kv_valid: Optional[torch.Tensor], b: int,
          device) -> torch.Tensor:
    """[B, 1, S, T] bool: row i (absolute q_offset + i) may see column j."""
    i = q_offset + torch.arange(s, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= i - j < window
    mask = mask.expand(b, 1, s, t)
    if kv_valid is not None:
        mask = mask & (j < kv_valid.to(device).reshape(b, 1, 1, 1))
    return mask


def mha_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None, q_offset: int = 0,
            kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B,H,S,d]; k, v: [B,Hkv,T,d].  Returns [B,H,S,d] (softmax with
    -inf masking; a fully masked row is NaN, as in the JAX oracle)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    mask = _mask(s, t, causal=causal, window=window, q_offset=q_offset,
                 kv_valid=kv_valid, b=b, device=q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, kv_valid: Optional[torch.Tensor] = None, *,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """q: [B, S, H, d]; k, v: [B, T, Hkv, d] -> [B, S, H, d] with the
    kernel's semantics; a fully masked row is 0."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qf = q.float().permute(0, 2, 1, 3)                             # B,H,S,d
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(h // hkv, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(h // hkv, dim=1)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale        # B,H,S,T
    mask = _mask(s, t, causal=causal, window=window, q_offset=q_offset,
                 kv_valid=kv_valid, b=b, device=q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, vf) / l
    return out.permute(0, 2, 1, 3).to(q.dtype)
