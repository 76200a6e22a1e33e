"""Plain PyTorch versions of the Mamba mixer's two kernels.  Training,
every CPU tensor and the card's yardstick take them.

Each takes a sequence (``[B, T, ...]``: the prefill's code, the conv as a
sum of shifted products and the reference's chunked scan) or one step
(``[B, ...]``: the decode's code, the conv as an einsum and the one-step
recurrence); the two forms round differently, so each keeps its own.

:func:`scan_chunked` is the reference's chunked scan, and
:func:`scan_chunk` the chunk it takes for a call's length.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["mamba_conv_plain", "mamba_scan_plain", "scan_chunked",
           "scan_chunk"]


def scan_chunked(a_t: torch.Tensor, b_t: torch.Tensor, h0: torch.Tensor,
                 chunk: int):
    """h_t = a_t * h_{t-1} + b_t over time.  a_t, b_t: [B, T, di, ds] fp32;
    h0: [B, di, ds].  Returns (every h_t [B, T, di, ds], h_T).

    The reference's chunked scan: T padded to chunks of ``chunk`` with
    identity steps (decay 1, input 0), an inclusive scan of (a, b) under
    (a1, b1) ∘ (a2, b2) = (a1 a2, a2 b1 + b2) inside each chunk, and an
    outer loop over the chunks that carries h.  The inner scans of all
    chunks run at once, a step at a time (``chunk`` - 1 steps, each over
    every chunk); they only ever multiply decays, so a chunk's cumulative
    decay may underflow to 0 where Δ·A sums below -87 without a division
    by it.  Without autograd the steps are written in place (``out=``);
    where a backward pass can follow, each step is a tensor of its own and
    the steps are stacked, with the same operations in the same order, so
    both forms give the same bits."""
    b, t, di, ds = a_t.shape
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        a_t = F.pad(a_t, (0, 0, 0, 0, 0, pad), value=1.0)
        b_t = F.pad(b_t, (0, 0, 0, 0, 0, pad))
    n = (t + pad) // c
    a = a_t.reshape(b, n, c, di, ds)
    b_in = b_t.reshape(b, n, c, di, ds)
    if torch.is_grad_enabled() and (a.requires_grad or b_in.requires_grad
                                    or h0.requires_grad):
        a_steps, b_steps = [a[:, :, 0]], [b_in[:, :, 0]]
        for j in range(1, c):
            b_steps.append(torch.addcmul(b_in[:, :, j], a[:, :, j],
                                         b_steps[-1]))
            a_steps.append(torch.mul(a_steps[-1], a[:, :, j]))
        a_cum = torch.stack(a_steps, 2)
        b_cum = torch.stack(b_steps, 2)
    else:
        a_cum = a.clone()
        b_cum = b_in.clone()
        for j in range(1, c):
            torch.addcmul(b_cum[:, :, j], a[:, :, j], b_cum[:, :, j - 1],
                          out=b_cum[:, :, j])
            torch.mul(a_cum[:, :, j - 1], a[:, :, j], out=a_cum[:, :, j])
    # the carry: h entering each chunk, then h_t = b_cum + a_cum h_in
    h, h_in = h0, []
    for i in range(n):
        h_in.append(h)
        h = torch.addcmul(b_cum[:, i, -1], a_cum[:, i, -1], h)
    hs = torch.addcmul(b_cum, a_cum, torch.stack(h_in, 1)[:, :, None])
    return hs.reshape(b, n * c, di, ds)[:, :t], h


def scan_chunk(t: int, cap: int) -> int:
    """The chunk of :func:`scan_chunked` for ``t`` steps: of 1..``cap``
    the one that issues the fewest launches, 2 (c - 1) + ceil(t / c) (the
    inner steps' two ops each, the carry's one a chunk), the largest of
    equals.  A 512-token prefill chunk takes 16 (66 launches against 138
    at 64), a 3072-token prompt 41."""
    return min(range(1, max(1, min(cap, t)) + 1),
               key=lambda c: (2 * (c - 1) + -(-t // c), -c))


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """``models/layers.py::rms_norm``, its operations in its order (that
    module imports this package's user, so it is not imported here)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def mamba_conv_plain(x: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor):
    """The depthwise causal conv over ``[conv_state, x]``, its bias and
    SiLU: x [B, T, di] or one step [B, di], conv_state [B, dc-1, di],
    w [dc, di], b [di] -> (xc shaped as x, the next conv state: the last
    dc - 1 rows)."""
    if x.dim() == 2:
        xfull = torch.cat([conv_state, x[:, None]], dim=1)    # [B, dc, di]
        xc = F.silu(torch.einsum("bcd,cd->bd", xfull, w) + b)
        return xc, xfull[:, 1:]
    t, dc = x.shape[1], w.shape[0]
    xpad = torch.cat([conv_state, x], dim=1)
    conv_next = xpad[:, -(dc - 1):] if dc > 1 else conv_state
    xc = sum(xpad[:, i:i + t] * w[i] for i in range(dc))
    return F.silu(xc + b), conv_next


def mamba_scan_plain(xc: torch.Tensor, dt: torch.Tensor, bc: torch.Tensor,
                     z: torch.Tensor, a_log: torch.Tensor,
                     d_skip: torch.Tensor, h0: torch.Tensor,
                     b_norm: Optional[torch.Tensor] = None,
                     c_norm: Optional[torch.Tensor] = None,
                     eps: float = 1e-5, chunk: int = 64):
    """The selective scan from the conv's output to the gated y.  xc, z:
    [B, T, di] or one step [B, di]; dt: dt_proj's output (bias included),
    shaped as xc; bc: x_proj's B and C columns [..., 2 ds]; a_log
    [di, ds]; d_skip [di]; h0 [B, di, ds] fp32; ``b_norm``, ``c_norm``:
    the inner norms' scales [ds], or None.  Returns (y shaped as xc, in
    z's type; h_end [B, di, ds] fp32).  In fp32: softplus(Δ), the decays
    exp(Δ A) with A = -exp(a_log), h = decay h + Δ x B, y = C·h + D x;
    then y * silu(z) in the model's type.  A sequence is scanned in chunks
    of at most ``chunk`` steps (:func:`scan_chunk`)."""
    ds = h0.shape[-1]
    bmat, cmat = bc[..., :ds], bc[..., ds:]
    if b_norm is not None:
        bmat = _rms_norm(bmat, b_norm, eps)
        cmat = _rms_norm(cmat, c_norm, eps)
    dt = F.softplus(dt.float())
    bmat = bmat.float()
    cmat = cmat.float()
    a = -torch.exp(a_log)                                      # [di, ds]
    decay = torch.exp(dt[..., None] * a)
    inp = (dt * xc.float())[..., None] * bmat[..., None, :]
    if xc.dim() == 2:
        h = decay * h0 + inp
        y = torch.einsum("bds,bs->bd", h, cmat)
    else:
        hs, h = scan_chunked(decay, inp, h0, scan_chunk(xc.shape[1], chunk))
        y = torch.einsum("btds,bts->btd", hs, cmat)
    y = (y + xc.float() * d_skip).to(z.dtype)
    return y * F.silu(z), h
