"""Plain PyTorch versions of the WKV-6 kernel: the recurrence of
``repro/kernels/wkv6/kernel.py`` step by step, in its order
(``wkv6_plain``, the wrapper's CPU route and the card's yardstick), and the
CUDA kernel's chunked algorithm (``wkv6_chunked_plain``, for the tests)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["wkv6_plain", "wkv6_chunked_plain", "CHUNK", "SUB", "LOG_FLOOR"]

#: steps a chunk, and steps a sub-block of a chunk, in the CUDA kernel
CHUNK, SUB = 64, 16
#: floor of a step's log decay: a decay below e^-30 counts as e^-30, which
#: changes the state it multiplies by at most e^-30 (~1e-13) of its size
#: and keeps every exponent finite (fp32 w underflows to 0 for
#: w = exp(-exp(x)), x > ~4.6, and log 0 = -inf)
LOG_FLOOR = -30.0


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


def _cumsum_rev_excl(x: torch.Tensor) -> torch.Tensor:
    """Along dim -2: out[j] = x[j+1] + ... + x[-1] (0 for the last)."""
    incl = torch.flip(torch.cumsum(torch.flip(x, (-2,)), -2), (-2,))
    return torch.cat([incl[..., 1:, :], torch.zeros_like(incl[..., :1, :])],
                     -2)


def wkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       s0: Optional[torch.Tensor] = None):
    """The CUDA kernel's algorithm in plain fp32 PyTorch: what it computes
    is ``wkv6_plain``'s; how is the chunked form.  For tests only.

    Each (b, h) sequence is cut into chunks of CHUNK steps (the last one
    zero-padded: r = k = v = 0 add nothing), each chunk into sub-blocks of
    SUB.  With lam = max(log w, LOG_FLOOR) and L the sum of lam from the
    chunk's start, within a chunk

        y_i   = (r_i e^{L_(i-1)}) S_in + sum_(j<i) A[i,j] v_j + (r_i u k_i) v_i
        A[i,j] = sum_n r_i[n] k_j[n] e^{L_(i-1)[n] - L_j[n]}
        S_out = e^{L_last} S_in + sum_j (k_j e^{L_last - L_j}) v_j^T

    Every exponent is a sum of lam over the steps between two points, so
    it is <= 0 and every factor <= 1: nothing overflows and no inf - inf
    occurs.  None is taken as a difference of two long cumulative sums
    (which would cancel): with E (the sum within the sub-block before a
    step), Q (after a step) and G (a sub-block's total), the factors are
    e^E, e^Q and per channel e^{G_(J+1) + .. + G_(I-1)},
    e^{G_0 + .. + G_(I-1)} and e^{G_(I+1) + .. + G_last}, multiplied
    together.  The off-diagonal blocks of A factor through the step before
    the row block's start, A[I, J] = (r_I e^{E_I} e^{G_(J+1) + .. +
    G_(I-1)}) (k_J e^{Q_J})^T; in the diagonal blocks e^{L_(i-1) - L_j} is
    the product of the decays between j and i.  The state crosses chunks in
    order, each chunk from its predecessor."""
    b, t, h, n = r.shape
    c, sb = CHUNK, SUB
    nsub = c // sb
    pad = -t % c
    # [B, H, T, N] in fp32, padded to whole chunks (decay 1 past the end)
    rf, kf, vf = (torch.nn.functional.pad(
        a.float().transpose(1, 2), (0, 0, 0, pad)) for a in (r, k, v))
    wf = torch.nn.functional.pad(w.float().transpose(1, 2), (0, 0, 0, pad),
                                 value=1.0)
    lam = torch.clamp(torch.log(wf), min=LOG_FLOOR)
    uf = u.float()[None, :, None, :]                          # [1, H, 1, N]
    s = torch.zeros(b, h, n, n, dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float().clone()
    ys = torch.empty(b, h, t + pad, n, dtype=torch.float32, device=r.device)
    lower = torch.tril(torch.ones(sb, sb, dtype=torch.bool, device=r.device),
                       -1)
    idx = torch.arange(sb, device=r.device)
    for c0 in range(0, t + pad, c):
        rc, kc, vc, lc, wc = (a[:, :, c0:c0 + c].reshape(b, h, nsub, sb, n)
                              for a in (rf, kf, vf, lam, wf))
        incl = torch.cumsum(lc, -2)                 # sum to a step, in its SB
        e = torch.cat([torch.zeros_like(incl[..., :1, :]), incl[..., :-1, :]],
                      -2)                           # E: before a step
        q = _cumsum_rev_excl(lc)                    # Q: after a step
        g = incl[..., -1, :]                        # G: [B, H, nsub, N]
        r0 = rc * torch.exp(e)                      # r e^E
        k_hat = kc * torch.exp(q)                   # k e^Q
        before = torch.zeros_like(g)                # G_0 + ... + G_(I-1)
        after = torch.zeros_like(g)                 # G_(I+1) + ... + G_last
        for m in range(1, nsub):
            before[:, :, m] = before[:, :, m - 1] + g[:, :, m - 1]
            after[:, :, nsub - 1 - m] = (after[:, :, nsub - m]
                                         + g[:, :, nsub - m])
        a_mat = torch.zeros(b, h, c, c, dtype=torch.float32, device=r.device)
        for i_blk in range(nsub):
            rows = slice(i_blk * sb, (i_blk + 1) * sb)
            for j_blk in range(i_blk):
                mid = torch.zeros_like(g[:, :, 0])
                for m in range(j_blk + 1, i_blk):
                    mid = mid + g[:, :, m]
                a_mat[:, :, rows, j_blk * sb:(j_blk + 1) * sb] = (
                    (r0[:, :, i_blk] * torch.exp(mid)[:, :, None])
                    @ k_hat[:, :, j_blk].transpose(-1, -2))
            # diagonal block: fac[i, j] = w_(j+1) ... w_(i-1) for j < i (a
            # product needs no floor), the bonus u on i == j
            wb = wc[:, :, i_blk]                               # [B, H, sb, N]
            fac = torch.zeros(b, h, sb, sb, n, dtype=torch.float32,
                              device=r.device)
            for i in range(1, sb):
                f = torch.ones_like(wb[:, :, 0])
                for j in range(i - 1, -1, -1):
                    fac[:, :, i, j] = f
                    f = f * wb[:, :, j]
            diag = torch.einsum("bhin,bhjn,bhijn->bhij", rc[:, :, i_blk],
                                kc[:, :, i_blk], fac)
            diag = torch.where(lower, diag, 0.0)
            diag[:, :, idx, idx] = (rc[:, :, i_blk] * uf
                                    * kc[:, :, i_blk]).sum(-1)
            a_mat[:, :, rows, rows] = diag
        r_hat = (r0 * torch.exp(before)[:, :, :, None]).reshape(b, h, c, n)
        k_bar = (k_hat * torch.exp(after)[:, :, :, None]).reshape(b, h, c, n)
        decay = torch.exp(before[:, :, -1] + g[:, :, -1])       # [B, H, N]
        vv = vc.reshape(b, h, c, n)
        ys[:, :, c0:c0 + c] = a_mat @ vv + r_hat @ s
        s = decay[..., None] * s + k_bar.transpose(-1, -2) @ vv
    return ys[:, :, :t].transpose(1, 2).to(r.dtype), s
