"""RWKV-6 (Finch) time mix and channel mix: the RWKV half of
``repro/models/ssm.py`` (Mamba waits for the hybrid slice).

RWKV-6 recurrence (per head, k-dim N, v-dim N):
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
with w_t = exp(-exp(w0 + lora(x))) data-dependent decay.

Prefill with a state and ``cfg.use_flash`` runs the WKV-6 kernel
(``kernels/wkv6``), as the reference routes it; otherwise a chunked scan
carries the state from chunk to chunk and composes each chunk's steps with
an associative scan, in fp32.  Decode is the plain one-step recurrence.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.wkv6 import wkv6
from .layers import group_norm, init_group_norm, init_linear, linear

__all__ = ["init_rwkv_time_mix", "rwkv_time_mix", "rwkv_time_mix_decode",
           "init_rwkv_channel_mix", "rwkv_channel_mix", "RWKVState"]


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor   # [B, D] previous token (time-mix)
    cm_shift: torch.Tensor   # [B, D] previous token (channel-mix)
    s: torch.Tensor          # [B, H, N, N] wkv state


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: x[t] → x[t-1]; first position uses ``prev`` (or 0)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


# ===========================================================================
# RWKV-6 time mix
# ===========================================================================

def _normal(gen: torch.Generator, shape, scale: float, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def init_rwkv_time_mix(gen: torch.Generator, cfg: ModelConfig,
                       dtype=torch.bfloat16) -> dict:
    d = cfg.d_model
    n = cfg.rwkv_head_size
    h = d // n
    r = cfg.rwkv_lora_rank
    dev = gen.device
    return {
        "mu_x": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "maa": torch.full((5, d), 0.5, dtype=dtype, device=dev),  # w,k,v,r,g
        "tm_w1": _normal(gen, (d, 5 * r), 1e-2, dtype),
        "tm_w2": _normal(gen, (5, r, d), 1e-2, dtype),
        "w0": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "td_w1": _normal(gen, (d, r), 1e-2, dtype),
        "td_w2": _normal(gen, (r, d), 1e-2, dtype),
        "u": _normal(gen, (h, n), 0.1, torch.float32),
        "wr": init_linear(gen, d, d, dtype=dtype),
        "wk": init_linear(gen, d, d, dtype=dtype),
        "wv": init_linear(gen, d, d, dtype=dtype),
        "wg": init_linear(gen, d, d, dtype=dtype),
        "wo": init_linear(gen, d, d, dtype=dtype),
        "ln_x": init_group_norm(h, d, dtype, dev),
    }


def _rwkv_project(p: dict, x: torch.Tensor, shifted: torch.Tensor,
                  cfg: ModelConfig):
    """Data-dependent token-shift interpolation (ddlerp) + projections."""
    b, t, d = x.shape
    n = cfg.rwkv_head_size
    h = d // n
    xx = shifted - x
    xxx = x + xx * p["mu_x"]
    k5 = torch.tanh(xxx @ p["tm_w1"]).reshape(b, t, 5, -1)
    offs = torch.einsum("btfr,frd->btfd", k5, p["tm_w2"])
    mixed = x[:, :, None] + xx[:, :, None] * (p["maa"] + offs)  # [B,T,5,D]
    xw, xk, xv, xr, xg = mixed.unbind(2)
    # decay in fp32: w = exp(-exp(w0 + lora)), in (0, 1)
    dlt = torch.tanh(xw @ p["td_w1"]) @ p["td_w2"]
    w = torch.exp(-torch.exp(p["w0"] + dlt.float()))             # [B,T,D]
    r = linear(p["wr"], xr).reshape(b, t, h, n)
    k = linear(p["wk"], xk).reshape(b, t, h, n)
    v = linear(p["wv"], xv).reshape(b, t, h, n)
    g = F.silu(linear(p["wg"], xg))
    return r, k, v, g, w.reshape(b, t, h, n)


def _wkv_chunk(r, k, v, w, u, s0):
    """One chunk of the WKV recurrence via associative scan.

    r,k,v,w: [B, c, H, N] (w = decay in (0,1), fp32); u: [H, N];
    s0: [B, H, N, N].  Returns (y [B, c, H, N] fp32, s_end).  The inclusive
    scan of (w, k ⊗ v) under (w1, s1) ∘ (w2, s2) = (w1 w2, w2 s1 + s2) is
    taken in log2(c) doubling steps, in fp32."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    w_cum = wf
    s_inc = torch.einsum("bchk,bchv->bchkv", kf, vf)     # k ⊗ v per step
    c = rf.shape[1]
    off = 1
    while off < c:
        s_inc = torch.cat([s_inc[:, :off], w_cum[:, off:, ..., None]
                           * s_inc[:, :-off] + s_inc[:, off:]], dim=1)
        w_cum = torch.cat([w_cum[:, :off], w_cum[:, :-off] * w_cum[:, off:]],
                          dim=1)
        off *= 2
    # state BEFORE step t: decayed s0 plus inclusive prefix up to t-1
    w_excl = torch.cat([torch.ones_like(w_cum[:, :1]), w_cum[:, :-1]], dim=1)
    s_prev = (w_excl[..., None] * s0[:, None]
              + torch.cat([torch.zeros_like(s_inc[:, :1]), s_inc[:, :-1]],
                          dim=1))
    y = torch.einsum("bchk,bchkv->bchv", rf, s_prev)
    y = y + (rf * u.float() * kf).sum(-1, keepdim=True) * vf
    s_end = w_cum[:, -1][..., None] * s0 + s_inc[:, -1]
    return y, s_end


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[tuple] = None):
    """Train/prefill path.  state=(shift_prev [B,D], s0 [B,H,N,N]) or None.
    Returns (y [B,T,D], (last_x, s_end))."""
    b, t, d = x.shape
    n = cfg.rwkv_head_size
    h = d // n
    prev_x = state[0] if state is not None else None
    s0 = state[1] if state is not None else torch.zeros(
        b, h, n, n, dtype=torch.float32, device=x.device)
    r, k, v, g, w = _rwkv_project(p, x, _shift(x, prev_x), cfg)

    if cfg.use_flash and state is not None:
        # The WKV-6 kernel (forward only): the prefill/serving path, which
        # always passes an explicit state, as in the reference.  The
        # reference pads T to a chunk multiple with w = 1 and zero r, k, v;
        # those steps leave the state bit-identical (1·S + 0 = S) and their
        # y is dropped, so the kernel, which walks any T, takes no pad.
        y, s_end = wkv6(r, k, v, w, p["u"], s0)
        y = y.reshape(b, t, d)
    else:
        c = min(cfg.ssm_chunk, t)
        pad = (-t) % c
        if pad:
            # pad with decay-1 / zero-input steps (no-ops for the recurrence)
            r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
            w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        s_end, ys = s0, []
        for i in range(0, t + pad, c):
            yc, s_end = _wkv_chunk(r[:, i:i + c], k[:, i:i + c],
                                   v[:, i:i + c], w[:, i:i + c], p["u"],
                                   s_end)
            ys.append(yc)
        y = torch.cat(ys, dim=1)[:, :t].reshape(b, t, d)
    y = group_norm(p["ln_x"], y.to(x.dtype), h, cfg.norm_eps) * g
    y = linear(p["wo"], y)
    return y, (x[:, -1], s_end)


def rwkv_time_mix_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                         state: tuple):
    """One-token decode.  x: [B, 1, D]; state=(shift_prev, s).  Returns
    (y, (last_x, s_next)); the state passed in is not modified."""
    b, _, d = x.shape
    n = cfg.rwkv_head_size
    h = d // n
    prev_x, s = state
    r, k, v, g, w = _rwkv_project(p, x, prev_x[:, None], cfg)
    rf, kf, vf, wf = (a[:, 0].float() for a in (r, k, v, w))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum("bhk,bhkv->bhv", rf, s + p["u"][None, :, :, None] * kv)
    s = wf[..., None] * s + kv
    y = y.reshape(b, 1, d)
    y = group_norm(p["ln_x"], y.to(x.dtype), h, cfg.norm_eps) * g
    return linear(p["wo"], y), (x[:, -1], s)


# ===========================================================================
# RWKV-6 channel mix
# ===========================================================================

def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig,
                          dtype=torch.bfloat16) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {"mu_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
            "mu_r": torch.full((d,), 0.5, dtype=dtype, device=dev),
            "wk": init_linear(gen, d, f, dtype=dtype),
            "wv": init_linear(gen, f, d, dtype=dtype),
            "wr": init_linear(gen, d, d, dtype=dtype)}


def rwkv_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     prev_x: Optional[torch.Tensor] = None):
    xx = _shift(x, prev_x) - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    kk = torch.square(F.relu(linear(p["wk"], xk)))
    return torch.sigmoid(linear(p["wr"], xr)) * linear(p["wv"], kk), x[:, -1]
