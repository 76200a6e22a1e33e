"""State-space blocks: RWKV-6 (Finch) time mix and channel mix, and Mamba
(S6), the PyTorch counterpart of ``repro/models/ssm.py``.

RWKV-6 recurrence (per head, k-dim N, v-dim N):
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
with w_t = exp(-exp(w0 + lora(x))) data-dependent decay.

Prefill with a state and ``cfg.use_flash`` runs the WKV-6 kernel
(``kernels/wkv6``), as the reference routes it; otherwise a chunked scan
carries the state from chunk to chunk and composes each chunk's steps with
an associative scan, in fp32.  Decode is the plain one-step recurrence.

Mamba (S6):  h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t ;  y_t = C_tᵀ h_t + D x_t
The reference has no Mamba kernel, and neither has the port: prefill runs
the reference's chunked scan in plain PyTorch (fp32 Δ, B, C, decays and
state), decode the one-step recurrence.  With ``cfg.mamba_inner_norm`` (a
port-only field; Jamba's published mixer) x_proj's three parts, the
dt_rank-wide Δ input and the d_state-wide B and C, each go through an
RMSNorm with its own weight (``dt_norm``, ``b_norm``, ``c_norm``; eps
``norm_eps``) before dt_proj and the scan, in prefill and decode alike.
The scan's chunk is chosen from the length of each call (``_scan_chunk``):
the plain scan issues about 2 (c - 1) + T / c launches for T steps in
chunks of c, fewest near c = sqrt(T / 2), and ``cfg.ssm_chunk`` is the
largest chunk it takes; the chunk moves only fp32 rounding.
Spans (``trace``): ``mamba.prefill`` and ``mamba.decode`` around one
layer's work from in_proj to out_proj (attr ``tokens``), ``mamba.scan``
around the chunked scan inside ``mamba.prefill``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import trace
from ..configs.base import ModelConfig
from ..kernels.wkv6 import wkv6
from ..sharding.dtensor import flatten, shard_map, unflatten
from .layers import (group_norm, init_group_norm, init_linear,
                     init_rms_norm, linear, rms_norm)

__all__ = ["init_rwkv_time_mix", "rwkv_time_mix", "rwkv_time_mix_decode",
           "init_rwkv_channel_mix", "rwkv_channel_mix", "RWKVState",
           "init_mamba", "mamba_fwd", "mamba_decode", "MambaState"]


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor   # [B, D] previous token (time-mix)
    cm_shift: torch.Tensor   # [B, D] previous token (channel-mix)
    s: torch.Tensor          # [B, H, N, N] wkv state


class MambaState(NamedTuple):
    conv: torch.Tensor       # [B, d_conv-1, d_inner] (model dtype)
    h: torch.Tensor          # [B, d_inner, d_state] (fp32)


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
    k5 = unflatten(torch.tanh(xxx @ p["tm_w1"]), 2, (5, -1))
    offs = torch.einsum("btfr,frd->btfd", k5, p["tm_w2"])
    mixed = x[:, :, None] + xx[:, :, None] * (p["maa"] + offs)  # [B,T,5,D]
    xw, xk, xv, xr, xg = mixed.unbind(2)
    # decay in fp32: w = exp(-exp(w0 + lora)), in (0, 1)
    dlt = torch.tanh(xw @ p["td_w1"]) @ p["td_w2"]
    w = torch.exp(-torch.exp(p["w0"] + dlt.float()))             # [B,T,D]
    r = unflatten(linear(p["wr"], xr), 2, (h, n))
    k = unflatten(linear(p["wk"], xk), 2, (h, n))
    v = unflatten(linear(p["wv"], xv), 2, (h, n))
    g = F.silu(linear(p["wg"], xg))
    return r, k, v, g, unflatten(w, 2, (h, n))


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


def _wkv_chunked(r, k, v, w, u, s0, chunk: int):
    """The WKV recurrence over [B, T, H, N] in chunks of ``chunk`` steps:
    (y [B, T, H, N] fp32, s_end)."""
    t = r.shape[1]
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        # pad with decay-1 / zero-input steps (no-ops for the recurrence)
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    s_end, ys = s0, []
    for i in range(0, t + pad, c):
        yc, s_end = _wkv_chunk(r[:, i:i + c], k[:, i:i + c], v[:, i:i + c],
                               w[:, i:i + c], u, s_end)
        ys.append(yc)
    return torch.cat(ys, dim=1)[:, :t], s_end


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
        # under a mesh, on each rank's rows and heads (``shard_map``)
        bh = (0, 2)
        y, s_end = shard_map(
            lambda r, k, v, w, u, s0: _wkv_chunked(r, k, v, w, u, s0,
                                                   cfg.ssm_chunk),
            (r, k, v, w, p["u"], s0), (bh, bh, bh, bh, (None, 0), (0, 1)),
            (bh, (0, 1)), h)
        y = flatten(y, 2)
    y = group_norm(p["ln_x"], y.to(x.dtype), h, cfg.norm_eps) * g
    y = linear(p["wo"], y)
    return y, (x[:, -1], s_end)


def _wkv_step(r, k, v, w, u, s):
    """One decode step of the recurrence: r, k, v, w [B, 1, H, N], s [B, H,
    N, N] -> (y [B, 1, H, N] fp32, the next state)."""
    rf, kf, vf, wf = (a[:, 0].float() for a in (r, k, v, w))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum("bhk,bhkv->bhv", rf, s + u[None, :, :, None] * kv)
    return y[:, None], wf[..., None] * s + kv


def rwkv_time_mix_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                         state: tuple):
    """One-token decode.  x: [B, 1, D]; state=(shift_prev, s).  Returns
    (y, (last_x, s_next)); the state passed in is not modified."""
    h = x.shape[-1] // cfg.rwkv_head_size
    prev_x, s = state
    r, k, v, g, w = _rwkv_project(p, x, prev_x[:, None], cfg)
    bh = (0, 2)
    y, s = shard_map(_wkv_step, (r, k, v, w, p["u"], s),
                     (bh, bh, bh, bh, (None, 0), (0, 1)), (bh, (0, 1)), h)
    y = flatten(y, 2)
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


# ===========================================================================
# Mamba (S6)
# ===========================================================================

def _inner_norm(cfg) -> bool:
    """``cfg.mamba_inner_norm``; False for a config of the JAX package (the
    parity tests pass one), which has no port-only field."""
    return getattr(cfg, "mamba_inner_norm", False)


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.bfloat16) -> dict:
    d = cfg.d_model
    di = cfg.mamba_d_inner
    ds = cfg.mamba_d_state
    dtr = cfg.resolved_dt_rank
    dev = gen.device
    a = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=dev)[None].repeat(di, 1)
    p = {
        "in_proj": init_linear(gen, d, 2 * di, dtype=dtype),
        "conv_w": _normal(gen, (cfg.mamba_d_conv, di), 1 / cfg.mamba_d_conv,
                          dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": init_linear(gen, di, dtr + 2 * ds, dtype=dtype),
        "dt_proj": init_linear(gen, dtr, di, bias=True, dtype=dtype),
        "a_log": torch.log(a),                          # fp32
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": init_linear(gen, di, d, dtype=dtype),
    }
    if _inner_norm(cfg):
        p.update(dt_norm=init_rms_norm(dtr, dtype, dev),
                 b_norm=init_rms_norm(ds, dtype, dev),
                 c_norm=init_rms_norm(ds, dtype, dev))
    return p


def _mamba_scan_chunked(a_t: torch.Tensor, b_t: torch.Tensor,
                        h0: torch.Tensor, chunk: int):
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


def _scan_chunk(t: int, cap: int) -> int:
    """The chunk of ``_mamba_scan_chunked`` for ``t`` steps: of 1..``cap``
    the one that issues the fewest launches, 2 (c - 1) + ceil(t / c) (the
    inner steps' two ops each, the carry's one a chunk), the largest of
    equals.  A 512-token prefill chunk takes 16 (66 launches against 138
    at 64), a 3072-token prompt 41."""
    return min(range(1, max(1, min(cap, t)) + 1),
               key=lambda c: (2 * (c - 1) + -(-t // c), -c))


def _mamba_ssm_inputs(p: dict, xc: torch.Tensor, cfg: ModelConfig):
    """Δ [..., di], the decays exp(Δ A) [..., di, ds], the inputs
    Δ x B [..., di, ds] and C [..., ds], all fp32, from the conv output."""
    dtr, ds = cfg.resolved_dt_rank, cfg.mamba_d_state
    proj = linear(p["x_proj"], xc)
    dt, bmat, cmat = (proj[..., :dtr], proj[..., dtr:dtr + ds],
                      proj[..., dtr + ds:])
    if _inner_norm(cfg):
        eps = cfg.norm_eps
        dt = rms_norm(p["dt_norm"], dt, eps)
        bmat = rms_norm(p["b_norm"], bmat, eps)
        cmat = rms_norm(p["c_norm"], cmat, eps)
    dt = F.softplus(linear(p["dt_proj"], dt).float())
    bmat = bmat.float()
    cmat = cmat.float()
    a = -torch.exp(p["a_log"])                                 # [di, ds]
    decay = torch.exp(dt[..., None] * a)
    inp = (dt * xc.float())[..., None] * bmat[..., None, :]
    return decay, inp, cmat


#: the Mamba layer's weights between its two projections, flat for
#: ``shard_map`` (small beside in_proj and out_proj, so replicated there)
_MIX_LEAVES = (("conv_w",), ("conv_b",), ("x_proj", "w"), ("dt_proj", "w"),
               ("dt_proj", "b"), ("a_log",), ("d_skip",))
#: and, with ``mamba_inner_norm``, the three inner norms' scales
_NORM_LEAVES = (("dt_norm", "scale"), ("b_norm", "scale"),
                ("c_norm", "scale"))


def _mix_weights(p: dict, cfg: ModelConfig) -> list:
    leaves = _MIX_LEAVES + (_NORM_LEAVES if _inner_norm(cfg) else ())
    return [p[k[0]] if len(k) == 1 else p[k[0]][k[1]] for k in leaves]


def _mix_params(ws) -> dict:
    p = {}
    for k, w in zip(_MIX_LEAVES + _NORM_LEAVES, ws):
        if len(k) == 1:
            p[k[0]] = w
        else:
            p.setdefault(k[0], {})[k[1]] = w
    return p


def _by_rows(fn, tensors, weights, n_out: int):
    """``fn`` on each rank's batch rows (the weights whole): under a mesh,
    the conv, the selective scan and their projections between in_proj
    and out_proj see every channel, which x_proj mixes."""
    rows = (0, None)
    return shard_map(fn, (*tensors, *weights),
                     (rows,) * len(tensors) + ((None, None),) * len(weights),
                     (rows,) * n_out, 1)


def mamba_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[MambaState] = None):
    """Train/prefill.  x: [B, T, D] -> (y [B, T, D], MambaState)."""
    b, t, _ = x.shape
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    with trace.span("mamba.prefill", tokens=b * t):
        u = linear(p["in_proj"], x)
        prev = state.conv if state is not None else torch.zeros(
            b, dc - 1, di, dtype=u.dtype, device=x.device)
        h0 = state.h if state is not None else torch.zeros(
            b, di, ds, dtype=torch.float32, device=x.device)

        def mix(u, prev, h0, *ws):
            q = _mix_params(ws)
            xi, z = u.chunk(2, dim=-1)
            # depthwise causal conv1d over time
            xpad = torch.cat([prev, xi], dim=1)
            conv_state = xpad[:, -(dc - 1):] if dc > 1 else prev
            xc = sum(xpad[:, i:i + t] * q["conv_w"][i] for i in range(dc))
            xc = F.silu(xc + q["conv_b"])
            decay, inp, cmat = _mamba_ssm_inputs(q, xc, cfg)
            with trace.span("mamba.scan"):
                hs, h_end = _mamba_scan_chunked(
                    decay, inp, h0, _scan_chunk(t, cfg.ssm_chunk))
            y = torch.einsum("btds,bts->btd", hs, cmat)
            y = (y + xc.float() * q["d_skip"]).to(x.dtype)
            return y * F.silu(z), conv_state, h_end

        y, conv_state, h_end = _by_rows(mix, (u, prev, h0),
                                        _mix_weights(p, cfg), 3)
        return linear(p["out_proj"], y), MambaState(conv=conv_state, h=h_end)


def mamba_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: MambaState):
    """One-token decode; x: [B, 1, D].  Returns (y, the next MambaState);
    the state passed in is not modified."""
    def mix(u, conv, h, *ws):
        q = _mix_params(ws)
        xi, z = u.chunk(2, dim=-1)                            # [B, 1, di]
        xfull = torch.cat([conv, xi], dim=1)                  # [B, dc, di]
        xc = F.silu(torch.einsum("bcd,cd->bd", xfull, q["conv_w"])
                    + q["conv_b"])                            # [B, di]
        decay, inp, cmat = _mamba_ssm_inputs(q, xc, cfg)
        h = decay * h + inp
        y = torch.einsum("bds,bs->bd", h, cmat)
        y = (y + xc.float() * q["d_skip"]).to(x.dtype)
        return y[:, None] * F.silu(z), xfull[:, 1:], h

    with trace.span("mamba.decode", tokens=x.shape[0]):
        y, conv, h = _by_rows(mix, (linear(p["in_proj"], x), state.conv,
                                    state.h), _mix_weights(p, cfg), 3)
        return linear(p["out_proj"], y), MambaState(conv=conv, h=h)
