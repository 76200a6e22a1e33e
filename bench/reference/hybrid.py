"""The plain reference of the hybrid (Jamba): attention, Mamba-1 and sparse
experts in fp32 PyTorch, written from the published architecture
(transformers 4.57.6, ``models/jamba/modeling_jamba.py``: ``JambaConfig``,
``JambaMambaMixer``, ``JambaSparseMoeBlock``) and not from the program.

A layer i is x += mixer(RMSNorm(x)), then x += ffn(RMSNorm(x)).  The mixer
is grouped-query attention, causal and with no positional encoding, where
i % period == attn_offset, else a Mamba-1 mixer:

* x, z = split(in_proj(u)), each of width d_inner;
* xc = silu(causal depthwise conv1d of x with its taps and bias);
* dt, B, C = split(x_proj(xc)) into dt_rank, d_state and d_state, then
  dt = RMSNorm(dt), B = RMSNorm(B), C = RMSNorm(C), each with its weight;
* Δ = softplus(dt_proj(dt) + bias), A = -exp(A_log);
* h_t = exp(Δ_t A) ⊙ h_{t-1} + (Δ_t ⊙ xc_t) ⊗ B_t,
  y_t = h_t · C_t + D ⊙ xc_t, from h = 0 at the first position;
* out_proj(y ⊙ silu(z)).

The ffn is a sparse MoE layer where i % expert_period == expert_offset: a
linear router, a softmax over every expert, the top k kept with their
probabilities as they are (not renormalised), each token computed by its k
experts, nothing dropped; else a SwiGLU MLP.  Then a final RMSNorm and an
untied output head.  RMSNorm takes its statistics and its scale in fp32.

The recurrence is a plain loop over positions, all the sequences of a
call at once (padded at their ends, which causality keeps from every
earlier position).  It runs layer by layer over a list of sequences, so
that one layer's weights at a time are widened to fp32 beside the served
weights (one expert at a time), with attention in blocks of query rows.
TF32 is switched off: every product is a true fp32 one.

Departures from the published code: none in the mathematics.  transformers
runs the RMSNorms' output in the model's dtype and the scan in its own
CUDA kernel or a chunked loop; here everything is fp32.

``quant="fp8"`` is the comparison's control: every linear layer's input
and weight (the projections of attention and Mamba, the experts, the MLPs
and the output head) rounded to float8 e4m3 (the activation per row, the
weight per output column) before an fp32 product, as in
``bench/reference/model.py``; the router, the conv, the scan, attention's
own products and the norms stay fp32.

Imports torch only.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from .model import Q_BLOCK, ROW_BLOCK, _ffn_dense, _mm, _rms

__all__ = ["forward_logits"]


def _attention(x, lw, s, quant):
    """Causal grouped-query attention with no positional encoding."""
    n = x.shape[0]
    h, hkv, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    q = _mm(x, lw["wq"], quant).view(n, hkv, h // hkv, hd)
    k = _mm(x, lw["wk"], quant).view(n, hkv, hd)
    v = _mm(x, lw["wv"], quant).view(n, hkv, hd)
    out = torch.empty(n, hkv, h // hkv, hd, dtype=torch.float32,
                      device=x.device)
    for q0 in range(0, n, Q_BLOCK):
        q1 = min(n, q0 + Q_BLOCK)
        i = torch.arange(q0, q1, device=x.device)[:, None]
        j = torch.arange(0, q1, device=x.device)[None, :]
        sc = torch.einsum("qkgd,tkd->kgqt", q[q0:q1], k[:q1]) \
            / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(j > i, float("-inf")), dim=-1)
        out[q0:q1] = torch.einsum("kgqt,tkd->qkgd", p, v[:q1])
    return _mm(out.view(n, h * hd), lw["wo"], quant)


def _mamba(us: List[torch.Tensor], lw, s, quant) -> List[torch.Tensor]:
    """The Mamba-1 mixer over each sequence of ``us`` ([n_i, d_model],
    normed inputs)."""
    di, dc, dtr, ds = s["d_inner"], s["d_conv"], s["dt_rank"], s["d_state"]
    eps = s["norm_eps"]
    lens = [u.shape[0] for u in us]
    t_max = max(lens)
    xs, zs = [], []
    for u in us:
        xz = _mm(u, lw["in_proj"], quant)
        xs.append(F.pad(xz[:, :di], (0, 0, 0, t_max - u.shape[0])))
        zs.append(xz[:, di:])
    x = torch.stack(xs)                                   # [S, T, di]
    # causal depthwise conv: tap j sees position t - (d_conv - 1) + j
    xp = F.pad(x, (0, 0, dc - 1, 0))
    xc = F.silu(sum(xp[:, j:j + t_max] * lw["conv_w"][j] for j in range(dc))
                + lw["conv_b"])
    proj = _mm(xc, lw["x_proj"], quant)
    dt = _rms(proj[..., :dtr], lw["dt_norm"], eps)
    b = _rms(proj[..., dtr:dtr + ds], lw["b_norm"], eps)
    c = _rms(proj[..., dtr + ds:], lw["c_norm"], eps)
    delta = F.softplus(_mm(dt, lw["dt_proj"], quant) + lw["dt_bias"])
    a = -torch.exp(lw["a_log"])                           # [di, ds]
    h = torch.zeros(x.shape[0], di, ds, dtype=torch.float32,
                    device=x.device)
    y = torch.empty_like(xc)
    for t in range(t_max):
        h = torch.exp(delta[:, t, :, None] * a) * h \
            + (delta[:, t] * xc[:, t])[:, :, None] * b[:, t, None, :]
        y[:, t] = (h * c[:, t, None, :]).sum(-1)
    y = y + lw["d_skip"] * xc
    return [_mm(y[i, :n] * F.silu(z), lw["out_proj"], quant)
            for i, (n, z) in enumerate(zip(lens, zs))]


def _ffn_moe(hx, lw, experts, s, quant):
    """Every token through its top-k experts, weighted by their softmax
    probabilities over all the experts (not renormalised);
    ``experts(e)`` widens expert e's (gate, up, down) to fp32."""
    probs = torch.softmax(hx @ lw["router"], dim=-1)
    top, idx = torch.topk(probs, s["top_k"], dim=-1)
    y = torch.zeros_like(hx)
    for e in range(s["num_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        wg, wu, wd = experts(e)
        for r0 in range(0, rows.numel(), ROW_BLOCK):
            r = rows[r0:r0 + ROW_BLOCK]
            z = hx[r]
            act = F.silu(_mm(z, wg, quant)) * _mm(z, wu, quant)
            y.index_add_(0, r, _mm(act, wd, quant)
                         * top[r, slot[r0:r0 + ROW_BLOCK], None])
    return y


def _widen(tree, sb: int) -> dict:
    """Superblock ``sb``'s slice of a layer's leaves, in fp32 (the experts
    are left as they are: widened one at a time)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _widen(v, sb)
        elif k in ("w_gate", "w_up", "w_down"):
            out[k] = v
        else:
            out[k] = v[sb].float()
    return out


def forward_logits(weights: dict, sizes: dict,
                   seqs: Sequence[torch.Tensor], first_rows: Sequence[int],
                   quant: Optional[str] = None) -> List[torch.Tensor]:
    """Logits in fp32 of each sequence's rows ``first_rows[i]`` .. end:
    ``[n_i - first_rows[i], vocab]``.  ``weights``: the served tree
    (``superblocks/layers/<i>/...`` leaves ``[n_sb, ...]``, any float
    type); ``seqs``: token ids on the weights' device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = sizes
    eps = s["norm_eps"]
    period = s["period"]
    layers = weights["superblocks"]["layers"]
    table = weights["embed"]["table"]
    with torch.no_grad():
        xs = [table[t.long()].float() for t in seqs]
        for li in range(s["num_layers"]):
            sb, i = divmod(li, period)
            lw = _widen(layers[i], sb)
            hs = [_rms(x, lw["ln1"]["scale"], eps) for x in xs]
            if i % period == s["attn_offset"]:
                att = lw["attn"]
                att = {k: att[k]["w"] for k in ("wq", "wk", "wv", "wo")}
                outs = [_attention(h, att, s, quant) for h in hs]
            else:
                m = lw["mamba"]
                mw = {k: m[k] for k in ("conv_w", "conv_b", "a_log",
                                        "d_skip")}
                mw.update({k: m[k]["w"] for k in ("in_proj", "x_proj",
                                                  "dt_proj", "out_proj")})
                mw.update(dt_bias=m["dt_proj"]["b"],
                          dt_norm=m["dt_norm"]["scale"],
                          b_norm=m["b_norm"]["scale"],
                          c_norm=m["c_norm"]["scale"])
                outs = _mamba(hs, mw, s, quant)
            del hs
            lens = [x.shape[0] for x in xs]
            x = torch.cat([a + o for a, o in zip(xs, outs)])
            del xs, outs
            hx = _rms(x, lw["ln2"]["scale"], eps)
            if i % s["expert_period"] == s["expert_offset"]:
                m = lw["moe"]
                x += _ffn_moe(hx, {"router": m["router"]["w"]}, lambda e: (
                    m["w_gate"][sb, e].float(), m["w_up"][sb, e].float(),
                    m["w_down"][sb, e].float()), s, quant)
            else:
                x += _ffn_dense(hx, {k: lw["mlp"][k]["w"]
                                     for k in ("gate", "up", "down")},
                                quant)
            del hx, lw
            xs = list(torch.split(x, lens))
        ln_f = weights["ln_f"]["scale"].float()
        head = weights["lm_head"]["w"].float()
        return [_mm(_rms(x[r:], ln_f, eps), head, quant)
                for x, r in zip(xs, first_rows)]
