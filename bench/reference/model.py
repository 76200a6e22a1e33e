"""The plain reference: a decoder-only transformer in fp32 PyTorch, written
from the published architecture and not from the program.

Covered: token embedding; RMSNorm with its weight (statistics and scale in
fp32); grouped-query attention with rotary embeddings of the half-split
form (Mistral's and Mixtral's ``rotate_half``; angles in fp64), causal,
with a sliding window where the configuration has one; a SwiGLU MLP, or a
sparse MoE layer: a linear router, softmax over the experts, the top k
kept and their weights renormalised to sum to 1 (what a softmax over the
top k logits gives), every token computed by its k experts and nothing
dropped; a final RMSNorm and an untied output head.

It runs layer by layer over a list of sequences, so that one layer's
weights at a time are widened to fp32 beside the served weights, with
attention in blocks of query rows and the feed-forward in blocks of rows.
TF32 is switched off: every product is a true fp32 one.

``quant="fp8"`` is the comparison's control: every linear layer's input
and weight rounded to float8 e4m3 (the activation per row, the weight per
output column, each scaled to e4m3's largest value 448) before an fp32
product; the router, attention's own products and the norms stay fp32.

Imports torch only.  Frozen copy: written against the port at commit
55bfaa9; later changes to the program do not change it.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["forward_logits"]

ROW_BLOCK = 4096
Q_BLOCK = 512
FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]
        ) -> torch.Tensor:
    if quant == "fp8":
        return _fp8(a, -1) @ _fp8(w, 0)
    if quant is not None:
        raise ValueError(f"unknown quantisation {quant!r}")
    return a @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [n, heads, hd] at positions 0..n-1."""
    n, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(x, lw, s, quant):
    n = x.shape[0]
    h, hkv, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    g = h // hkv
    hx = _rms(x, lw["ln1"], s["norm_eps"])
    q = _rope(_mm(hx, lw["wq"], quant).view(n, h, hd), s["rope_theta"])
    k = _rope(_mm(hx, lw["wk"], quant).view(n, hkv, hd), s["rope_theta"])
    v = _mm(hx, lw["wv"], quant).view(n, hkv, hd)
    q = q.view(n, hkv, g, hd)
    out = torch.empty(n, hkv, g, hd, dtype=torch.float32, device=x.device)
    window = s.get("sliding_window")
    for q0 in range(0, n, Q_BLOCK):
        q1 = min(n, q0 + Q_BLOCK)
        lo = 0 if window is None else max(0, q0 - window + 1)
        i = torch.arange(q0, q1, device=x.device)[:, None]
        j = torch.arange(lo, q1, device=x.device)[None, :]
        keep = j <= i
        if window is not None:
            keep &= i - j < window
        sc = torch.einsum("qkgd,tkd->kgqt", q[q0:q1], k[lo:q1]) \
            / math.sqrt(hd)
        sc = sc.masked_fill(~keep, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out[q0:q1] = torch.einsum("kgqt,tkd->qkgd", p, v[lo:q1])
    return x + _mm(out.view(n, h * hd), lw["wo"], quant)


def _ffn_dense(hx, lw, quant):
    y = torch.empty_like(hx)
    for r0 in range(0, hx.shape[0], ROW_BLOCK):
        z = hx[r0:r0 + ROW_BLOCK]
        a = F.silu(_mm(z, lw["gate"], quant)) * _mm(z, lw["up"], quant)
        y[r0:r0 + ROW_BLOCK] = _mm(a, lw["down"], quant)
    return y


def _ffn_moe(hx, lw, experts, s, quant):
    """Every token through its top-k experts; ``experts(e)`` widens expert
    e's (gate, up, down) to fp32."""
    probs = torch.softmax(hx @ lw["router"], dim=-1)
    top, idx = torch.topk(probs, s["top_k"], dim=-1)
    top = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(hx)
    for e in range(s["num_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        wg, wu, wd = experts(e)
        for r0 in range(0, rows.numel(), ROW_BLOCK):
            r = rows[r0:r0 + ROW_BLOCK]
            z = hx[r]
            a = F.silu(_mm(z, wg, quant)) * _mm(z, wu, quant)
            y.index_add_(0, r, _mm(a, wd, quant)
                         * top[r, slot[r0:r0 + ROW_BLOCK], None])
    return y


def forward_logits(weights: dict, sizes: dict,
                   seqs: Sequence[torch.Tensor], first_rows: Sequence[int],
                   quant: Optional[str] = None) -> List[torch.Tensor]:
    """Logits in fp32 of each sequence's rows ``first_rows[i]`` .. end:
    ``[n_i - first_rows[i], vocab]``.  ``weights``: the served tree (layer
    stacked ``[L, ...]`` leaves, any float type); ``seqs``: token ids on the
    weights' device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = weights["blocks"]
    moe = sizes["num_experts"] > 0
    eps = sizes["norm_eps"]
    table = weights["embed"]["table"]
    with torch.no_grad():
        xs = [table[t.long()].float() for t in seqs]
        for layer in range(sizes["num_layers"]):
            lw = {"ln1": b["ln1"]["scale"][layer].float(),
                  "ln2": b["ln2"]["scale"][layer].float()}
            for name in ("wq", "wk", "wv", "wo"):
                lw[name] = b["attn"][name]["w"][layer].float()
            xs = [_attention(x, lw, sizes, quant) for x in xs]
            del lw["wq"], lw["wk"], lw["wv"], lw["wo"]
            lens = [x.shape[0] for x in xs]
            x = torch.cat(xs)
            del xs
            hx = _rms(x, lw["ln2"], eps)
            if moe:
                m = b["moe"]
                lw["router"] = m["router"]["w"][layer].float()
                x += _ffn_moe(hx, lw, lambda e: (
                    m["w_gate"][layer, e].float(), m["w_up"][layer, e].float(),
                    m["w_down"][layer, e].float()), sizes, quant)
            else:
                for name in ("gate", "up", "down"):
                    lw[name] = b["mlp"][name]["w"][layer].float()
                x += _ffn_dense(hx, lw, quant)
            del hx, lw
            xs = list(torch.split(x, lens))
        ln_f = weights["ln_f"]["scale"].float()
        head = weights["lm_head"]["w"].float()
        return [_mm(_rms(x[r:], ln_f, eps), head, quant)
                for x, r in zip(xs, first_rows)]
