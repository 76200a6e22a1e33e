"""Grouped-query attention with RoPE, optional sliding window, qk-norm and
QKV bias; full-sequence (prefill) and single-token (decode) paths, over a
contiguous or a paged KV cache.

The PyTorch counterpart of ``repro/models/attention.py``.  Activations are
``[B, S, H, hd]``.  Where the reference returns an updated cache, the port
writes the new K/V into the cache tensors in place (a full-size pool is too
large to copy per layer and step) and returns the same cache.  The flash
path goes through the hand-written CUDA kernel
(``kernels/flash_attention``); chunked prefill and speculative verify stay
on the masked ``_sdpa`` path, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from .layers import apply_rope, init_linear, init_rms_norm, linear, rms_norm

__all__ = ["init_attention", "attention_fwd", "attention_decode", "KVCache",
           "PagedKVCache", "attention_decode_paged",
           "attention_verify_paged", "attention_prefill_chunk_paged",
           "init_kv_cache", "init_paged_kv_cache"]

#: sequences at least this long take the chunked online-softmax path when
#: flash is off (and the lengths divide into its chunks)
_CHUNK_THRESHOLD = 8192
_Q_CHUNK = 1024
_KV_CHUNK = 2048


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, S_max, kvH, hd]
    v: torch.Tensor   # [B, S_max, kvH, hd]


class PagedKVCache(NamedTuple):
    """Shared physical block pool: logical slot ``s`` of a request lives at
    ``pool[table[s // bs], s % bs]`` (``serving.paged_kv`` owns the
    accounting; block 0 is the write sink for empty batch slots and is
    always masked)."""
    k: torch.Tensor   # [num_blocks, block_size, kvH, hd]
    v: torch.Tensor   # [num_blocks, block_size, kvH, hd]


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.bfloat16) -> dict:
    hd = cfg.resolved_head_dim
    p = {
        "wq": init_linear(gen, cfg.d_model, cfg.num_heads * hd,
                          bias=cfg.qkv_bias, dtype=dtype),
        "wk": init_linear(gen, cfg.d_model, cfg.num_kv_heads * hd,
                          bias=cfg.qkv_bias, dtype=dtype),
        "wv": init_linear(gen, cfg.d_model, cfg.num_kv_heads * hd,
                          bias=cfg.qkv_bias, dtype=dtype),
        "wo": init_linear(gen, cfg.num_heads * hd, cfg.d_model, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, dtype, gen.device)
        p["k_norm"] = init_rms_norm(hd, dtype, gen.device)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, cfg.num_heads, hd)
    k = linear(p["wk"], x).reshape(b, s, cfg.num_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """q: [B,S,H,hd]; k,v: [B,T,Hkv,hd]; mask [B|1, S, T]; GQA by
    head-group reshape.  Logits in fp32, softmax weights cast to v's dtype
    before PV, as in the reference."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, s, hkv, g, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def _sdpa_chunked(q, k, v, scale, causal: bool, window: Optional[int]):
    """The flash-attention algorithm in plain PyTorch: a loop over query
    chunks of 1024 and key/value chunks of 2048 with a running fp32 (max,
    denominator, accumulator), so memory is O(S d + chunk^2) instead of
    O(S T).  Masked logits are -1e30 and P stays fp32, as in the
    reference's ``_sdpa_chunked``."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qc, kc = _Q_CHUNK, _KV_CHUNK
    assert s % qc == 0 and t % kc == 0, (s, t)
    qf = q.reshape(b, s, hkv, g, hd).float()
    kf, vf = k.float(), v.float()
    out = torch.empty(b, s, hkv, g, hd, dtype=torch.float32, device=q.device)
    for q0 in range(0, s, qc):
        rows = torch.arange(q0, q0 + qc, device=q.device)[:, None]
        qblk = qf[:, q0:q0 + qc]                         # [B, qc, hkv, g, hd]
        acc = torch.zeros(b, hkv, g, qc, hd, dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, hkv, g, qc), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(b, hkv, g, qc, dtype=torch.float32, device=q.device)
        for k0 in range(0, t, kc):
            cols = torch.arange(k0, k0 + kc, device=q.device)[None, :]
            valid = torch.ones(qc, kc, dtype=torch.bool, device=q.device)
            if causal:
                valid &= cols <= rows
            if window is not None:
                valid &= rows - cols < window
            s_blk = torch.einsum("bqkgd,bckd->bkgqc", qblk,
                                 kf[:, k0:k0 + kc]) * scale
            s_blk = s_blk.masked_fill(~valid, -1e30)
            m_new = torch.maximum(m, s_blk.amax(-1))
            p = torch.exp(s_blk - m_new[..., None]).masked_fill(~valid, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p, vf[:, k0:k0 + kc])
            m = m_new
        out[:, q0:q0 + qc] = (acc / torch.clamp(l[..., None], min=1e-30)
                              ).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, hd).to(q.dtype)


def causal_mask(s: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= (i - j) < window
    return m


def attention_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  kv: Optional[tuple] = None,
                  use_flash: bool = False,
                  return_kv: bool = False):
    """Full-sequence attention.  ``kv`` overrides keys/values for
    cross-attention (tuple of [B,T,kvH,hd]).  With ``return_kv`` the
    projected k/v are also returned (prefill fills the cache from them)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    if kv is not None:
        k, v = kv
    scale = cfg.resolved_head_dim ** -0.5
    if use_flash:
        from ..kernels.flash_attention.ops import flash_attention
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=(kv is None), window=cfg.sliding_window,
                              scale=scale)
    elif (s >= _CHUNK_THRESHOLD or k.shape[1] >= _CHUNK_THRESHOLD) \
            and s % _Q_CHUNK == 0 and k.shape[1] % _KV_CHUNK == 0:
        # as the reference: the window applies to self-attention only, and
        # a mask the caller passed is not read on this route
        out = _sdpa_chunked(q, k, v, scale, causal=(kv is None),
                            window=cfg.sliding_window if kv is None
                            else None)
    else:
        if mask is None:
            if kv is None:
                mask = causal_mask(s, cfg.sliding_window, x.device)[None]
            else:
                mask = torch.ones((1, s, k.shape[1]), dtype=torch.bool,
                                  device=x.device)
        out = _sdpa(q, k, v, mask, scale)
    y = linear(p["wo"], out.reshape(b, s, -1))
    if return_kv:
        return y, (k, v)
    return y


def _attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, pos_vec: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """One query token per sequence over a dense logical cache view
    ``[B, cap, kvH, hd]`` at per-sequence positions.  Shared by the
    contiguous and paged decode paths: identical view widths and masks make
    the two bit-identical."""
    s_max = k_cache.shape[1]
    hd = cfg.resolved_head_dim
    if cfg.use_flash:
        # Flash decode: one query row, non-causal, per-sequence valid-kv
        # count min(pos+1, ring size) (slots fill 0..pos before wrap, the
        # whole ring is live after; attention is kv-permutation invariant)
        from ..kernels.flash_attention.ops import flash_attention
        kv_valid = torch.clamp(pos_vec + 1, max=s_max).to(torch.int32)
        return flash_attention(q.contiguous(), k_cache, v_cache, kv_valid,
                               causal=False, scale=hd ** -0.5)
    # valid positions per sequence: j <= pos (within window when sliding)
    j = torch.arange(s_max, device=q.device)[None, :]
    pcol = pos_vec[:, None]
    valid = j <= pcol
    if cfg.sliding_window is not None:
        valid = (pcol - j < cfg.sliding_window) & (j <= pcol)
        valid |= s_max <= pcol   # wrapped: the whole ring is valid
    return _sdpa(q, k_cache, v_cache, valid[:, None, :], hd ** -0.5)


def _pos_vec(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, device=device).reshape(-1).long().expand(b)


def attention_decode(p: dict, x: torch.Tensor, cache: KVCache, pos,
                     cfg: ModelConfig) -> tuple[torch.Tensor, KVCache]:
    """One-token decode.  x: [B, 1, D]; pos: [] or [B] current position
    (per-sequence positions: continuous batching mixes depths); the cache
    holds S_max past positions (ring-buffered for sliding window) and is
    written in place."""
    b = x.shape[0]
    s_max = cache.k.shape[1]
    pos_vec = _pos_vec(pos, b, x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos_vec[:, None])
    write_idx = pos_vec % s_max
    bidx = torch.arange(b, device=x.device)
    cache.k[bidx, write_idx] = k_new[:, 0].to(cache.k.dtype)
    cache.v[bidx, write_idx] = v_new[:, 0].to(cache.v.dtype)
    out = _attend_decode(q, cache.k, cache.v, pos_vec, cfg)
    y = linear(p["wo"], out.reshape(b, 1, -1))
    return y, cache


def attention_decode_paged(p: dict, x: torch.Tensor, cache: PagedKVCache,
                           table: torch.Tensor, pos,
                           cfg: ModelConfig) -> tuple[torch.Tensor,
                                                      PagedKVCache]:
    """One-token decode through per-request block tables over the shared
    pool (written in place).  ``table``: [B, max_blocks] physical block ids
    (unallocated entries point at the sink block, never unmasked).  The
    gathered logical view has the width, mask and values of
    :func:`attention_decode` over a contiguous cache of capacity
    ``max_blocks * block_size``."""
    b = x.shape[0]
    bs = cache.k.shape[1]
    cap = table.shape[1] * bs
    pos_vec = _pos_vec(pos, b, x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos_vec[:, None])
    # ring slot -> (physical block, offset); empty batch slots hit the sink
    slot = pos_vec % cap
    blk = torch.gather(table.long(), 1, (slot // bs)[:, None])[:, 0]
    off = slot % bs
    cache.k[blk, off] = k_new[:, 0].to(cache.k.dtype)
    cache.v[blk, off] = v_new[:, 0].to(cache.v.dtype)
    # gather the per-sequence logical view [B, cap, kvH, hd]
    k_log = cache.k[table.long()].reshape(b, cap, *cache.k.shape[2:])
    v_log = cache.v[table.long()].reshape(b, cap, *cache.v.shape[2:])
    out = _attend_decode(q, k_log, v_log, pos_vec, cfg)
    y = linear(p["wo"], out.reshape(b, 1, -1))
    return y, cache


def attention_verify_paged(p: dict, x: torch.Tensor, cache: PagedKVCache,
                           table: torch.Tensor, pos, cfg: ModelConfig
                           ) -> tuple[torch.Tensor, PagedKVCache]:
    """Batched multi-token decode for speculative verification: ``c`` query
    tokens per sequence at absolute positions ``pos[b] .. pos[b]+c-1``, each
    batch row through its own block table, written into the pool in place.
    Row ``i`` of sequence ``b`` attends logical columns ``j <= pos[b]+i``
    (within the sliding window), so with ``c == 1`` this is the masked path
    of :func:`attention_decode_paged`.  x: [B, c, D]; table: [B, max_blocks];
    pos: [B].  Requires ``pos[b] + c <= cap`` for live rows; inactive rows
    carry an all-sink table row (their writes land in block 0, never
    unmasked).  Always the masked ``_sdpa`` path, as in the reference."""
    b, c, _ = x.shape
    bs = cache.k.shape[1]
    tbl = table.long()
    cap = tbl.shape[1] * bs
    hd = cfg.resolved_head_dim
    pos_vec = _pos_vec(pos, b, x.device)
    rows = pos_vec[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(p, x, cfg, rows)
    slot = rows % cap
    blk = torch.gather(tbl, 1, slot // bs)                     # [B, c]
    off = slot % bs
    cache.k[blk, off] = k_new.to(cache.k.dtype)
    cache.v[blk, off] = v_new.to(cache.v.dtype)
    k_log = cache.k[tbl].reshape(b, cap, *cache.k.shape[2:])
    v_log = cache.v[tbl].reshape(b, cap, *cache.v.shape[2:])
    j = torch.arange(cap, device=x.device)[None, None, :]
    r = rows[:, :, None]
    valid = j <= r
    if cfg.sliding_window is not None:
        valid &= r - j < cfg.sliding_window
    out = _sdpa(q, k_log, v_log, valid, hd ** -0.5)
    y = linear(p["wo"], out.reshape(b, c, -1))
    return y, cache


def attention_prefill_chunk_paged(p: dict, x: torch.Tensor,
                                  cache: PagedKVCache,
                                  table_row: torch.Tensor, start,
                                  cfg: ModelConfig
                                  ) -> tuple[torch.Tensor, PagedKVCache]:
    """Prefill one chunk of a single request's prompt against its paged KV:
    query rows are absolute positions ``start .. start+c-1``; the chunk's
    K/V are written into the request's blocks, then attention runs over the
    full logical view (history + chunk) under a bottom-right causal mask.
    x: [1, c, D]; table_row: [max_blocks]; requires ``start + c <= cap``.
    Always the masked ``_sdpa`` path, as in the reference."""
    b, c, _ = x.shape
    bs = cache.k.shape[1]
    row = table_row.long()
    cap = row.shape[0] * bs
    hd = cfg.resolved_head_dim
    rows = int(start) + torch.arange(c, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, rows[None, :])
    blk = row[rows // bs]
    off = rows % bs
    cache.k[blk, off] = k_new[0].to(cache.k.dtype)
    cache.v[blk, off] = v_new[0].to(cache.v.dtype)
    k_log = cache.k[row].reshape(1, cap, *cache.k.shape[2:])
    v_log = cache.v[row].reshape(1, cap, *cache.v.shape[2:])
    j = torch.arange(cap, device=x.device)[None, None, :]  # logical col == pos
    valid = j <= rows[None, :, None]
    if cfg.sliding_window is not None:
        valid &= rows[None, :, None] - j < cfg.sliding_window
    out = _sdpa(q, k_log, v_log, valid, hd ** -0.5)
    y = linear(p["wo"], out.reshape(b, c, -1))
    return y, cache


def init_kv_cache(cfg: ModelConfig, batch: int, s_max: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    hd = cfg.resolved_head_dim
    if cfg.sliding_window is not None:
        s_max = min(s_max, cfg.sliding_window)
    shape = (batch, s_max, cfg.num_kv_heads, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        dtype=torch.bfloat16, device=None) -> PagedKVCache:
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))
