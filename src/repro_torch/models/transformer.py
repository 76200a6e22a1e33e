"""Decoder-only transformer trunk (the ``dense`` and ``moe`` families).

The PyTorch counterpart of ``repro/models/transformer.py``.  Parameters keep
the reference's layer-stacked ``[L, ...]`` leaves; the reference's
``lax.scan`` over layers is a Python loop that takes layer ``l``'s views.
KV caches are written in place (see ``attention``).  The VLM trunk is not
yet ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from .attention import (KVCache, PagedKVCache, attention_decode,
                        attention_decode_paged, attention_fwd,
                        attention_prefill_chunk_paged,
                        attention_verify_paged, init_attention,
                        init_kv_cache, init_paged_kv_cache)
from .layers import (dtype_of, embed, init_embedding, init_linear, init_mlp,
                     init_rms_norm, linear, mlp, rms_norm)
from .moe import init_moe, moe_fwd

__all__ = ["init_lm", "lm_prefill", "lm_decode_step", "init_lm_cache",
           "init_lm_paged_cache", "lm_decode_step_paged",
           "lm_prefill_chunk_paged", "lm_verify_paged",
           "lm_insert_prefill_paged"]


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.num_experts > 0


def _init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg)
    p = {"ln1": init_rms_norm(cfg.d_model, dt, gen.device),
         "attn": init_attention(gen, cfg, dt),
         "ln2": init_rms_norm(cfg.d_model, dt, gen.device)}
    if _is_moe(cfg):
        p["moe"] = init_moe(gen, cfg, dt)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def _ffn(p: dict, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's feed-forward: the MoE layer (grouped-SwiGLU kernel under
    ``use_flash``, as in the reference) or the dense MLP."""
    if _is_moe(cfg):
        return moe_fwd(p["moe"], z, cfg, use_kernel=cfg.use_flash)[0]
    return mlp(p["mlp"], z)


def _stacked_blocks(gen: torch.Generator, cfg: ModelConfig,
                    init_block=_init_block) -> dict:
    """Every block's tree (``init_block(gen, cfg)``) with ``[L, ...]``
    leaves.  Each leaf is allocated once and filled layer by layer, so the
    weights are never held twice: the peak is the stack plus one layer's
    tree."""
    def empty(tree):
        if isinstance(tree, dict):
            return {k: empty(v) for k, v in tree.items()}
        return torch.empty((cfg.num_layers,) + tuple(tree.shape),
                           dtype=tree.dtype, device=tree.device)

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    blocks = None
    for i in range(cfg.num_layers):
        layer = init_block(gen, cfg)
        if blocks is None:
            blocks = empty(layer)
        fill(blocks, layer, i)
        del layer
    return blocks


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen.device`` with the reference's tree,
    layouts and distributions (not its numbers: the generators differ)."""
    if cfg.vision_embed_dim:
        raise NotImplementedError(f"{cfg.name}: the VLM trunk is not yet "
                                  "ported")
    dt = dtype_of(cfg)
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "blocks": _stacked_blocks(gen, cfg),
        "ln_f": init_rms_norm(cfg.d_model, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                        dtype=dt)
    return params


def _block_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig, positions, mask):
    """One block over the full sequence; returns (output, (k, v))."""
    attn_out, kv = attention_fwd(p["attn"],
                                 rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
                                 positions, mask, use_flash=cfg.use_flash,
                                 return_kv=True)
    h = x + attn_out
    return h + _ffn(p, rms_norm(p["ln2"], h, cfg.norm_eps), cfg), kv


def _block_decode(p: dict, x: torch.Tensor, cache: KVCache, pos, cfg):
    y_attn, new_cache = attention_decode(
        p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cache, pos, cfg)
    h = x + y_attn
    return h + _ffn(p, rms_norm(p["ln2"], h, cfg.norm_eps), cfg), new_cache


def _unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return linear(params["lm_head"], x)


def init_lm_cache(cfg: ModelConfig, batch: int, s_max: int,
                  device=None) -> KVCache:
    one = init_kv_cache(cfg, batch, s_max, dtype_of(cfg), device)
    shape = (cfg.num_layers,) + tuple(one.k.shape)
    return KVCache(torch.zeros(shape, dtype=one.k.dtype, device=device),
                   torch.zeros(shape, dtype=one.v.dtype, device=device))


def lm_prefill(params: dict, batch: dict, cfg: ModelConfig,
               s_max: Optional[int] = None):
    """Run the prompt, return (last-position logits, filled cache)."""
    x = embed(params["embed"], batch["tokens"])
    b, s, _ = x.shape
    s_max = s_max or s
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_lm_cache(cfg, b, s_max, x.device)
    cap = cache.k.shape[2]
    w = min(s, cap)
    for i in range(cfg.num_layers):
        x, (k, v) = _block_fwd(_layer(params["blocks"], i), x, cfg,
                               positions, None)
        # Place the prompt K/V tail into a cache of capacity s_max;
        # ring-align so that position p sits at slot p % s_max (what decode
        # expects).
        tail_k, tail_v = k[:, s - w:s], v[:, s - w:s]
        if w == cap and s % cap:
            tail_k = torch.roll(tail_k, s % cap, dims=1)
            tail_v = torch.roll(tail_v, s % cap, dims=1)
        cache.k[i, :, :w] = tail_k.to(cache.k.dtype)
        cache.v[i, :, :w] = tail_v.to(cache.v.dtype)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return _unembed(params, x[:, -1:], cfg), cache


def lm_decode_step(params: dict, token: torch.Tensor, cache: KVCache, pos,
                   cfg: ModelConfig):
    """token: [B, 1]; pos: [] or [B] positions.  Returns (logits [B,1,V],
    the cache, updated in place)."""
    x = embed(params["embed"], token)
    for i in range(cfg.num_layers):
        x, _ = _block_decode(_layer(params["blocks"], i), x,
                             KVCache(cache.k[i], cache.v[i]), pos, cfg)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return _unembed(params, x, cfg), cache


# --------------------------------------------------------------------------
# Paged KV: decode + chunked prefill through per-request block tables
# --------------------------------------------------------------------------

def init_lm_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                        device=None) -> PagedKVCache:
    """Layer-stacked physical block pool [L, num_blocks, bs, kvH, hd]; the
    block table (host-side, ``serving.paged_kv``) is shared across layers."""
    one = init_paged_kv_cache(cfg, num_blocks, block_size, dtype_of(cfg),
                              device)
    shape = (cfg.num_layers,) + tuple(one.k.shape)
    return PagedKVCache(torch.zeros(shape, dtype=one.k.dtype, device=device),
                        torch.zeros(shape, dtype=one.v.dtype, device=device))


def lm_decode_step_paged(params: dict, token: torch.Tensor,
                         cache: PagedKVCache, table: torch.Tensor, pos,
                         cfg: ModelConfig):
    """Paged decode: K/V read through ``table`` [B, max_blocks] instead of a
    dense per-slot buffer; identical to :func:`lm_decode_step` over a
    contiguous cache of the same logical capacity."""
    x = embed(params["embed"], token)
    for i in range(cfg.num_layers):
        p = _layer(params["blocks"], i)
        y_attn, _ = attention_decode_paged(
            p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps),
            PagedKVCache(cache.k[i], cache.v[i]), table, pos, cfg)
        h = x + y_attn
        x = h + _ffn(p, rms_norm(p["ln2"], h, cfg.norm_eps), cfg)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return _unembed(params, x, cfg), cache


def lm_prefill_chunk_paged(params: dict, batch: dict, cache: PagedKVCache,
                           table_row: torch.Tensor, start, cfg: ModelConfig):
    """Run one chunk of a single request's prompt (tokens [1, c]) against
    its block table, writing the chunk's K/V into the pool.  Returns
    (last-position logits [1, 1, V], the pool)."""
    x = embed(params["embed"], batch["tokens"])
    for i in range(cfg.num_layers):
        p = _layer(params["blocks"], i)
        attn, _ = attention_prefill_chunk_paged(
            p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps),
            PagedKVCache(cache.k[i], cache.v[i]), table_row, start, cfg)
        h = x + attn
        x = h + _ffn(p, rms_norm(p["ln2"], h, cfg.norm_eps), cfg)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return _unembed(params, x[:, -1:], cfg), cache


def lm_verify_paged(params: dict, tokens: torch.Tensor, cache: PagedKVCache,
                    table: torch.Tensor, pos, cfg: ModelConfig):
    """Speculative verification step: run ``c`` tokens per sequence
    (``tokens`` [B, c]: the last accepted token, then the draft's proposals)
    through the pool at positions ``pos[b] .. pos[b]+c-1`` and return
    **all-position** logits [B, c, V] (row ``i`` decides whether draft token
    ``i+1`` is accepted) and the pool, written in place."""
    x = embed(params["embed"], tokens)
    for i in range(cfg.num_layers):
        p = _layer(params["blocks"], i)
        attn, _ = attention_verify_paged(
            p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps),
            PagedKVCache(cache.k[i], cache.v[i]), table, pos, cfg)
        h = x + attn
        x = h + _ffn(p, rms_norm(p["ln2"], h, cfg.norm_eps), cfg)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return _unembed(params, x, cfg), cache


def lm_insert_prefill_paged(cache: PagedKVCache, dense: KVCache,
                            table_row: torch.Tensor, slot,
                            cfg: ModelConfig) -> PagedKVCache:
    """Scatter a single request's contiguous prefill cache (ring-aligned
    [L, 1, cap, kvH, hd], from :func:`lm_prefill`) into the pool blockwise,
    in place.  Sink-padded table entries receive the (zero) tail blocks:
    harmless, the sink is never unmasked.  ``slot`` is unused."""
    del slot, cfg
    row = table_row.long()
    nblk = row.shape[0]
    bs = cache.k.shape[2]
    lead = cache.k.shape[0]
    for pool, full in ((cache.k, dense.k), (cache.v, dense.v)):
        blocks = full[:, 0].reshape(lead, nblk, bs, *pool.shape[3:])
        pool[:, row] = blocks.to(pool.dtype)
    return cache
