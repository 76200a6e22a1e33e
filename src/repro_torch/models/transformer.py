"""Decoder-only transformer trunk (the ``dense``, ``moe`` and ``vlm``
families).

The PyTorch counterpart of ``repro/models/transformer.py``.  Parameters keep
the reference's layer-stacked ``[L, ...]`` leaves; the reference's
``lax.scan`` over layers is a Python loop that takes layer ``l``'s views.
KV caches are written in place (see ``attention``).  The VLM trunk is the
dense one with a projector (``vis_proj``) whose outputs prefix the prompt's
token embeddings when a batch carries ``image_embeds``.  ``lm_forward`` is
the training forward: all-position logits, with ``cfg.remat`` recomputing
each layer in the backward pass (``torch.utils.checkpoint``) as the
reference's ``jax.checkpoint`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import checkpoint

from .. import trace
from ..configs.base import ModelConfig
from ..sharding.dtensor import is_dtensor, placed_like
from .attention import (KVCache, PagedKVCache, attention_decode,
                        attention_decode_paged, attention_fwd,
                        attention_prefill_chunk_paged,
                        attention_verify_paged, init_attention,
                        init_kv_cache, init_paged_kv_cache)
from .layers import (dtype_of, embed, init_embedding, init_linear, init_mlp,
                     init_rms_norm, linear, mlp, rms_norm)
from .moe import MoEStats, init_moe, moe_fwd

__all__ = ["init_lm", "lm_forward", "LMOutputs", "lm_prefill", "lm_decode_step", "init_lm_cache",
           "init_lm_paged_cache", "lm_decode_step_paged",
           "lm_prefill_chunk_paged", "lm_verify_paged",
           "lm_insert_prefill_paged"]


class LMOutputs(NamedTuple):
    logits: torch.Tensor
    moe_load: Optional[torch.Tensor] = None      # [L, E]
    moe_dropped: Optional[torch.Tensor] = None   # [L]
    moe_aux: Optional[torch.Tensor] = None       # [] load-balance loss


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.num_experts > 0


def _pin(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Keep activations batch-sharded at layer boundaries (on a DTensor
    whose mesh has a 'data' axis): ``Shard(0)`` on 'data', replicated on
    the other axes, as the reference's ``with_sharding_constraint(x,
    P('data', ...))``.  MoE trunks with ``activation_sharding_moe_model``
    also shard the hidden dim over 'model'.  Anything else, a plain tensor
    included, is returned as it is."""
    if not cfg.activation_sharding or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    if "data" not in names:
        return x
    pl = [Replicate()] * mesh.ndim
    pl[names.index("data")] = Shard(0)
    if cfg.num_experts and x.ndim >= 3 \
            and cfg.activation_sharding_moe_model:
        if "model" not in names:
            return x
        pl[names.index("model")] = Shard(x.ndim - 1)
    return x.redistribute(mesh, pl)


def _remat(cfg: ModelConfig) -> bool:
    """Recompute each layer in the backward pass: ``cfg.remat``, when a
    backward pass can follow."""
    return cfg.remat and torch.is_grad_enabled()


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


def _ffn_stats(p: dict, z: torch.Tensor, cfg: ModelConfig
               ) -> tuple[torch.Tensor, Optional[MoEStats]]:
    """The block's feed-forward: the MoE layer (grouped-SwiGLU kernel under
    ``use_flash``, as in the reference) with its stats, or the dense MLP
    (stats None)."""
    if _is_moe(cfg):
        return moe_fwd(p["moe"], z, cfg, use_kernel=cfg.use_flash)
    return mlp(p["mlp"], z), None


def _ffn(p: dict, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _ffn_stats(p, z, cfg)[0]


def _stack_into(stack, tree, i: int, n: int):
    """Copy ``tree`` (nested dicts and lists of tensors) into entry ``i`` of
    ``stack``, the same tree with ``[n, ...]`` leaves, allocated here when
    ``stack`` is None.  Returns the stack."""
    if isinstance(tree, dict):
        stack = stack if stack is not None else dict.fromkeys(tree)
        for k, v in tree.items():
            stack[k] = _stack_into(stack[k], v, i, n)
        return stack
    if isinstance(tree, list):
        stack = stack if stack is not None else [None] * len(tree)
        for j, v in enumerate(tree):
            stack[j] = _stack_into(stack[j], v, i, n)
        return stack
    if stack is None:
        if n == 1:      # one layer: a view of it, not a second copy
            return tree.unsqueeze(0)
        stack = torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype,
                            device=tree.device)
    stack[i].copy_(tree)
    return stack


def _stacked_blocks(gen: torch.Generator, cfg: ModelConfig,
                    init_block=_init_block) -> dict:
    """Every block's tree (``init_block(gen, cfg)``) with ``[L, ...]``
    leaves.  Each leaf is allocated once and filled layer by layer, so the
    weights are never held twice: the peak is the stack plus one layer's
    tree (a stack of one layer views that layer's tree, with no copy)."""
    blocks = None
    for i in range(cfg.num_layers):
        blocks = _stack_into(blocks, init_block(gen, cfg), i, cfg.num_layers)
    return blocks


def _layer(tree, i: int):
    """Layer ``i``'s parameters: views into the stacked leaves."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layer(v, i) for v in tree]
    return tree[i]


def _layers(tree, n: int) -> list:
    """Every layer's parameters, each stacked leaf unbound once.  A backward
    pass then stacks the ``n`` layers' gradients once; indexing a layer at a
    time (``_layer``) would add a zero-filled gradient of the whole stack
    for every layer."""
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, list):
        per = [_layers(v, n) for v in tree]
        return [[p[i] for p in per] for i in range(n)]
    return list(torch.unbind(tree, 0))


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen.device`` with the reference's tree,
    layouts and distributions (not its numbers: the generators differ)."""
    dt = dtype_of(cfg)
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "blocks": _stacked_blocks(gen, cfg),
        "ln_f": init_rms_norm(cfg.d_model, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                        dtype=dt)
    if cfg.vision_embed_dim:
        # 2-layer projector: vision hidden -> d_model (InternVL-style)
        params["vis_proj"] = {
            "fc1": init_linear(gen, cfg.vision_embed_dim, cfg.d_model,
                               dtype=dt),
            "fc2": init_linear(gen, cfg.d_model, cfg.d_model, dtype=dt),
        }
    return params


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    """Token (+ optional image) embeddings -> [B, S, D].  The image tokens
    are prefixed, so positions run over ``num_image_tokens + S``.  The
    projector's GELU is the tanh form, ``jax.nn.gelu``'s default."""
    x = embed(params["embed"], batch["tokens"])
    if cfg.vision_embed_dim and "image_embeds" in batch:
        vp = params["vis_proj"]
        img = linear(vp["fc2"], F.gelu(
            linear(vp["fc1"], batch["image_embeds"].to(x.dtype)),
            approximate="tanh"))
        x = torch.cat([img, x], dim=1)
    return x


def _block_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig, positions, mask,
               return_kv: bool = True):
    """One block over the full sequence; returns (output, (k, v) or None,
    the MoE layer's stats or None)."""
    attn_out = attention_fwd(p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps),
                             cfg, positions, mask, use_flash=cfg.use_flash,
                             return_kv=return_kv)
    kv = None
    if return_kv:
        attn_out, kv = attn_out
    h = x + attn_out
    y, stats = _ffn_stats(p, rms_norm(p["ln2"], h, cfg.norm_eps), cfg)
    return _pin(h + y, cfg), kv, stats


def _block_decode(p: dict, x: torch.Tensor, cache: KVCache, pos, cfg):
    y_attn, new_cache = attention_decode(
        p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cache, pos, cfg)
    h = x + y_attn
    return h + _ffn(p, rms_norm(p["ln2"], h, cfg.norm_eps), cfg), new_cache


def _unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return linear(params["lm_head"], x)


def lm_forward(params: dict, batch: dict, cfg: ModelConfig) -> LMOutputs:
    """Training forward over the full sequence (after the image prefix, if
    the batch has one): logits at every position and, for MoE, each
    layer's expert load [L, E], dropped mass [L] and the mean aux loss."""
    x = _pin(_embed_inputs(params, batch, cfg), cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = _remat(cfg)
    stats = []
    for p in _layers(params["blocks"], cfg.num_layers):
        args = (p, x, cfg, positions, None, False)
        x, _, st = (checkpoint(_block_fwd, *args, use_reentrant=False)
                    if remat else _block_fwd(*args))
        stats.append(st)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    logits = _unembed(params, x, cfg)
    if _is_moe(cfg):
        load, dropped, aux = (torch.stack(f) for f in zip(*stats))
        return LMOutputs(logits, load, dropped, aux.mean())
    return LMOutputs(logits)


def init_lm_cache(cfg: ModelConfig, batch: int, s_max: int,
                  device=None) -> KVCache:
    one = init_kv_cache(cfg, batch, s_max, dtype_of(cfg), device)
    shape = (cfg.num_layers,) + tuple(one.k.shape)
    return KVCache(torch.zeros(shape, dtype=one.k.dtype, device=device),
                   torch.zeros(shape, dtype=one.v.dtype, device=device))


def lm_prefill(params: dict, batch: dict, cfg: ModelConfig,
               s_max: Optional[int] = None):
    """Run the prompt (after its image prefix, if the batch has one),
    return (last-position logits, filled cache)."""
    with trace.span("model.prefill"):
        x = _embed_inputs(params, batch, cfg)
        b, s, _ = x.shape
        s_max = s_max or s
        positions = torch.arange(s, device=x.device)[None, :]
        cache = init_lm_cache(cfg, b, s_max, x.device)
        cap = cache.k.shape[2]
        w = min(s, cap)
        for i in range(cfg.num_layers):
            x, (k, v), _ = _block_fwd(_layer(params["blocks"], i), x, cfg,
                                      positions, None)
            if i == 0:  # under a mesh, the cache is placed as its K/V are
                cache = KVCache(placed_like(cache.k, k, 1),
                                placed_like(cache.v, v, 1))
            # Place the prompt K/V tail into a cache of capacity s_max;
            # ring-align so that position p sits at slot p % s_max (what
            # decode expects).
            tail_k, tail_v = k[:, s - w:s], v[:, s - w:s]
            if w == cap and s % cap:
                tail_k = torch.roll(tail_k, s % cap, dims=1)
                tail_v = torch.roll(tail_v, s % cap, dims=1)
            cache.k[i, :, :w] = tail_k.to(cache.k.dtype)
            cache.v[i, :, :w] = tail_v.to(cache.v.dtype)
        with trace.span("model.unembed"):
            x = rms_norm(params["ln_f"], x, cfg.norm_eps)
            logits = _unembed(params, x[:, -1:], cfg)
        return logits, cache


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
    with trace.span("model.decode"):
        x = embed(params["embed"], token)
        for i in range(cfg.num_layers):
            p = _layer(params["blocks"], i)
            y_attn, _ = attention_decode_paged(
                p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps),
                PagedKVCache(cache.k[i], cache.v[i]), table, pos, cfg)
            h = x + y_attn
            x = h + _ffn(p, rms_norm(p["ln2"], h, cfg.norm_eps), cfg)
        with trace.span("model.unembed"):
            x = rms_norm(params["ln_f"], x, cfg.norm_eps)
            logits = _unembed(params, x, cfg)
        return logits, cache


def lm_prefill_chunk_paged(params: dict, batch: dict, cache: PagedKVCache,
                           table_row: torch.Tensor, start, cfg: ModelConfig):
    """Run one chunk of a single request's prompt (tokens [1, c]) against
    its block table, writing the chunk's K/V into the pool.  Returns
    (last-position logits [1, 1, V], the pool)."""
    with trace.span("model.prefill_chunk"):
        x = _embed_inputs(params, batch, cfg)
        for i in range(cfg.num_layers):
            p = _layer(params["blocks"], i)
            attn, _ = attention_prefill_chunk_paged(
                p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps),
                PagedKVCache(cache.k[i], cache.v[i]), table_row, start, cfg)
            h = x + attn
            x = h + _ffn(p, rms_norm(p["ln2"], h, cfg.norm_eps), cfg)
        with trace.span("model.unembed"):
            x = rms_norm(params["ln_f"], x, cfg.norm_eps)
            logits = _unembed(params, x[:, -1:], cfg)
        return logits, cache


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
