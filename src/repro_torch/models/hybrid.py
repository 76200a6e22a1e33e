"""Jamba-style hybrid stack: superblocks of ``attn_every`` layers with one
attention layer (at ``attn_index``) and Mamba elsewhere; every
``moe_layer_period``-th layer's FFN is MoE, the rest dense MLP.

The PyTorch counterpart of ``repro/models/hybrid.py``.  Parameters keep the
reference's superblock-stacked tree: ``superblocks/layers/<i>/...`` is a
list of the ``attn_every`` layers, each leaf ``[n_sb, ...]``; the
reference's ``lax.scan`` over superblocks is a Python loop that takes
superblock ``s``'s views.  Decode carries one KV cache per superblock (the
attention layer's: paged or contiguous) plus the Mamba states, which stay
slot-indexed on batch axis 2 in both layouts.  Caches are written in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..sharding.dtensor import placed_like
from .attention import (KVCache, PagedKVCache, attention_decode,
                        attention_decode_paged, attention_fwd,
                        init_attention, init_kv_cache, init_paged_kv_cache)
from .layers import (dtype_of, embed, init_embedding, init_linear, init_mlp,
                     init_rms_norm, linear, mlp, rms_norm)
from .moe import init_moe, moe_fwd
from .ssm import MambaState, init_mamba, mamba_decode, mamba_fwd
from .transformer import (LMOutputs, _layer, _layers, _remat, _stack_into,
                          lm_insert_prefill_paged)

__all__ = ["init_hybrid_lm", "hybrid_forward", "hybrid_prefill",
           "hybrid_decode_step", "init_hybrid_cache", "HybridCache",
           "hybrid_insert_prefill",
           "HybridPagedCache", "init_hybrid_paged_cache",
           "hybrid_decode_step_paged", "hybrid_insert_prefill_paged"]


class HybridCache(NamedTuple):
    kv: KVCache          # [n_sb, B, S, kvH, hd] (one attn layer / superblock)
    conv: torch.Tensor   # [n_sb, n_mamba, B, dc-1, di]
    h: torch.Tensor      # [n_sb, n_mamba, B, di, ds]


class HybridPagedCache(NamedTuple):
    """Paged hybrid cache: only the attention KV (the part that grows with
    context) is paged; Mamba conv/ssm states are O(1) per sequence and stay
    slot-indexed on the batch axis."""
    kv: PagedKVCache     # [n_sb, num_blocks, bs, kvH, hd]
    conv: torch.Tensor   # [n_sb, n_mamba, B, dc-1, di]
    h: torch.Tensor      # [n_sb, n_mamba, B, di, ds]


def _positions(cfg: ModelConfig):
    sb = cfg.attn_every
    attn_at = cfg.attn_index % sb
    moe_at = [i for i in range(sb) if (i % cfg.moe_layer_period)
              == (cfg.moe_layer_period - 1)] if cfg.num_experts else []
    return sb, attn_at, moe_at


def _n_superblocks(cfg: ModelConfig) -> int:
    sb, _, _ = _positions(cfg)
    if cfg.num_layers % sb:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not tile "
                         f"into superblocks of {sb}")
    return cfg.num_layers // sb


def _init_layer(gen: torch.Generator, cfg: ModelConfig, i: int) -> dict:
    """Layer ``i`` of a superblock (the reference's ``_init_superblock``,
    one layer at a time)."""
    dt = dtype_of(cfg)
    _, attn_at, moe_at = _positions(cfg)
    layer = {"ln1": init_rms_norm(cfg.d_model, dt, gen.device),
             "ln2": init_rms_norm(cfg.d_model, dt, gen.device)}
    if i == attn_at:
        layer["attn"] = init_attention(gen, cfg, dt)
    else:
        layer["mamba"] = init_mamba(gen, cfg, dt)
    if i in moe_at:
        layer["moe"] = init_moe(gen, cfg, dt)
    else:
        layer["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
    return layer


def init_hybrid_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen.device`` with the reference's tree,
    layouts and distributions (not its numbers: the generators differ).
    Each layer is drawn alone and copied into its stacked leaves, so the
    peak is the stack plus one layer (a superblock of Jamba is 26 GB)."""
    dt = dtype_of(cfg)
    sb, _, _ = _positions(cfg)
    n_sb = _n_superblocks(cfg)
    layers = [None] * sb
    for s in range(n_sb):
        for i in range(sb):
            layers[i] = _stack_into(layers[i], _init_layer(gen, cfg, i), s,
                                    n_sb)
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "superblocks": {"layers": layers},
        "ln_f": init_rms_norm(cfg.d_model, dt, gen.device),
        "lm_head": init_linear(gen, cfg.d_model, cfg.vocab_size, dtype=dt),
    }


def _ffn(layer: dict, h: torch.Tensor, cfg: ModelConfig):
    """The layer's feed-forward and residual, and its MoE aux loss (None
    for a dense layer): MoE (grouped-SwiGLU kernel under ``use_flash``, as
    in the reference) or the dense MLP."""
    z = rms_norm(layer["ln2"], h, cfg.norm_eps)
    if "moe" in layer:
        y, stats = moe_fwd(layer["moe"], z, cfg, use_kernel=cfg.use_flash)
        return h + y, stats.aux_loss
    return h + mlp(layer["mlp"], z), None


def _superblock_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    """One superblock over the full sequence: (output, the attention
    layer's (k, v), the Mamba layers' states stacked [n_mamba, ...], the
    sum of its MoE layers' aux losses)."""
    kv = aux = None
    convs, hs = [], []
    for layer in p["layers"]:
        z = rms_norm(layer["ln1"], x, cfg.norm_eps)
        if "attn" in layer:
            out, kv = attention_fwd(layer["attn"], z, cfg, positions,
                                    use_flash=cfg.use_flash, return_kv=True)
        else:
            out, st = mamba_fwd(layer["mamba"], z, cfg)
            convs.append(st.conv)
            hs.append(st.h)
        x, a = _ffn(layer, x + out, cfg)
        if a is not None:     # the reference adds from fp32 0: 0 + a == a
            aux = a if aux is None else aux + a
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return x, kv, MambaState(torch.stack(convs), torch.stack(hs)), aux


def hybrid_forward(params: dict, batch: dict, cfg: ModelConfig) -> LMOutputs:
    """Training forward: logits at every position and the superblocks' mean
    MoE aux loss."""
    x = embed(params["embed"], batch["tokens"], cfg.onehot_embed)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = _remat(cfg)
    auxs = []
    for p in _layers(params["superblocks"], _n_superblocks(cfg)):
        x, _, _, aux = (checkpoint(_superblock_fwd, p, x, cfg, positions,
                                   use_reentrant=False)
                        if remat else _superblock_fwd(p, x, cfg, positions))
        auxs.append(aux)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return LMOutputs(linear(params["lm_head"], x),
                     moe_aux=torch.stack(auxs).mean())


def _mamba_states(cfg: ModelConfig, batch: int, device):
    sb, _, _ = _positions(cfg)
    lead = (_n_superblocks(cfg), sb - 1, batch)
    return (torch.zeros(lead + (cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
                        dtype=dtype_of(cfg), device=device),
            torch.zeros(lead + (cfg.mamba_d_inner, cfg.mamba_d_state),
                        dtype=torch.float32, device=device))


def init_hybrid_cache(cfg: ModelConfig, batch: int, s_max: int,
                      device=None) -> HybridCache:
    one = init_kv_cache(cfg, batch, s_max, dtype_of(cfg), device)
    shape = (_n_superblocks(cfg),) + tuple(one.k.shape)
    kv = KVCache(torch.zeros(shape, dtype=one.k.dtype, device=device),
                 torch.zeros(shape, dtype=one.v.dtype, device=device))
    return HybridCache(kv, *_mamba_states(cfg, batch, device))


def hybrid_prefill(params: dict, batch: dict, cfg: ModelConfig,
                   s_max: Optional[int] = None):
    """Run the prompt, return (last-position logits, filled cache)."""
    x = embed(params["embed"], batch["tokens"], cfg.onehot_embed)
    b, s, _ = x.shape
    s_max = s_max or s
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_hybrid_cache(cfg, b, s_max, x.device)
    cap = cache.kv.k.shape[2]
    w = min(s, cap)
    for i in range(_n_superblocks(cfg)):
        x, (k, v), st, _ = _superblock_fwd(_layer(params["superblocks"], i),
                                           x, cfg, positions)
        if i == 0:      # under a mesh, the cache is placed as what it holds
            cache = HybridCache(
                KVCache(placed_like(cache.kv.k, k, 1),
                        placed_like(cache.kv.v, v, 1)),
                placed_like(cache.conv, st.conv, 1),
                placed_like(cache.h, st.h, 1))
        # the prompt K/V tail, ring-aligned: position p at slot p % cap
        tail_k, tail_v = k[:, s - w:s], v[:, s - w:s]
        if w == cap and s % cap:
            tail_k = torch.roll(tail_k, s % cap, dims=1)
            tail_v = torch.roll(tail_v, s % cap, dims=1)
        cache.kv.k[i, :, :w] = tail_k.to(cache.kv.k.dtype)
        cache.kv.v[i, :, :w] = tail_v.to(cache.kv.v.dtype)
        cache.conv[i] = st.conv
        cache.h[i] = st.h
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return linear(params["lm_head"], x[:, -1:]), cache


def _superblock_decode(p: dict, x: torch.Tensor, attend: Callable,
                       conv: torch.Tensor, h: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """One superblock of one-token decode.  ``attend(attn_params, z)`` is
    the attention layer's decode over its cache; ``conv`` and ``h`` (this
    superblock's Mamba states, [n_mamba, B, ...]) are updated in place."""
    mi = 0
    for layer in p["layers"]:
        z = rms_norm(layer["ln1"], x, cfg.norm_eps)
        if "attn" in layer:
            y = attend(layer["attn"], z)
        else:
            y, st = mamba_decode(layer["mamba"], z, cfg,
                                 MambaState(conv[mi], h[mi]))
            conv[mi], h[mi] = st.conv, st.h
            mi += 1
        x, _ = _ffn(layer, x + y, cfg)
    return x


def hybrid_decode_step(params: dict, token: torch.Tensor, cache: HybridCache,
                       pos, cfg: ModelConfig):
    """token: [B, 1]; pos: [] or [B] positions.  Returns (logits [B,1,V],
    the cache, updated in place)."""
    x = embed(params["embed"], token, cfg.onehot_embed)
    for i in range(_n_superblocks(cfg)):
        kv = KVCache(cache.kv.k[i], cache.kv.v[i])

        def attend(p, z, kv=kv):
            return attention_decode(p, z, kv, pos, cfg)[0]
        x = _superblock_decode(_layer(params["superblocks"], i), x, attend,
                               cache.conv[i], cache.h[i], cfg)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return linear(params["lm_head"], x), cache


def hybrid_insert_prefill(cache: HybridCache, dense: HybridCache, slot,
                          cfg: ModelConfig) -> HybridCache:
    """Insert one request's prefill cache (B=1) into batch slot ``slot`` of
    the engine's contiguous cache, in place.  The batch axis differs per
    leaf (KV carries it on axis 1, Mamba conv/ssm states on axis 2), so one
    axis for every leaf would corrupt neighbouring slots' Mamba states."""
    del cfg
    cache.kv.k[:, slot] = dense.kv.k[:, 0].to(cache.kv.k.dtype)
    cache.kv.v[:, slot] = dense.kv.v[:, 0].to(cache.kv.v.dtype)
    cache.conv[:, :, slot] = dense.conv[:, :, 0].to(cache.conv.dtype)
    cache.h[:, :, slot] = dense.h[:, :, 0].to(cache.h.dtype)
    return cache


# --------------------------------------------------------------------------
# Paged KV (attention superblocks page; Mamba states stay slot-dense)
# --------------------------------------------------------------------------

def init_hybrid_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                            block_size: int, device=None
                            ) -> HybridPagedCache:
    one = init_paged_kv_cache(cfg, num_blocks, block_size, dtype_of(cfg),
                              device)
    shape = (_n_superblocks(cfg),) + tuple(one.k.shape)
    kv = PagedKVCache(torch.zeros(shape, dtype=one.k.dtype, device=device),
                      torch.zeros(shape, dtype=one.v.dtype, device=device))
    return HybridPagedCache(kv, *_mamba_states(cfg, batch, device))


def hybrid_decode_step_paged(params: dict, token: torch.Tensor,
                             cache: HybridPagedCache, table: torch.Tensor,
                             pos, cfg: ModelConfig):
    """Paged hybrid decode: attention KV read through ``table``
    [B, max_blocks], one superblock's slice of the pool at a time; conv/ssm
    states indexed by batch slot as before."""
    x = embed(params["embed"], token, cfg.onehot_embed)
    for i in range(_n_superblocks(cfg)):
        kv = PagedKVCache(cache.kv.k[i], cache.kv.v[i])

        def attend(p, z, kv=kv):
            return attention_decode_paged(p, z, kv, table, pos, cfg)[0]
        x = _superblock_decode(_layer(params["superblocks"], i), x, attend,
                               cache.conv[i], cache.h[i], cfg)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return linear(params["lm_head"], x), cache


def hybrid_insert_prefill_paged(cache: HybridPagedCache, dense: HybridCache,
                                table_row: torch.Tensor, slot,
                                cfg: ModelConfig) -> HybridPagedCache:
    """Scatter a single request's contiguous prefill cache (B=1) into the
    pool blockwise, and its Mamba states into batch slot ``slot``, in
    place."""
    lm_insert_prefill_paged(cache.kv, dense.kv, table_row, slot, cfg)
    cache.conv[:, :, slot] = dense.conv[:, :, 0].to(cache.conv.dtype)
    cache.h[:, :, slot] = dense.h[:, :, 0].to(cache.h.dtype)
    return cache
