"""RWKV-6 language model stack (attention-free): the PyTorch counterpart of
``repro/models/rwkv_lm.py``.

Decode state is O(1) in sequence length: per layer a [B, H, N, N] wkv state
plus two token-shift vectors.  Parameters keep the reference's
layer-stacked ``[L, ...]`` leaves and the cache its ``[L, B, ...]`` leaves,
so the serving engine's batch axis is 1.  Decode updates the cache in
place.  Norms are RMS, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .layers import (dtype_of, embed, init_embedding, init_linear,
                     init_rms_norm, linear, rms_norm)
from .ssm import (RWKVState, init_rwkv_channel_mix, init_rwkv_time_mix,
                  rwkv_channel_mix, rwkv_time_mix, rwkv_time_mix_decode)
from .transformer import (LMOutputs, _layer, _layers, _remat,
                          _stacked_blocks)

__all__ = ["init_rwkv_lm", "rwkv_forward", "rwkv_prefill",
           "rwkv_decode_step", "init_rwkv_cache"]


def _init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg)
    return {"ln1": init_rms_norm(cfg.d_model, dt, gen.device),
            "tm": init_rwkv_time_mix(gen, cfg, dt),
            "ln2": init_rms_norm(cfg.d_model, dt, gen.device),
            "cm": init_rwkv_channel_mix(gen, cfg, dt)}


def init_rwkv_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen.device`` with the reference's tree,
    layouts and distributions (not its numbers: the generators differ)."""
    dt = dtype_of(cfg)
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "blocks": _stacked_blocks(gen, cfg, _init_block),
        "ln_f": init_rms_norm(cfg.d_model, dt, gen.device),
        "lm_head": init_linear(gen, cfg.d_model, cfg.vocab_size, dtype=dt),
    }


def _block_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[RWKVState]):
    tm_state = None if state is None else (state.tm_shift, state.s)
    y, (tm_shift, s_end) = rwkv_time_mix(
        p["tm"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg, tm_state)
    h = x + y
    cm_prev = None if state is None else state.cm_shift
    y2, cm_shift = rwkv_channel_mix(
        p["cm"], rms_norm(p["ln2"], h, cfg.norm_eps), cfg, cm_prev)
    return h + y2, RWKVState(tm_shift, cm_shift, s_end)


def rwkv_forward(params: dict, batch: dict, cfg: ModelConfig) -> LMOutputs:
    """Training forward: logits at every position.  No state is passed, so
    every layer takes the chunked scan, never the WKV-6 kernel (as in the
    reference)."""
    x = embed(params["embed"], batch["tokens"], cfg.onehot_embed)
    remat = _remat(cfg)
    for p in _layers(params["blocks"], cfg.num_layers):
        x, _ = (checkpoint(_block_fwd, p, x, cfg, None, use_reentrant=False)
                if remat else _block_fwd(p, x, cfg, None))
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return LMOutputs(linear(params["lm_head"], x))


def init_rwkv_cache(cfg: ModelConfig, batch: int, device=None) -> RWKVState:
    n = cfg.rwkv_head_size
    h = cfg.d_model // n
    dt = dtype_of(cfg)
    shift = (cfg.num_layers, batch, cfg.d_model)
    return RWKVState(
        tm_shift=torch.zeros(shift, dtype=dt, device=device),
        cm_shift=torch.zeros(shift, dtype=dt, device=device),
        s=torch.zeros((cfg.num_layers, batch, h, n, n), dtype=torch.float32,
                      device=device))


def _zero_state(cfg: ModelConfig, b: int, device) -> RWKVState:
    n = cfg.rwkv_head_size
    h = cfg.d_model // n
    dt = dtype_of(cfg)
    return RWKVState(
        torch.zeros((b, cfg.d_model), dtype=dt, device=device),
        torch.zeros((b, cfg.d_model), dtype=dt, device=device),
        torch.zeros((b, h, n, n), dtype=torch.float32, device=device))


def rwkv_prefill(params: dict, batch: dict, cfg: ModelConfig,
                 s_max: int | None = None):
    """Run the prompt from a zero state (so every layer takes the WKV-6
    kernel under ``use_flash``).  Returns (last-position logits [B, 1, V],
    the layer-stacked state); its size does not depend on the prompt."""
    del s_max  # state size does not depend on context length
    x = embed(params["embed"], batch["tokens"], cfg.onehot_embed)
    zero = _zero_state(cfg, x.shape[0], x.device)
    states = []
    for i in range(cfg.num_layers):
        x, st = _block_fwd(_layer(params["blocks"], i), x, cfg, zero)
        states.append(st)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    stacked = RWKVState(*(torch.stack(f) for f in zip(*states)))
    return linear(params["lm_head"], x[:, -1:]), stacked


def rwkv_decode_step(params: dict, token: torch.Tensor, cache: RWKVState,
                     pos, cfg: ModelConfig):
    """token: [B, 1].  Returns (logits [B, 1, V], the cache, updated in
    place)."""
    del pos  # stateful recurrence needs no position index
    x = embed(params["embed"], token, cfg.onehot_embed)
    for i in range(cfg.num_layers):
        pl = _layer(params["blocks"], i)
        y, (tm_shift, s) = rwkv_time_mix_decode(
            pl["tm"], rms_norm(pl["ln1"], x, cfg.norm_eps), cfg,
            (cache.tm_shift[i], cache.s[i]))
        hh = x + y
        y2, cm_shift = rwkv_channel_mix(
            pl["cm"], rms_norm(pl["ln2"], hh, cfg.norm_eps), cfg,
            cache.cm_shift[i])
        x = hh + y2
        cache.tm_shift[i].copy_(tm_shift)
        cache.cm_shift[i].copy_(cm_shift)
        cache.s[i].copy_(s)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return linear(params["lm_head"], x), cache
