"""Encoder-decoder trunk (the SeamlessM4T backbone, family ``encdec``).

The PyTorch counterpart of ``repro/models/encdec.py``.  The speech frontend
is a stub, as in the reference: the encoder's inputs are precomputed frame
embeddings ``[B, S_src, audio_embed_dim]`` (projected to ``d_model`` by
``audio_proj`` where the two widths differ).  The encoder is a
bidirectional stack; the decoder a causal one whose layers also attend to
the encoder's output.  At serve time each decoder layer's cross K/V are
projected once, in prefill, and read by every decode step.

As in the reference, only the decode step's self-attention reaches the
flash kernel (under ``cfg.use_flash``); the encoder, the decoder prompt and
every cross-attention take the plain route.  Behaviours kept from the
reference:

- the encoder passes an all-true mask, which the chunked route of
  ``attention_fwd`` (S_src >= 8192, a multiple of its chunks) does not read:
  there it runs causal;
- cross-attention ropes the query at its positions, never the cross keys;
- ``encdec_decode_step`` takes one position for the whole batch (the
  reference reshapes it to ``(1, 1)``), and refuses more;
- ``encdec_prefill`` writes the prompt's last ``min(s, s_max)`` positions
  at cache offset 0.

Parameters keep the reference's tree: ``enc_blocks`` and ``dec_blocks``
with layer-stacked leaves, ``enc_ln_f``, ``embed``, ``ln_f``, ``lm_head``
and, where it exists, ``audio_proj``.  Caches are written in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..sharding.dtensor import placed_like
from .attention import (KVCache, attention_decode, attention_fwd,
                        init_attention, init_kv_cache)
from .layers import (dtype_of, embed, init_embedding, init_linear, init_mlp,
                     init_rms_norm, linear, mlp, rms_norm)
from .transformer import LMOutputs, _layers, _remat, _stacked_blocks

__all__ = ["init_encdec", "encdec_forward", "encdec_prefill",
           "encdec_decode_step", "EncDecCache"]


class EncDecCache(NamedTuple):
    self_kv: KVCache              # [L, B, S_tgt_max, kvH, hd]
    cross_k: torch.Tensor         # [L, B, S_src, kvH, hd]
    cross_v: torch.Tensor


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg)
    return {"ln1": init_rms_norm(cfg.d_model, dt, gen.device),
            "attn": init_attention(gen, cfg, dt),
            "ln2": init_rms_norm(cfg.d_model, dt, gen.device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt)}


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg)
    return {"ln1": init_rms_norm(cfg.d_model, dt, gen.device),
            "self_attn": init_attention(gen, cfg, dt),
            "ln_x": init_rms_norm(cfg.d_model, dt, gen.device),
            "cross_attn": init_attention(gen, cfg, dt),
            "ln2": init_rms_norm(cfg.d_model, dt, gen.device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt)}


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen.device`` with the reference's tree,
    layouts and distributions (not its numbers: the generators differ)."""
    dt = dtype_of(cfg)
    enc_cfg = cfg.replace(num_layers=cfg.num_encoder_layers)
    p = {
        "enc_blocks": _stacked_blocks(gen, enc_cfg, _init_enc_block),
        "enc_ln_f": init_rms_norm(cfg.d_model, dt, gen.device),
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "dec_blocks": _stacked_blocks(gen, cfg, _init_dec_block),
        "ln_f": init_rms_norm(cfg.d_model, dt, gen.device),
        "lm_head": init_linear(gen, cfg.d_model, cfg.vocab_size, dtype=dt),
    }
    if cfg.audio_embed_dim and cfg.audio_embed_dim != cfg.d_model:
        p["audio_proj"] = init_linear(gen, cfg.audio_embed_dim, cfg.d_model,
                                      dtype=dt)
    return p


def _enc_block_fwd(p: dict, h: torch.Tensor, cfg: ModelConfig, positions,
                   full) -> torch.Tensor:
    y = h + attention_fwd(p["attn"], rms_norm(p["ln1"], h, cfg.norm_eps),
                          cfg, positions, mask=full)
    return y + mlp(p["mlp"], rms_norm(p["ln2"], y, cfg.norm_eps))


def _encode(params: dict, src_embeds: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    x = src_embeds.to(dtype_of(cfg))
    if "audio_proj" in params:
        x = linear(params["audio_proj"], x)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    full = torch.ones((1, s, s), dtype=torch.bool, device=x.device)
    remat = _remat(cfg)
    for p in _layers(params["enc_blocks"], cfg.num_encoder_layers):
        args = (p, x, cfg, positions, full)
        x = (checkpoint(_enc_block_fwd, *args, use_reentrant=False)
             if remat else _enc_block_fwd(*args))
    return rms_norm(params["enc_ln_f"], x, cfg.norm_eps)


def _cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """Project the encoder's output to this layer's cross-attention K/V
    (no RoPE)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = linear(p["cross_attn"]["wk"], enc_out).reshape(
        b, s, cfg.num_kv_heads, hd)
    v = linear(p["cross_attn"]["wv"], enc_out).reshape(
        b, s, cfg.num_kv_heads, hd)
    return k, v


def _dec_block_fwd(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
                   cfg: ModelConfig, positions, return_kv: bool = False):
    """One decoder layer over the whole target sequence; with
    ``return_kv`` also (self (k, v), cross (k, v))."""
    out = attention_fwd(p["self_attn"], rms_norm(p["ln1"], x, cfg.norm_eps),
                        cfg, positions, return_kv=return_kv)
    if return_kv:
        out, self_kv = out
    h = x + out
    ck, cv = _cross_kv(p, enc_out, cfg)
    h = h + attention_fwd(p["cross_attn"],
                          rms_norm(p["ln_x"], h, cfg.norm_eps), cfg,
                          positions, kv=(ck, cv))
    h = h + mlp(p["mlp"], rms_norm(p["ln2"], h, cfg.norm_eps))
    if return_kv:
        return h, (self_kv, (ck, cv))
    return h, None


def encdec_forward(params: dict, batch: dict,
                   cfg: ModelConfig) -> LMOutputs:
    """Training forward.  batch: {"src_embeds": [B, S_src, A], "tokens":
    [B, S_tgt]}; logits at every target position."""
    enc_out = _encode(params, batch["src_embeds"], cfg)
    x = embed(params["embed"], batch["tokens"], cfg.onehot_embed)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = _remat(cfg)
    for p in _layers(params["dec_blocks"], cfg.num_layers):
        args = (p, x, enc_out, cfg, positions)
        x, _ = (checkpoint(_dec_block_fwd, *args, use_reentrant=False)
                if remat else _dec_block_fwd(*args))
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return LMOutputs(linear(params["lm_head"], x))


def encdec_prefill(params: dict, batch: dict, cfg: ModelConfig,
                   s_max: Optional[int] = None):
    """Encode the source and run the decoder prompt: (last-position logits
    [B, 1, V], an ``EncDecCache`` with the prompt's self K/V and every
    layer's cross K/V)."""
    enc_out = _encode(params, batch["src_embeds"], cfg)
    x = embed(params["embed"], batch["tokens"], cfg.onehot_embed)
    b, s, _ = x.shape
    s_max = s_max or s
    positions = torch.arange(s, device=x.device)[None, :]
    one = init_kv_cache(cfg, b, s_max, dtype_of(cfg), x.device)
    n = cfg.num_layers
    self_k = torch.zeros((n,) + tuple(one.k.shape), dtype=one.k.dtype,
                         device=x.device)
    self_v = torch.zeros_like(self_k)
    w = min(s, self_k.shape[2])
    cross_k = cross_v = None
    for i, p in enumerate(_layers(params["dec_blocks"], n)):
        x, ((k, v), (ck, cv)) = _dec_block_fwd(p, x, enc_out, cfg,
                                               positions, return_kv=True)
        if i == 0:      # under a mesh, the caches are placed as their K/V
            self_k, self_v = placed_like(self_k, k, 1), placed_like(self_v,
                                                                    v, 1)
        self_k[i, :, :w] = k[:, s - w:s].to(self_k.dtype)
        self_v[i, :, :w] = v[:, s - w:s].to(self_v.dtype)
        if cross_k is None:
            cross_k = placed_like(torch.empty(
                (n,) + tuple(ck.shape), dtype=ck.dtype, device=x.device),
                ck, 1)
            cross_v = torch.empty_like(cross_k)
        cross_k[i], cross_v[i] = ck, cv
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    logits = linear(params["lm_head"], x[:, -1:])
    return logits, EncDecCache(KVCache(self_k, self_v), cross_k, cross_v)


def encdec_decode_step(params: dict, token: torch.Tensor,
                       cache: EncDecCache, pos, cfg: ModelConfig):
    """token: [B, 1]; pos: one position for the whole batch (an int or a
    one-element tensor).  Returns (logits [B, 1, V], the cache, its self
    K/V written in place)."""
    pos_q = torch.as_tensor(pos, device=token.device)
    if pos_q.numel() != 1:
        raise ValueError(f"encdec_decode_step takes one position for the "
                         f"batch, got shape {tuple(pos_q.shape)}: the "
                         f"reference reshapes pos to (1, 1)")
    pos_q = pos_q.reshape(1, 1)
    x = embed(params["embed"], token, cfg.onehot_embed)
    b = x.shape[0]
    for i, p in enumerate(_layers(params["dec_blocks"], cfg.num_layers)):
        y, _ = attention_decode(
            p["self_attn"], rms_norm(p["ln1"], x, cfg.norm_eps),
            KVCache(cache.self_kv.k[i], cache.self_kv.v[i]), pos_q, cfg)
        h = x + y
        ck, cv = cache.cross_k[i], cache.cross_v[i]
        mask = torch.ones((b, 1, ck.shape[1]), dtype=torch.bool,
                          device=x.device)
        h = h + attention_fwd(p["cross_attn"],
                              rms_norm(p["ln_x"], h, cfg.norm_eps), cfg,
                              positions=pos_q, mask=mask, kv=(ck, cv))
        x = h + mlp(p["mlp"], rms_norm(p["ln2"], h, cfg.norm_eps))
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return linear(params["lm_head"], x), cache
