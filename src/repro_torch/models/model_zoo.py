"""Uniform model interface (``Model``, ``build_model``) for the ported
families: ``dense``, ``moe`` and ``vlm`` (one trunk, as in the reference:
the engine serves a VLM text-only, and ``prefill`` takes a batch's
``image_embeds``), ``ssm``
(RWKV-6, no paged path) and ``hybrid`` (Jamba: paged attention KV, Mamba
states per slot; no chunked prefill, prefix caching or verify path).

The PyTorch counterpart of ``repro/models/model_zoo.py``.  A ``Model`` is
bound to a device; ``init(seed)`` draws its parameters there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import hybrid, rwkv_lm, transformer

__all__ = ["Model", "build_model"]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[int], dict]                # (seed) -> params
    prefill: Callable[..., tuple]              # (params, batch, s_max)
    decode_step: Callable[..., tuple]          # (params, token, cache, pos)
    init_cache: Callable[..., Any]             # (batch, s_max) -> cache
    #: contiguous slot insertion (cache, dense_cache_B1, slot) -> cache.
    #: None = every cache leaf carries batch on the engine's batch_axis;
    #: the hybrid overrides it (KV on axis 1, Mamba states on axis 2).
    insert_prefill: Optional[Callable[..., Any]] = None
    # Paged-KV serving paths:
    #   init_paged_cache(batch, num_blocks, block_size) -> pool cache
    #   decode_step_paged(params, token, cache, table, pos)
    #   insert_prefill_paged(cache, dense_cache_B1, table_row, slot)
    #   prefill_chunk_paged(params, batch, cache, table_row, start)
    #   verify_paged(params, tokens_Bc, cache, table, pos): speculative
    #     verification, all-position logits for c tokens per sequence
    #     (attention trunks only: RWKV and Mamba states are not positional,
    #     so rejected draft state could not be rolled back)
    init_paged_cache: Optional[Callable[..., Any]] = None
    decode_step_paged: Optional[Callable[..., tuple]] = None
    insert_prefill_paged: Optional[Callable[..., Any]] = None
    prefill_chunk_paged: Optional[Callable[..., tuple]] = None
    verify_paged: Optional[Callable[..., tuple]] = None

    @property
    def supports_paged(self) -> bool:
        return self.decode_step_paged is not None

    @property
    def supports_speculation(self) -> bool:
        """Can act as a speculative-decoding *target* (paged verify path)."""
        return self.verify_paged is not None

    @property
    def supports_drafting(self) -> bool:
        """Can act as a *draft* model: a standalone contiguous cache and
        decode step."""
        return self.init_cache is not None


def build_model(cfg: ModelConfig, device=None) -> Model:
    """``device`` None means CUDA (raises without a CUDA device); pass
    ``"cpu"`` to run on the CPU."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed: rwkv_lm.init_rwkv_lm(
                torch.Generator(device=dev).manual_seed(seed), cfg),
            prefill=lambda p, b, s_max=None: rwkv_lm.rwkv_prefill(
                p, b, cfg, s_max),
            decode_step=lambda p, tok, cache, pos: rwkv_lm.rwkv_decode_step(
                p, tok, cache, pos, cfg),
            init_cache=lambda batch, s_max: rwkv_lm.init_rwkv_cache(
                cfg, batch, dev),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed: hybrid.init_hybrid_lm(
                torch.Generator(device=dev).manual_seed(seed), cfg),
            prefill=lambda p, b, s_max=None: hybrid.hybrid_prefill(
                p, b, cfg, s_max),
            decode_step=lambda p, tok, cache, pos: hybrid.hybrid_decode_step(
                p, tok, cache, pos, cfg),
            init_cache=lambda batch, s_max: hybrid.init_hybrid_cache(
                cfg, batch, s_max, dev),
            insert_prefill=lambda cache, dense, slot:
                hybrid.hybrid_insert_prefill(cache, dense, slot, cfg),
            init_paged_cache=lambda batch, nb, bs:
                hybrid.init_hybrid_paged_cache(cfg, batch, nb, bs, dev),
            decode_step_paged=lambda p, tok, cache, table, pos:
                hybrid.hybrid_decode_step_paged(p, tok, cache, table, pos,
                                                cfg),
            insert_prefill_paged=lambda cache, dense, row, slot:
                hybrid.hybrid_insert_prefill_paged(cache, dense, row, slot,
                                                   cfg),
            # chunked prefill needs Mamba state carry across chunks: the
            # hybrid prefills whole prompts (still paged for decode)
        )
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported "
                                  "to repro_torch")
    return Model(
        cfg=cfg,
        device=dev,
        init=lambda seed: transformer.init_lm(
            torch.Generator(device=dev).manual_seed(seed), cfg),
        prefill=lambda p, b, s_max=None: transformer.lm_prefill(
            p, b, cfg, s_max),
        decode_step=lambda p, tok, cache, pos: transformer.lm_decode_step(
            p, tok, cache, pos, cfg),
        init_cache=lambda batch, s_max: transformer.init_lm_cache(
            cfg, batch, s_max, dev),
        init_paged_cache=lambda batch, nb, bs:
            transformer.init_lm_paged_cache(cfg, nb, bs, dev),
        decode_step_paged=lambda p, tok, cache, table, pos:
            transformer.lm_decode_step_paged(p, tok, cache, table, pos, cfg),
        insert_prefill_paged=lambda cache, dense, row, slot:
            transformer.lm_insert_prefill_paged(cache, dense, row, slot,
                                                cfg),
        prefill_chunk_paged=lambda p, b, cache, row, start:
            transformer.lm_prefill_chunk_paged(p, b, cache, row, start, cfg),
        verify_paged=lambda p, toks, cache, table, pos:
            transformer.lm_verify_paged(p, toks, cache, table, pos, cfg),
    )
