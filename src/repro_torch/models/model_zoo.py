"""Uniform model interface (``Model``, ``build_model``) for every family of
the reference: ``dense``, ``moe`` and ``vlm`` (one trunk, as in the
reference: the engine serves a VLM text-only, and ``prefill`` takes a
batch's ``image_embeds``), ``ssm`` (RWKV-6, no paged path), ``hybrid``
(Jamba: paged attention KV, Mamba states per slot; chunked prefill that
carries each request's Mamba state from chunk to chunk, beyond the
reference, which prefills the hybrid whole; no prefix caching and no
verify path, since a Mamba state can be neither rolled back nor adopted
by position) and ``encdec`` (SeamlessM4T: no
``init_cache``, since its cache comes from prefill, which needs the
encoder's output; so the engine cannot serve it, as in the reference, and
it runs through ``train.step``'s prefill and decode steps).

The PyTorch counterpart of ``repro/models/model_zoo.py``.  A ``Model`` is
bound to a device; ``init(seed)`` draws its parameters there.  ``forward``
is the training forward and ``loss`` (``lm_loss``) the next-token cross
entropy plus the MoE aux loss.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..sharding.dtensor import is_dtensor, on_mesh
from . import encdec, hybrid, rwkv_lm, ssm, transformer
from .transformer import LMOutputs

__all__ = ["Model", "build_model", "lm_loss"]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[int], dict]                # (seed) -> params
    forward: Callable[..., LMOutputs]          # (params, batch) -> outputs
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
    #   init_chunk_state() -> a request's carried state while it prefills
    #     in chunks, passed to each chunk as batch["mamba_state"] and
    #     updated there in place (models whose trunk has a recurrent
    #     state: the hybrid); None where the pool holds all of it
    #   commit_chunk_state(cache, state, slot): that state into the
    #     request's decode slot after its last chunk
    #   verify_paged(params, tokens_Bc, cache, table, pos): speculative
    #     verification, all-position logits for c tokens per sequence
    #     (attention trunks only: RWKV and Mamba states are not positional,
    #     so rejected draft state could not be rolled back)
    init_paged_cache: Optional[Callable[..., Any]] = None
    decode_step_paged: Optional[Callable[..., tuple]] = None
    insert_prefill_paged: Optional[Callable[..., Any]] = None
    prefill_chunk_paged: Optional[Callable[..., tuple]] = None
    init_chunk_state: Optional[Callable[[], Any]] = None
    commit_chunk_state: Optional[Callable[..., Any]] = None
    #: () -> running totals the model keeps of its own work, by the names
    #: of ``ServingEngine.io_stats``; the paged engine adds their change
    #: over each chunk and decode call (the hybrid: ``ssm.TOKENS``)
    counters: Optional[Callable[[], dict]] = None
    verify_paged: Optional[Callable[..., tuple]] = None

    @property
    def supports_paged(self) -> bool:
        return self.decode_step_paged is not None

    @property
    def supports_prefix_cache(self) -> bool:
        """Can resume a prompt behind an adopted prefix of pool blocks: a
        chunk path whose whole state lives in the pool (no carried
        state, which a block's content cannot restore)."""
        return (self.prefill_chunk_paged is not None
                and self.init_chunk_state is None)

    @property
    def supports_speculation(self) -> bool:
        """Can act as a speculative-decoding *target* (paged verify path)."""
        return self.verify_paged is not None

    @property
    def supports_drafting(self) -> bool:
        """Can act as a *draft* model: a standalone contiguous cache and
        decode step."""
        return self.init_cache is not None

    def loss(self, params: dict, batch: dict
             ) -> tuple[torch.Tensor, dict]:
        return lm_loss(self, params, batch)


#: the Model's steps, each run under DTensor's implicit replication
_STEPS = ("forward", "prefill", "decode_step", "decode_step_paged",
          "prefill_chunk_paged", "verify_paged")


def build_model(cfg: ModelConfig, device=None) -> Model:
    """``device`` None means CUDA (raises without a CUDA device); pass
    ``"cpu"`` to run on the CPU.  Every step runs as well on parameters
    placed on a mesh (DTensors, ``sharding.distribute``): the plain tensors
    a step makes for itself are then taken as replicated
    (``sharding.dtensor``)."""
    model = _build(cfg, resolve_device(device))
    return dataclasses.replace(model, **{
        f: on_mesh(getattr(model, f)) for f in _STEPS
        if getattr(model, f) is not None})


def _build(cfg: ModelConfig, dev: torch.device) -> Model:
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed: rwkv_lm.init_rwkv_lm(
                torch.Generator(device=dev).manual_seed(seed), cfg),
            forward=lambda p, b: rwkv_lm.rwkv_forward(p, b, cfg),
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
            forward=lambda p, b: hybrid.hybrid_forward(p, b, cfg),
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
            prefill_chunk_paged=lambda p, b, cache, row, start:
                hybrid.hybrid_prefill_chunk_paged(p, b, cache, row, start,
                                                  cfg),
            init_chunk_state=lambda: hybrid.init_hybrid_chunk_state(cfg,
                                                                    dev),
            commit_chunk_state=lambda cache, state, slot:
                hybrid.hybrid_commit_chunk_state(cache, state, slot, cfg),
            counters=lambda: dict(ssm.TOKENS),
        )
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed: encdec.init_encdec(
                torch.Generator(device=dev).manual_seed(seed), cfg),
            forward=lambda p, b: encdec.encdec_forward(p, b, cfg),
            prefill=lambda p, b, s_max=None: encdec.encdec_prefill(
                p, b, cfg, s_max),
            decode_step=lambda p, tok, cache, pos: encdec.encdec_decode_step(
                p, tok, cache, pos, cfg),
            init_cache=None,  # produced by prefill (needs encoder output)
        )
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family: {cfg.family}")
    return Model(
        cfg=cfg,
        device=dev,
        init=lambda seed: transformer.init_lm(
            torch.Generator(device=dev).manual_seed(seed), cfg),
        forward=lambda p, b: transformer.lm_forward(p, b, cfg),
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


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          vocab_chunk: int = 0) -> torch.Tensor:
    """Mean next-token cross entropy in fp32 (numerically safe at V>150k).

    ``vocab_chunk > 0`` computes the logsumexp blockwise over the vocab dim
    (running max/denominator — the flash-softmax trick applied to the loss),
    so the fp32 logits copy never materializes at full [.., V]."""
    labels = labels.long()[..., None]
    if not vocab_chunk:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        return (logz - _gold(logits, labels)).mean()
    v = logits.shape[-1]
    pad = (-v) % vocab_chunk
    if pad:  # pad vocab with -inf-like logits (no mass)
        logits = F.pad(logits, (0, pad), value=-1e30)
        v += pad
    lead = logits.shape[:-1]
    m = torch.full(lead, float("-inf"), dtype=torch.float32,
                   device=logits.device)
    l = torch.zeros(lead, dtype=torch.float32, device=logits.device)
    for ch in logits.split(vocab_chunk, dim=-1):
        ch = ch.float()
        m2 = torch.maximum(m, ch.amax(-1))
        l = l * torch.exp(m - m2) + torch.exp(ch - m2[..., None]).sum(-1)
        m = m2
    logz = m + torch.log(l)
    return (logz - _gold(logits, labels).float()).mean()


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The labels' logits: a gather, or on a DTensor (whose vocab dim may be
    sharded, where DTensor's gather fails) the sum of the one matching
    entry a row, the same value."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels).squeeze(-1)
    hit = torch.arange(logits.shape[-1], device=labels.device) == labels
    return torch.where(hit, logits, 0).sum(-1)


@on_mesh
def lm_loss(model: Model, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Cross-entropy on next-token labels + MoE auxiliary losses.

    ``batch["labels"]`` aligns with the *text* tokens; for VLM the image
    prefix positions are excluded automatically."""
    out = model.forward(params, batch)
    logits = out.logits
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:     # VLM: image prefix present
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    loss = _xent(logits[:, :-1], labels[:, 1:], model.cfg.loss_vocab_chunk)
    metrics = {"xent": loss}
    if out.moe_aux is not None:
        aux = out.moe_aux * model.cfg.router_aux_coef
        loss = loss + aux
        metrics["moe_aux"] = aux
        if out.moe_dropped is not None:
            metrics["moe_dropped_mass"] = out.moe_dropped.float().mean()
    metrics["loss"] = loss
    return loss, metrics
