"""Paged-KV continuous-batching serving engine.

The PyTorch counterpart of ``repro/serving/engine.py``, with the same
constructor and public API.  The strategy scheduler
(``core/device/request_scheduler``) decides *what* runs each step (admission
by priority, dead-request eviction, merged and chunked prefills); this
engine executes the plan against the model.

Two KV layouts (``kv_mode``):

* ``"paged"`` (default where the family supports it): a shared physical
  pool of fixed-size KV blocks with per-request block tables
  (``serving.paged_kv``).  Blocks are allocated on demand, admission is a
  *memory* decision, long prompts prefill in chunks that re-enter the
  strategy queue between chunks, and pool pressure preempts (recompute) the
  least urgent holder.  Decode reads K/V through the block table: the
  gathered logical view has the width, mask and values of the contiguous
  cache, so the two generate the same tokens.
* ``"contiguous"``: the dense per-slot ``[L, B, S_max, ...]`` cache (the
  equality-gate baseline).

Speculative decoding (``speculator``, paged only): a draft model proposes
and this model verifies, each step between prefill and plain decode
(``serving.speculative``).

The reference jits per prompt length; the port runs eagerly.  The model's
functions update the KV caches in place.  A cluster steal of a
partially-prefilled request carries its processed KV blocks: the victim
gathers them off its pool into device tensors, and the thief writes them
into blocks of its own and resumes at the chunk boundary.

A model whose trunk carries a recurrent state (the hybrid's Mamba conv and
ssm states: ``Model.init_chunk_state``) prefills in chunks too: a request
in mid-prefill holds a staged state on the device, apart from the decode
rows (decode writes the states of every row, free ones included), which
each chunk carries on in place and the last commits to the request's
decode slot.  It is dropped wherever the request's blocks are released
(finish, prune, preemption, steal), so a resumed prefill restarts from
chunk 0; ``io_stats`` counts ``mamba_states_staged``,
``mamba_states_committed`` and the bytes staged now,
``mamba_staged_bytes``.  Such a model takes no prefix cache.  Where the
model keeps counters of its own work (``Model.counters``), the paged
engine adds to ``io_stats`` what they moved by over each chunk and decode
call: the hybrid's ``mamba_layer_tokens`` (rows x steps its Mamba layers
ran: chunk tokens and decoded rows, every slot of a decode call, times the
Mamba layers) and ``mamba_kernel_tokens`` (those of them the Mamba
kernels took).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..core.device.request_scheduler import (AdmissionRejected, BatchPlan,
                                             ContinuousBatcher, Request,
                                             RequestState)
from ..core.strategy import MergePolicy
from ..models.model_zoo import Model
from .paged_kv import (BlockAllocator, PoolExhausted, SINK_BLOCK,
                       prefix_block_keys)
from .speculative import Speculator

__all__ = ["ServingEngine"]


def _nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


class ServingEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 s_max: int = 128, prefill_token_budget: int = 512,
                 batch_axis: int = 1, eos_token: Optional[int] = None,
                 merge_policy: Optional[MergePolicy] = None,
                 kv_mode: str = "auto", block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 admission: str = "strategy",
                 prefix_cache: bool = False,
                 overflow: str = "reject",
                 speculator: Optional[Speculator] = None):
        if kv_mode not in ("auto", "paged", "contiguous"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        if overflow not in ("reject", "truncate", "allow"):
            raise ValueError(f"unknown overflow policy {overflow!r}")
        if kv_mode == "paged" and not model.supports_paged:
            raise ValueError(
                f"family {model.cfg.family!r} has no paged decode path")
        if kv_mode == "auto":
            kv_mode = "paged" if model.supports_paged else "contiguous"
        self.model = model
        self.params = params
        self.device = model.device
        self.s_max = s_max
        self.batch_axis = batch_axis
        self.eos = eos_token
        self.kv_mode = kv_mode
        self.paged = kv_mode == "paged"
        # chunked prefill only where the model has a chunk path
        chunk = prefill_chunk if (self.paged and
                                  model.prefill_chunk_paged is not None) \
            else None
        self.batcher = ContinuousBatcher(
            max_batch=max_batch, prefill_token_budget=prefill_token_budget,
            merge_policy=merge_policy, prefill_chunk=chunk,
            admission=admission)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int64)
        #: last emitted token per slot, kept on the host and uploaded once
        #: per decode step
        self.last_token = np.zeros((max_batch, 1), np.int64)
        self.outputs: Dict[int, List[int]] = {}
        self.prompts: Dict[int, np.ndarray] = {}
        #: prefill requests of the CURRENT plan not yet executed: popped out
        #: of the waiting storage, so the preemption victim scan must see
        #: them separately
        self._pending_prefill: List[Request] = []
        self._prefill = lambda p, b: model.prefill(p, b, s_max)
        self._prefill_chunk = None
        cfg = model.cfg
        #: ring capacity of the KV cache (window-clamped)
        self.cap = s_max if cfg.sliding_window is None \
            else min(s_max, cfg.sliding_window)
        # A full-attention ring cannot evict: a request whose prompt +
        # budget exceeds the capacity wraps and corrupts its own earliest KV.
        self.overflow = overflow
        self._enforce_fit = (cfg.sliding_window is None
                             and cfg.family != "ssm"
                             and overflow != "allow")
        # Prefix caching shares immutable full prompt blocks between
        # requests; it needs the chunk path to resume behind an adopted
        # prefix.
        self.prefix_cache = bool(prefix_cache and kv_mode == "paged"
                                 and model.supports_prefix_cache)
        self._keys: Dict[int, list] = {}     # rid -> chained block keys
        self.cache_stats = {"hit_tokens": 0, "miss_tokens": 0,
                            "hit_requests": 0, "lookup_requests": 0}
        #: host-device traffic of the steps: blocking host-to-device copies
        #: and their bytes, device-to-host reads of sampled tokens, and per
        #: decode step the KV tokens live in its rows
        #: (sum of min(pos + 1, cap)) against the width its logical view
        #: spans (``max_batch * cap``)
        self.io_stats = {"h2d_copies": 0, "h2d_bytes": 0, "d2h_reads": 0,
                         "kv_live_tokens": 0, "kv_view_tokens": 0}
        #: a chunk-prefilled request's carried state, by rid, from its
        #: first chunk until its last commits it to its decode slot
        self._staged: Dict[int, Any] = {}
        self._init_state = self._commit_state = None
        if self.paged and model.init_chunk_state is not None:
            self._init_state = model.init_chunk_state
            self._commit_state = model.commit_chunk_state
            self.io_stats.update(mamba_states_staged=0,
                                 mamba_states_committed=0,
                                 mamba_staged_bytes=0)
        self._counters = model.counters if self.paged else None
        if self._counters is not None:
            self.io_stats.update(dict.fromkeys(self._counters(), 0))
        #: rids whose current prefill cycle already hit the stats
        self._stat_seen: set = set()
        #: (token_bytes, keys) memo keyed by content
        self._hash_memo: Optional[Tuple[bytes, list]] = None
        if self.paged:
            if self.cap % block_size:
                raise ValueError(f"KV capacity {self.cap} not divisible by "
                                 f"block_size {block_size}")
            self.block_size = block_size
            self.max_blocks = self.cap // block_size
            if num_blocks is None:
                # same physical memory as the dense cache (+ the sink)
                num_blocks = max_batch * self.max_blocks + 1
            if num_blocks < self.max_blocks + 1:
                raise ValueError("pool smaller than one full ring: "
                                 f"{num_blocks - 1} < {self.max_blocks}")
            self.alloc = BlockAllocator(num_blocks, block_size)
            self.cache = model.init_paged_cache(max_batch, num_blocks,
                                                block_size)
            self.table = np.full((max_batch, self.max_blocks), SINK_BLOCK,
                                 np.int32)
            # device-side table: re-uploaded only when the allocator or a
            # slot assignment changed (most decode steps change neither)
            self._table_dev = torch.as_tensor(self.table, device=self.device)
            self._alloc_seen = self.alloc.version
            self._table_dirty = False
            self._decode = model.decode_step_paged
            self._insert_prefill = model.insert_prefill_paged
            self._prefill_chunk = model.prefill_chunk_paged

            # prompts longer than the ring must take the ring-aligning
            # dense prefill (chunks would wrap mid-prompt)
            def _chunk_eligible(r):
                return r.prompt_len + 1 <= self.cap
            self.batcher.chunk_eligible = _chunk_eligible
            self.batcher.on_request_pruned = self._on_pruned
        else:
            self.cache = model.init_cache(max_batch, s_max)
            self._decode = model.decode_step
            self._insert = model.insert_prefill
        # speculative decoding: a draft model proposes, this model verifies
        # (attach validates the pairing: paged target, matching vocab)
        self.speculator = speculator
        if speculator is not None:
            speculator.attach(self)

    # -- client API ----------------------------------------------------------
    def _fit_or_raise(self, prompt_len: int, max_new: int,
                      can_reject: bool, generated: int = 0) -> int:
        """Capacity admission check: the prompt plus the *remaining* token
        budget must fit the KV ring.  Returns the (possibly truncated) token
        budget; raises on reject."""
        if not self._enforce_fit \
                or prompt_len + max_new - generated <= self.cap:
            return max_new
        if self.overflow == "reject" and can_reject:
            self.batcher.metrics["rejected"] += 1
            raise AdmissionRejected(
                f"prompt_len + remaining budget = "
                f"{prompt_len + max_new - generated} exceeds KV capacity "
                f"{self.cap}: the ring would wrap and corrupt the prompt's "
                "own earliest blocks (use overflow='truncate'/'allow' to "
                "override)")
        if prompt_len + 1 > self.cap:
            if can_reject:
                self.batcher.metrics["rejected"] += 1
                raise AdmissionRejected(
                    f"prompt of {prompt_len} tokens exceeds KV capacity "
                    f"{self.cap}")
            self.batcher.metrics["wrapped_oversize"] += 1
            return max_new
        self.batcher.metrics["truncated"] += 1
        return generated + (self.cap - prompt_len)

    def _adoptable_keys(self, req: Request) -> list:
        """The prompt's adoptable chain, capped one token short of the
        prompt (the final token is always prefilled for the first logits)."""
        keys = self._keys.get(req.rid, [])
        return keys[:(req.prompt_len - 1) // self.block_size]

    def _probe_prefix(self, req: Request, tokens) -> None:
        """Record how much of the prompt the local prefix cache covers."""
        if not self.prefix_cache:
            return
        self._keys[req.rid] = self._prompt_keys(tokens)
        if req.prefilled == 0:
            req.cached_prefix = \
                self.alloc.match_prefix(self._adoptable_keys(req)) \
                * self.block_size

    def submit(self, tokens: np.ndarray, max_new_tokens: int,
               priority: float = 1.0,
               deadline: Optional[float] = None) -> Request:
        if len(tokens) == 0:
            raise ValueError("empty prompt")
        max_new_tokens = self._fit_or_raise(len(tokens), max_new_tokens,
                                            can_reject=True)
        req = Request(prompt_len=len(tokens), max_new_tokens=max_new_tokens,
                      priority=priority, deadline=deadline)
        self.prompts[req.rid] = np.asarray(tokens, np.int32)
        self.outputs[req.rid] = []
        self._probe_prefix(req, tokens)
        self.batcher.submit(req)
        return req

    def submit_request(self, req: Request, payload: Any = None,
                       migrated: bool = False) -> None:
        """Register an externally-created request (cluster router placement
        or, with ``migrated=True``, a steal migration from another
        replica).  ``payload`` is the prompt tokens, or a dict
        ``{"tokens": ..., "kv": (k, v), "outputs": [...]}`` when a
        partially-prefilled (or previously preempted) request migrates with
        its processed KV blocks and the tokens it already emitted.  The
        prefix KV is adopted into this pool where it fits; otherwise (a
        victim ring larger than ours, another block size, a pool that
        cannot allocate) the prefix is recomputed.  A first placement that
        cannot fit is rejected like a direct ``submit``; a migrated request
        was already accepted by the cluster, so it is truncated rather than
        bounced."""
        kv = None
        outputs: List[int] = []
        if isinstance(payload, dict):
            tokens = payload["tokens"]
            kv = payload.get("kv")
            outputs = list(payload.get("outputs", []))
        else:
            tokens = payload
        if tokens is None or len(tokens) == 0:
            raise ValueError("empty prompt")
        req.max_new_tokens = self._fit_or_raise(
            len(tokens), req.max_new_tokens, can_reject=not migrated,
            generated=req.generated)
        if req.state is not RequestState.WAITING:
            req.state = RequestState.WAITING
        self.prompts[req.rid] = np.asarray(tokens, np.int32)
        self.outputs[req.rid] = outputs or self.outputs.get(req.rid, [])
        if req.prefilled > 0 and not (self.paged and kv is not None
                                      and self._import_kv(req, kv)):
            req.prefilled = 0               # recompute the prefix
        # cache affinity does not travel: re-probe against our pool
        req.cached_prefix = 0
        self._probe_prefix(req, tokens)
        self.batcher.submit(req)

    def export_waiting(self, target_weight: Optional[int] = None,
                       count: Optional[int] = None):
        """Yield waiting requests (with their prompt tokens) to a thief.
        Partially-prefilled chunk requests migrate with their processed KV
        blocks (copied out of the pool via their block table), so the thief
        resumes at the chunk boundary instead of recomputing."""
        if target_weight is not None:
            stolen = self.batcher.steal_waiting(target_weight)
        else:
            stolen = self.batcher.steal_waiting_count(count or 0)
        out = []
        for r in stolen:
            payload: Dict[str, Any] = {"tokens": self.prompts.pop(r.rid)}
            self._keys.pop(r.rid, None)
            if self.paged and r.prefilled > 0:
                kv = self._export_kv(r)
                if kv is not None:
                    payload["kv"] = kv
                else:
                    # the blocks were already reclaimed: the thief restarts
                    # from chunk 0, and the work estimate must say so
                    r.prefilled = 0
            r.cached_prefix = 0              # affinity does not travel
            emitted = self.outputs.pop(r.rid, None)
            if emitted:
                payload["outputs"] = emitted
            self._release(r.rid)
            out.append((r, payload if len(payload) > 1
                        else payload["tokens"]))
        return out

    # -- paged-pool bookkeeping ----------------------------------------------
    def _release(self, rid: int) -> None:
        if self.paged:
            self.alloc.release(rid)
        if self.speculator is not None:
            self.speculator.drop_request(rid)
        self._stat_seen.discard(rid)
        self._keys.pop(rid, None)
        if self._staged:
            self._drop_state(rid)

    # -- a chunk-prefilled request's carried state ---------------------------
    def _drop_state(self, rid: int) -> None:
        st = self._staged.pop(rid, None)
        if st is not None:
            self.io_stats["mamba_staged_bytes"] -= _nbytes(st)

    def _chunk_state(self, req: Request):
        """The state ``req``'s next chunk starts from: a fresh (zero) one at
        its first chunk, else the one its previous chunk left."""
        if req.prefilled == 0:
            self._drop_state(req.rid)
            st = self._staged[req.rid] = self._init_state()
            self.io_stats["mamba_states_staged"] += 1
            self.io_stats["mamba_staged_bytes"] += _nbytes(st)
            return st
        return self._staged[req.rid]

    def _counted(self, fn, *args):
        """``fn(*args)``, a paged chunk or decode call, with what it moved
        the model's counters by added to ``io_stats``."""
        if self._counters is None:
            return fn(*args)
        before = self._counters()
        out = fn(*args)
        for k, n in self._counters().items():
            self.io_stats[k] += n - before[k]
        return out

    def _commit_chunk_state(self, rid: int, slot: int) -> None:
        st = self._staged.get(rid) if self._staged else None
        if st is None:
            return
        self.cache = self._commit_state(self.cache, st, slot)
        self._drop_state(rid)
        self.io_stats["mamba_states_committed"] += 1

    def _prompt_keys(self, tokens) -> list:
        """Chained block keys of ``tokens``, memoized on token content."""
        raw = np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
        memo = self._hash_memo
        if memo is not None and memo[0] == raw:
            return memo[1]
        keys = prefix_block_keys(tokens, self.block_size)
        self._hash_memo = (raw, keys)
        return keys

    def prefix_match(self, tokens) -> int:
        """Tokens of ``tokens``'s prefix this replica's cache already holds."""
        if not self.prefix_cache:
            return 0
        return self.alloc.match_prefix(self._prompt_keys(tokens)) \
            * self.block_size

    def cache_hit_rate(self) -> float:
        s = self.cache_stats
        total = s["hit_tokens"] + s["miss_tokens"]
        return s["hit_tokens"] / total if total else 0.0

    def _on_pruned(self, req: Request) -> None:
        """Batcher pruned a dead waiting request: free its blocks."""
        self._release(req.rid)

    def _export_kv(self, req: Request
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The request's processed prefix blocks, ``(k, v)`` of
        [L, blocks, block_size, kvH, hd] on this pool's device.
        ``index_select`` copies, so the victim's blocks can be reused as
        soon as the request is released.  None for a hybrid pool (its Mamba
        states cannot travel: the thief restarts from chunk 0)."""
        if not hasattr(self.cache, "k"):
            return None
        blocks = self.alloc.blocks_of(req.rid)
        need = self.alloc.blocks_for_tokens(req.prefilled)
        if len(blocks) < need:
            return None
        idx = self._upload(np.asarray(blocks[:need], np.int64))
        return (self.cache.k.index_select(1, idx),
                self.cache.v.index_select(1, idx))

    def _import_kv(self, req: Request, kv) -> bool:
        """Write a migrated prefix into fresh blocks of this pool, in place.
        False (recompute) when it cannot resume chunk-aligned here."""
        if not hasattr(self.cache, "k"):
            return False
        k, v = kv
        nblk = k.shape[1]
        if nblk > self.max_blocks or req.prompt_len + 1 > self.cap:
            # victim had a larger ring than ours
            return False
        if k.shape[2] != self.block_size or \
                not self.alloc.can_allocate(nblk * self.block_size,
                                            req.rid):
            return False                     # thief pool full: recompute
        self.alloc.ensure(req.rid, nblk * self.block_size)
        idx = self._upload(np.asarray(self.alloc.blocks_of(req.rid)[:nblk],
                                      np.int64))
        self.cache.k.index_copy_(1, idx, k)
        self.cache.v.index_copy_(1, idx, v)
        return True

    def _table_row(self, rid: int) -> np.ndarray:
        return self.alloc.table_row(rid, self.max_blocks)

    def _row_dev(self, rid: int) -> torch.Tensor:
        return self._upload(self._table_row(rid))

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """``x`` on the device: a blocking copy from pageable host memory,
        which waits for the work already queued on the stream."""
        with trace.span("engine.upload", bytes=x.nbytes):
            out = torch.as_tensor(x, device=self.device)
        self.io_stats["h2d_copies"] += 1
        self.io_stats["h2d_bytes"] += x.nbytes
        return out

    def _ensure_blocks(self, req: Request, tokens: int) -> bool:
        """Grow ``req``'s block table to cover ``tokens`` logical tokens,
        preempting less-urgent holders under pool pressure.  False when the
        pool cannot serve even after preemption (caller defers)."""
        tokens = min(tokens, self.cap)
        while True:
            try:
                self.alloc.ensure(req.rid, tokens)
                return True
            except PoolExhausted:
                if not self._preempt_for(req):
                    return False

    @staticmethod
    def _urgency(r: Request) -> tuple:
        """Total order: smaller = more urgent (rid breaks exact ties)."""
        return (r.priority, r.arrival, r.rid)

    def _preempt_for(self, req: Request) -> bool:
        """Free blocks by recompute-preempting a STRICTLY less urgent
        holder: waiting chunk-holders first, then chunk-holders planned
        later in this step, then running requests.  Never preempts ``req``
        itself or anything more urgent."""
        mine = self._urgency(req)
        holders = [r for r in self.batcher.waiting_requests()
                   if r.rid != req.rid and self.alloc.blocks_of(r.rid)
                   and self._urgency(r) > mine]
        if holders:
            victim = max(holders, key=self._urgency)   # least urgent first
            if self.batcher.preempt_waiting(victim):
                self._release(victim.rid)
                self._probe_prefix(victim, self.prompts[victim.rid])
                return True
        planned = [r for r in self._pending_prefill
                   if r.rid != req.rid and self.alloc.blocks_of(r.rid)
                   and self._urgency(r) > mine]
        if planned:
            victim = max(planned, key=self._urgency)
            victim.prefilled = 0
            self._release(victim.rid)
            self._probe_prefix(victim, self.prompts[victim.rid])
            self.batcher.metrics["preempted"] += 1
            return True
        actives = [r for r in self.slot_req
                   if r is not None and r.rid != req.rid
                   and self._urgency(r) > mine]
        if actives:
            victim = max(actives, key=self._urgency)
            self._preempt_running(victim)
            return True
        return False

    def _preempt_running(self, req: Request) -> None:
        """Recompute preemption of a decoding request: fold its generated
        tokens into the prompt, drop its KV, requeue it."""
        self._clear_slot(req)
        out = self.outputs.get(req.rid, [])
        if out:
            self.prompts[req.rid] = np.concatenate(
                [self.prompts[req.rid], np.asarray(out, np.int32)])
            req.prompt_len = len(self.prompts[req.rid])
        self._release(req.rid)
        self._probe_prefix(req, self.prompts[req.rid])
        self.batcher.preempt(req)

    def _copy_block(self, old: int, new: int) -> None:
        self.cache.k[:, new] = self.cache.k[:, old]
        self.cache.v[:, new] = self.cache.v[:, old]

    def _cow_for_write(self, req: Request, slot: int) -> bool:
        """Decode is about to write at ``slot``'s ring position.  A block
        shared with another table is copy-on-write forked (its pool rows
        duplicated) first.  False when a fork is needed but the pool is
        starved even after preemption."""
        j = (int(self.slot_pos[slot]) % self.cap) // self.block_size
        while True:
            try:
                fork = self.alloc.prepare_write(req.rid, j)
                break
            except PoolExhausted:
                if not self._preempt_for(req):
                    return False
        if fork is not None:
            self._copy_block(*fork)
            self._table_dirty = True
        return True

    # -- speculative decoding primitives --------------------------------------
    def _spec_reserve(self, req: Request, slot: int, k: int) -> bool:
        """Reserve KV for one speculation round of ``slot``: blocks to
        cover positions ``[0, pos + k + 1)`` plus COW forks of every block
        the verify write range ``[pos, pos + k]`` touches, so a rejected
        draft can never land in a published/shared prefix block.  Strictly
        opportunistic: NO preemption; on pool exhaustion the growth is
        rolled back (``truncate``) and the round is shed."""
        pos = int(self.slot_pos[slot])
        if pos + k + 1 > self.cap:
            return False                 # verify's no-wrap contract
        before = self.alloc.allocated_tokens(req.rid)
        try:
            self.alloc.ensure(req.rid, pos + k + 1)
        except PoolExhausted:
            return False
        bs = self.block_size
        for j in range(pos // bs, (pos + k) // bs + 1):
            try:
                fork = self.alloc.prepare_write(req.rid, j)
            except PoolExhausted:
                self.alloc.truncate(req.rid, max(pos + 1, before))
                return False
            if fork is not None:
                self._copy_block(*fork)
                self._table_dirty = True
        return True

    def _apply_accepted(self, slot: int, accepted: List[int]
                        ) -> Tuple[int, bool]:
        """Commit a verify round's accepted tokens to ``slot`` exactly as
        sequential decode steps would (EOS / budget checked per token), then
        roll the block table back to the committed length: rejected draft
        blocks return to the pool, published prefix blocks are untouched.
        Returns ``(tokens_applied, finished)``."""
        req = self.slot_req[slot]
        applied = 0
        finished = False
        for tok in accepted:
            self.outputs[req.rid].append(tok)
            applied += 1
            self.batcher.complete_decode([req])
            if (self.eos is not None and tok == self.eos) or \
                    req.generated >= req.max_new_tokens:
                finished = True
                break
        self.slot_pos[slot] += applied
        self.last_token[slot, 0] = accepted[applied - 1]
        if finished:
            req.state = RequestState.DONE
            req.finished_at = time.monotonic()
            self._clear_slot(req)
            self._release(req.rid)
        else:
            # stale KV past this point stays in the kept tail block but is
            # overwritten before any mask exposes it; whole stale blocks go
            # back to the pool
            self.alloc.truncate(req.rid, int(self.slot_pos[slot]))
        return applied, finished

    @property
    def spec_stats(self) -> Dict[str, Any]:
        """Speculation counters."""
        m = self.batcher.metrics
        drafted = m.get("spec_drafted", 0)
        accepted = m.get("spec_accepted", 0)
        return {
            "enabled": self.speculator is not None,
            "rounds": m.get("spec_rounds", 0),
            "drafted": drafted,
            "accepted": accepted,
            "wasted": m.get("spec_wasted", 0),
            "shed": m.get("spec_shed", 0),
            "merged_drafts": m.get("spec_merged_drafts", 0),
            "verify_calls": m.get("spec_verify_calls", 0),
            "warms": m.get("spec_warms", 0),
            "acceptance_rate": accepted / drafted if drafted else 0.0,
        }

    # -- engine loop ----------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _clear_slot(self, req: Request) -> None:
        for i, r in enumerate(self.slot_req):
            if r is req:
                self.slot_req[i] = None
                if self.paged:
                    self.table[i, :] = SINK_BLOCK
                    self._table_dirty = True
                if self.speculator is not None:
                    # in-flight speculation dies with the slot: a preempted
                    # request resumes non-speculatively
                    self.speculator.on_clear(i)

    def _insert_contiguous(self, slot: int, cache_one) -> None:
        if self._insert is not None:
            # per-leaf batch axes (hybrid: KV axis 1, Mamba states axis 2)
            self.cache = self._insert(self.cache, cache_one, slot)
            return
        ax = self.batch_axis
        for full, one in zip(self.cache, cache_one):
            idx = [slice(None)] * full.ndim
            idx[ax] = slice(slot, slot + 1)
            full[tuple(idx)] = one.to(full.dtype)

    def _take_slot(self, slot: int, req: Request, last_tok: int,
                   pos: int) -> None:
        self.slot_req[slot] = req
        self.slot_pos[slot] = pos
        self.last_token[slot, 0] = last_tok
        if self.paged:
            self.table[slot] = self._table_row(req.rid)
            self._table_dirty = True

    def _requeue(self, req: Request) -> bool:
        """Back to the waiting storage (lost slot / pool full); progress is
        kept."""
        req.state = RequestState.WAITING
        self.batcher.submit(req)
        return False

    def _adopt_cached_prefix(self, req: Request) -> None:
        """Start a cold prefill by adopting the longest published chain of
        the prompt's full blocks."""
        rid = req.rid
        if not (self.prefix_cache and req.prefilled == 0
                and self.batcher.chunk_eligible(req)
                and not self.alloc.blocks_of(rid)):
            return
        adopted = self.alloc.adopt_prefix(rid, self._adoptable_keys(req))
        req.prefilled = adopted * self.block_size
        req.cached_prefix = req.prefilled
        if rid in self._stat_seen:
            return                 # requeued retry: already counted
        self._stat_seen.add(rid)
        if adopted:
            self.cache_stats["hit_tokens"] += req.prefilled
            self.cache_stats["hit_requests"] += 1
        self.cache_stats["lookup_requests"] += 1
        self.cache_stats["miss_tokens"] += req.prompt_len - req.prefilled

    def _run_prefill(self, req: Request, chunk: int) -> bool:
        """Execute one planned prefill chunk.  Returns False when the
        request had to be requeued (no slot / no memory)."""
        rid = req.rid
        self._adopt_cached_prefix(req)
        chunk = min(chunk, req.remaining_prefill)
        whole = req.prefilled == 0 and chunk == req.prompt_len
        chunked = (self._prefill_chunk is not None
                   and self.batcher.chunk_eligible(req)
                   and not (whole and self.batcher.prefill_chunk is None))
        if not chunked:
            # whole-prompt (ring-aligning) dense prefill path
            chunk = req.remaining_prefill
        final = not chunked or req.prefilled + chunk >= req.prompt_len
        slot = None
        if final:
            slot = self._free_slot()
            if slot is None:
                return self._requeue(req)          # lost its slot
        if self.paged:
            need = req.prefilled + chunk if chunked else req.prompt_len
            if not self._ensure_blocks(req, need):
                return self._requeue(req)          # pool full; retry later
        if chunked:
            start = req.prefilled
            toks = self.prompts[rid][start:start + chunk]
            batch = {"tokens": self._upload(toks[None, :].astype(np.int64))}
            if self._init_state is not None:
                batch["mamba_state"] = self._chunk_state(req)
            logits, self.cache = self._counted(
                self._prefill_chunk, self.params, batch, self.cache,
                self._row_dev(rid), start)
        else:
            toks = self._upload(self.prompts[rid][None, :].astype(np.int64))
            logits, cache_one = self._prefill(self.params, {"tokens": toks})
            if self.paged:
                # scatter the dense per-request cache into its blocks
                self.cache = self._insert_prefill(self.cache, cache_one,
                                                  self._row_dev(rid), slot)
            else:
                self._insert_contiguous(slot, cache_one)
        done = self.batcher.complete_prefill_chunk(req, chunk)
        if done:
            if self.prefix_cache and self.batcher.chunk_eligible(req):
                # every full prompt block is now written: publish the chain
                self.alloc.publish_prefix(rid, self._keys.get(rid, []))
            with trace.span("engine.read"):
                nxt = int(torch.argmax(logits[0, -1]))
            self.io_stats["d2h_reads"] += 1
            self.outputs[rid].append(nxt)
            req.generated += 1
            if (self.eos is not None and nxt == self.eos) or \
                    req.generated >= req.max_new_tokens:
                # finished at prefill: never takes a decode slot
                req.state = RequestState.DONE
                req.finished_at = time.monotonic()
                self.batcher.finish_running(req)
                self._release(rid)
                return True
            self._commit_chunk_state(rid, slot)
            self._take_slot(slot, req, nxt, req.prompt_len)
        return True

    def step(self) -> int:
        """One engine step: evict, admit+prefill (possibly chunked),
        speculate, decode.  Returns the number of slots stepped (plain and
        speculative)."""
        with trace.span("engine.step") as attrs:
            with trace.span("engine.plan"):
                plan: BatchPlan = self.batcher.plan_step()
            for req in plan.evicted:
                self._clear_slot(req)
                self._release(req.rid)
            self._pending_prefill = list(plan.prefill)
            prefill_tokens = 0
            for req in plan.prefill:
                self._pending_prefill.remove(req)
                chunk = plan.prefill_chunks.get(req.rid, req.remaining_prefill)
                planned = min(chunk, req.remaining_prefill)
                prefill_tokens += planned
                with trace.span("engine.prefill", rid=req.rid,
                                start=req.prefilled, tokens=planned):
                    self._run_prefill(req, chunk)
            # speculation round first: handled slots emit their tokens
            # through draft/verify and skip plain decode this step
            handled: set = set()
            if self.speculator is not None:
                handled = self.speculator.round(self)
            # decode every occupied slot at its OWN position (continuous
            # batching mixes depths)
            active = [i for i, r in enumerate(self.slot_req)
                      if r is not None and i not in handled]
            if self.paged:
                with trace.span("engine.kv_blocks"):
                    # the next write position may cross into a new block
                    for i in list(active):
                        req = self.slot_req[i]
                        if req is None:
                            continue    # preempted by an earlier iteration
                        if not self._ensure_blocks(
                                req, int(self.slot_pos[i]) % self.cap + 1):
                            self._preempt_running(req)  # pool starved
                        elif self.prefix_cache and \
                                not self._cow_for_write(req, i):
                            self._preempt_running(req)  # fork, pool starved
                    active = [i for i, r in enumerate(self.slot_req)
                              if r is not None and i not in handled]
            if active:
                self._decode_active(active)
            if attrs is not None:
                attrs.update(decoded=len(active),
                             prefill_tokens=prefill_tokens)
        return len(active) + len(handled)

    def _decode_active(self, active: List[int]) -> None:
        """One decode step of the ``active`` slots: upload their positions
        and last tokens (and the block table when it moved), run the model,
        read the argmax back and emit it."""
        pos_vec = self._upload(self.slot_pos)
        tokens = self._upload(self.last_token)
        if self.paged:
            # refresh + re-upload the table only when something moved
            if self._table_dirty or self._alloc_seen != self.alloc.version:
                for i in active:
                    self.table[i] = self._table_row(self.slot_req[i].rid)
                self._table_dev = self._upload(self.table)
                self._alloc_seen = self.alloc.version
                self._table_dirty = False
            io = self.io_stats
            io["kv_live_tokens"] += int(np.minimum(
                self.slot_pos[active] + 1, self.cap).sum())
            io["kv_view_tokens"] += len(self.slot_req) * self.cap
            logits, self.cache = self._counted(
                self._decode, self.params, tokens, self.cache,
                self._table_dev, pos_vec)
        else:
            logits, self.cache = self._decode(
                self.params, tokens, self.cache, pos_vec)
        with trace.span("engine.read"):
            nxt = torch.argmax(logits[:, -1], dim=-1).tolist()
        self.io_stats["d2h_reads"] += 1
        with trace.span("engine.emit"):
            for i in active:
                req = self.slot_req[i]
                tok = nxt[i]
                self.outputs[req.rid].append(tok)
                self.slot_pos[i] += 1
                self.last_token[i, 0] = tok
                self.batcher.complete_decode([req])
                if (self.eos is not None and tok == self.eos) or \
                        req.generated >= req.max_new_tokens:
                    req.state = RequestState.DONE
                    req.finished_at = time.monotonic()
                    self._clear_slot(req)
                    self._release(req.rid)

    def run_until_drained(self, max_steps: int = 10_000
                          ) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            busy = any(r is not None for r in self.slot_req)
            if not busy and self.batcher.waiting_count == 0 \
                    and not self.batcher.running:
                break
        return self.outputs
