# Copied from src/repro/core/metrics.py; only the imports may differ.
"""Scheduler counters — the work metrics the paper's evaluation relies on
(steal counts, queue churn, call-conversion counts, dead-task pruning).

Hot-path design: the scheduler used to take one global lock per
execute/spawn/steal just to bump a counter.  Counters are now sharded —
each worker owns a private, *unlocked* :class:`WorkerMetrics` it bumps with
plain attribute arithmetic (single-writer, so no lock is needed; CPython's
int stores are atomic enough for monotone counters) — and
:class:`SchedulerMetrics` aggregates the shards on demand.  ``add()`` is
kept for code running outside a worker thread (it targets a locked base
shard), so the external API (``snapshot()``, attribute reads,
``queue_churn``) is unchanged.
"""
from __future__ import annotations

import threading
from typing import List

#: every counter field, in snapshot order.  ``max_queue_len`` aggregates by
#: max, everything else by sum.
COUNTER_FIELDS = (
    "spawns",            # tasks put into task storage (chunks count as 1)
    "calls_converted",   # spawns executed inline (spawn-to-call)
    "merge_chunks",      # chunk tasks created by spawn_many
    "tasks_merged",      # spawns coalesced into those chunks
    "tasks_executed",
    "steals",            # successful steal transactions
    "tasks_stolen",
    "weight_stolen",
    "steal_attempts",    # including failed ones
    "dead_pruned",
    "max_queue_len",
)


class WorkerMetrics:
    """One worker's private counter shard.  Never locked: exactly one
    thread writes it; readers (``snapshot``) tolerate being one bump
    behind."""

    __slots__ = COUNTER_FIELDS

    def __init__(self):
        for f in COUNTER_FIELDS:
            setattr(self, f, 0)

    def observe_queue_len(self, n: int) -> None:
        if n > self.max_queue_len:
            self.max_queue_len = n


class SchedulerMetrics:
    """Aggregating facade over per-worker shards plus one locked base shard
    for callers outside a worker thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._base = WorkerMetrics()
        self._shards: List[WorkerMetrics] = []

    # -- shard management (scheduler-internal) ------------------------------
    def register_worker(self) -> WorkerMetrics:
        """Create and return a new unlocked shard owned by one worker."""
        shard = WorkerMetrics()
        with self._lock:
            self._shards.append(shard)
        return shard

    # -- legacy write API (non-worker contexts, tests) ----------------------
    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self._base, k, getattr(self._base, k) + v)

    def observe_queue_len(self, n: int) -> None:
        self._base.observe_queue_len(n)

    # -- read API ------------------------------------------------------------
    def snapshot(self) -> dict:
        shards = [self._base] + self._shards
        out = {}
        for f in COUNTER_FIELDS:
            if f == "max_queue_len":
                out[f] = max(getattr(s, f) for s in shards)
            else:
                out[f] = sum(getattr(s, f) for s in shards)
        return out

    def __getattr__(self, name: str):
        # Aggregated attribute reads (``metrics.steals``).  Only fires for
        # names not found on the instance, so the hot paths are unaffected.
        if name in COUNTER_FIELDS:
            shards = [self._base] + self._shards
            if name == "max_queue_len":
                return max(getattr(s, name) for s in shards)
            return sum(getattr(s, name) for s in shards)
        raise AttributeError(name)

    @property
    def queue_churn(self) -> int:
        """Pushes+pops through task storage — what spawn-to-call and task
        merging remove."""
        return 2 * self.spawns

    def __repr__(self):  # pragma: no cover - debugging aid
        body = ", ".join(f"{k}={v}" for k, v in self.snapshot().items())
        return f"SchedulerMetrics({body})"
