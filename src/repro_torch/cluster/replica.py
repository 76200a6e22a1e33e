# Copied from src/repro/cluster/replica.py; only the imports may differ.
"""Replica interface: the unit the cluster router places work on and steals
work between.

Paper mapping — a replica is a *place*: it owns a strategy-ordered local
queue (its ``ContinuousBatcher``), exposes its transitive backlog weight for
steal-half-the-*work* decisions, and yields waiting requests to thieves.
``EngineReplica`` wraps a live ``ServingEngine`` (real model on CPU/TPU);
``cluster.sim.SimReplica`` implements the same interface with modeled
service times — the router's policy code cannot tell them apart.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..core.device.request_scheduler import Request

__all__ = ["Replica", "EngineReplica"]

#: a migrated unit: the request plus its payload — prompt tokens, or a dict
#: ``{"tokens": ..., "kv": (k, v)}`` when a partially-prefilled chunk
#: request migrates with its processed KV blocks (None in simulation)
StolenItem = Tuple[Request, Optional[Any]]


class Replica:
    """Abstract replica.  ``place`` indexes into the cluster's
    :class:`~repro.core.machine.MachineModel` for distance-aware victim
    ordering."""

    def __init__(self, replica_id: int, place: Optional[int] = None):
        self.replica_id = replica_id
        self.place = replica_id if place is None else place
        #: fail-stop flag: a dead replica drops everything in flight; the
        #: router replays its displaced requests elsewhere
        self.dead = False
        #: graceful scale-down: a draining replica takes no new work and
        #: leaves the fleet when its queue and slots empty
        self.draining = False

    def fail(self) -> None:
        """Fail-stop.  In simulation this drops pending completion events;
        a live wrapper stops stepping the engine."""
        self.dead = True

    # -- work accounting -----------------------------------------------------
    def backlog_weight(self) -> int:
        """Estimated outstanding work (waiting + running), in tokens."""
        raise NotImplementedError

    def waiting_weight(self) -> int:
        """Estimated work in the queue — the part a thief can migrate."""
        raise NotImplementedError

    def waiting_count(self) -> int:
        raise NotImplementedError

    def active_count(self) -> int:
        raise NotImplementedError

    def wants_work(self) -> bool:
        """True when this replica could start another request immediately —
        the thief condition for the router's steal loop."""
        raise NotImplementedError

    def prefix_match(self, req: Request,
                     tokens: Optional[Any] = None) -> int:
        """Prompt-prefix tokens this replica's KV cache already holds for
        ``req`` — the cache-affinity placement signal.  0 = cold replica
        (the default for replicas without a prefix cache)."""
        return 0

    def concurrency(self) -> int:
        """Decode slots this replica runs concurrently — the service-rate
        denominator the cost-model placement divides estimated work by."""
        return 1

    def speed_hint(self) -> float:
        """Relative service speed (1.0 = nominal).  Simulated replicas
        report their modeled speed; live fleets get measured speeds from
        the ``StragglerDetector`` instead, which overrides this hint."""
        return 1.0

    # -- request flow --------------------------------------------------------
    def submit(self, req: Request, tokens: Optional[Any] = None,
               migrated: bool = False) -> None:
        """``migrated=True`` marks a steal migration: the request was
        already accepted by the cluster, so a capacity shortfall truncates
        instead of rejecting."""
        raise NotImplementedError

    def steal_waiting(self, target_weight: int) -> List[StolenItem]:
        raise NotImplementedError

    def steal_waiting_count(self, n: int) -> List[StolenItem]:
        raise NotImplementedError

    def receive(self, stolen: List[StolenItem]) -> None:
        for req, tokens in stolen:
            self.submit(req, tokens, migrated=True)

    def take_spec(self, rid: int) -> Optional[Tuple[int, int]]:
        """Pop a finished request's ``(drafted, accepted)`` speculative-
        decoding totals, or None when the replica never speculated on it.
        The router collects this at finish time and feeds cluster telemetry
        (deduped by ``(origin, rid)`` like migrations)."""
        return None

    # -- health --------------------------------------------------------------
    def health(self) -> dict:
        return {"replica_id": self.replica_id, "place": self.place,
                "backlog_weight": self.backlog_weight(),
                "waiting": self.waiting_count(),
                "active": self.active_count()}


class EngineReplica(Replica):
    """A live serving replica: one ``ServingEngine`` (model + KV cache +
    continuous batcher).  Prompt tokens travel with stolen requests; under
    paged KV, a partially-prefilled request's processed blocks travel too
    (steal-half-work migrates the *unprocessed* chunks plus the prefix KV,
    so the thief resumes at the chunk boundary)."""

    def __init__(self, replica_id: int, engine,
                 place: Optional[int] = None):
        super().__init__(replica_id, place)
        self.engine = engine

    # -- work accounting -----------------------------------------------------
    def backlog_weight(self) -> int:
        return self.engine.batcher.backlog_weight()

    def waiting_weight(self) -> int:
        return self.engine.batcher.waiting_weight()

    def waiting_count(self) -> int:
        return self.engine.batcher.waiting_count

    def active_count(self) -> int:
        return sum(1 for r in self.engine.slot_req if r is not None)

    def free_slots(self) -> int:
        return sum(1 for r in self.engine.slot_req if r is None)

    def concurrency(self) -> int:
        return len(self.engine.slot_req)

    def wants_work(self) -> bool:
        return (not self.dead and not self.draining
                and self.waiting_count() == 0 and self.free_slots() > 0)

    def prefix_match(self, req: Request,
                     tokens: Optional[Any] = None) -> int:
        if tokens is None or not getattr(self.engine, "prefix_cache", False):
            return 0
        toks = tokens.get("tokens") if isinstance(tokens, dict) else tokens
        return self.engine.prefix_match(toks)

    # -- request flow --------------------------------------------------------
    def submit(self, req: Request, tokens: Optional[Any] = None,
               migrated: bool = False) -> None:
        if tokens is None:
            raise ValueError("EngineReplica.submit needs prompt tokens")
        self.engine.submit_request(req, tokens, migrated=migrated)

    def steal_waiting(self, target_weight: int) -> List[StolenItem]:
        # a killed engine cannot answer a steal RPC: between the kill and
        # the heartbeat declaring it dead, steals yield nothing and its
        # work waits for the crash-replay path
        if self.dead:
            return []
        return self.engine.export_waiting(target_weight=target_weight)

    def steal_waiting_count(self, n: int) -> List[StolenItem]:
        if self.dead:
            return []
        return self.engine.export_waiting(count=n)

    def take_spec(self, rid: int) -> Optional[Tuple[int, int]]:
        spec = getattr(self.engine, "speculator", None)
        return spec.take_record(rid) if spec is not None else None

    # -- health --------------------------------------------------------------
    def health(self) -> dict:
        h = super().health()
        if getattr(self.engine, "paged", False):
            h["free_kv_tokens"] = self.engine.alloc.free_tokens
            h["kv_requests"] = self.engine.alloc.num_requests
        if getattr(self.engine, "prefix_cache", False):
            h["cached_kv_tokens"] = self.engine.alloc.cached_tokens
            h["cache_hit_rate"] = self.engine.cache_hit_rate()
        if getattr(self.engine, "speculator", None) is not None:
            s = self.engine.spec_stats
            h["spec_acceptance_rate"] = s["acceptance_rate"]
            h["spec_rounds"] = s["rounds"]
        return h

    # -- engine loop ---------------------------------------------------------
    def step(self) -> int:
        # a killed engine stops responding: no steps, no heartbeats — the
        # router's HeartbeatMonitor declares it dead after the timeout
        if self.dead:
            return 0
        return self.engine.step()

    def drained(self) -> bool:
        return (not any(r is not None for r in self.engine.slot_req)
                and self.engine.batcher.waiting_count == 0
                and not self.engine.batcher.running)
