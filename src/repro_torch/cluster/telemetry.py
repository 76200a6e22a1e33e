# Copied from src/repro/cluster/telemetry.py; only the imports may differ.
"""Cluster telemetry: per-SLO-class latency histograms plus steal accounting.

Latencies go into log-spaced-bucket histograms (fixed memory per class no
matter how many samples the discrete-event simulator pushes), keyed by SLO
class (= the request's ``priority`` value).  The only per-request state is
the finish/migration dedup id sets (a few dozen MB at tens of millions of
requests).  Steal events record both migrated request *count* and migrated
*weight* — the distinction the steal-half-work vs steal-half-count
comparison turns on.  With chunked prefill a request can migrate more than
once (between chunks), so ``requests_migrated`` is deduped by migration key
(one request = one migrated request, however many of its chunks moved) —
and the key must be an ``(origin, rid)`` pair, not a bare rid: rids are
only unique per entry process, so two requests entering through different
replicas can carry the same rid and would alias (undercount) under
rid-only dedup; the router passes each request's *origin* (its
first-placement replica) alongside;
``chunk_migrations`` keeps the raw per-migration count.  ``summary()`` is
JSON-serializable and is what ``benchmarks/cluster_scale.py`` writes out.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LatencyHistogram", "ClusterTelemetry"]


class LatencyHistogram:
    """Log-bucketed histogram over (lo, hi] seconds; constant memory."""

    def __init__(self, lo: float = 1e-4, hi: float = 1e5,
                 buckets_per_decade: int = 48):
        self.lo = lo
        self.log_lo = math.log10(lo)
        self.scale = buckets_per_decade
        self.nbuckets = int(math.ceil((math.log10(hi) - self.log_lo)
                                      * buckets_per_decade)) + 2
        self.counts = np.zeros(self.nbuckets, np.int64)
        self.total = 0
        self.sum = 0.0
        self.max = 0.0

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        b = int((math.log10(v) - self.log_lo) * self.scale) + 1
        return min(b, self.nbuckets - 1)

    def record(self, v: float) -> None:
        self.counts[self._bucket(v)] += 1
        self.total += 1
        self.sum += v
        if v > self.max:
            self.max = v

    def merge(self, other: "LatencyHistogram") -> None:
        self.counts += other.counts
        self.total += other.total
        self.sum += other.sum
        self.max = max(self.max, other.max)

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile sample."""
        if self.total == 0:
            return 0.0
        rank = p / 100.0 * self.total
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, rank))
        return 10.0 ** (self.log_lo + (b / self.scale))

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0


class _ReplicaStats:
    __slots__ = ("finished", "tokens", "steals_out", "steals_in",
                 "requests_migrated_out", "weight_migrated_out",
                 "prefix_hit_tokens", "prefix_miss_tokens",
                 "spec_drafted", "spec_accepted")

    def __init__(self):
        self.finished = 0
        self.tokens = 0
        self.steals_out = 0
        self.steals_in = 0
        self.requests_migrated_out = 0
        self.weight_migrated_out = 0
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class ClusterTelemetry:
    """Shared sink for routers and replicas, live or simulated."""

    def __init__(self, num_replicas: int):
        self.per_class: Dict[float, LatencyHistogram] = {}
        self.ttft: Dict[float, LatencyHistogram] = {}
        self.replicas: List[_ReplicaStats] = [
            _ReplicaStats() for _ in range(num_replicas)]
        self.steal_events = 0
        #: unique requests (deduped by (origin, rid) migration key)
        self.requests_migrated = 0
        self.chunk_migrations = 0       # raw migrations (>= unique count)
        self.weight_migrated = 0
        self.cancelled = 0
        self.rejected = 0
        self.deadline_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_requests = 0
        #: running per-request acceptance-rate summary (constant memory)
        self._spec_rate_sum = 0.0
        self._spec_rate_min = 1.0
        self._spec_rate_max = 0.0
        self._seen: set = set()
        self._migrated: set = set()
        self._spec_seen: set = set()
        # -- chaos / recovery --------------------------------------------
        self.crashes = 0
        self.slowdowns = 0
        self.requests_replayed = 0
        #: per-crash recovery times: a crash opens a failure window over
        #: its displaced (origin, rid) set; the window closes — and the
        #: recovery time is recorded — when every displaced request has
        #: reached a terminal outcome (finished, cancelled or rejected)
        self._recoveries: List[float] = []
        self._active_failures: Dict[int, Tuple[float, set]] = {}
        self._crash_id = 0
        #: latency of every request that completes while at least one
        #: failure window is open — the p99-under-failure population
        self.under_failure = LatencyHistogram()
        # -- autoscale ----------------------------------------------------
        self.scale_ups = 0
        self.scale_downs = 0
        self.replicas_added = 0
        self.replicas_retired = 0
        self.replicas_peak = num_replicas
        self.alive_replicas = num_replicas   # maintained by the router
        #: membership event trace (crash/slowdown/scale), time-ordered —
        #: the seed-determinism test compares this verbatim
        self.events: List[dict] = []

    # -- recording -----------------------------------------------------------
    def _hist(self, table: Dict[float, LatencyHistogram],
              slo: float) -> LatencyHistogram:
        h = table.get(slo)
        if h is None:
            h = table[slo] = LatencyHistogram()
        return h

    def record_finish(self, req, now: float,
                      replica_id: Optional[int] = None,
                      origin: Optional[int] = None) -> None:
        """``origin`` (the request's entry replica) keys the dedup in
        multi-entry deployments, where bare rids can alias — same rule as
        :meth:`record_steal`."""
        key = (origin, req.rid)
        if key in self._seen:
            return
        self._seen.add(key)
        self._hist(self.per_class, req.priority).record(now - req.arrival)
        if self._active_failures:
            self.under_failure.record(now - req.arrival)
        if req.first_token_at is not None:
            self._hist(self.ttft, req.priority).record(
                req.first_token_at - req.arrival)
        if replica_id is not None:
            st = self.replicas[replica_id]
            st.finished += 1
            st.tokens += req.generated
        if req.deadline is not None and now > req.deadline:
            self.deadline_misses += 1
        self._note_recovered(key, now)

    def record_cancelled(self, req, origin: Optional[int] = None,
                         now: Optional[float] = None) -> None:
        key = (origin, req.rid)
        if key not in self._seen:
            self._seen.add(key)
            self.cancelled += 1
        self._note_recovered(key, now)

    def record_rejected(self, req, origin: Optional[int] = None,
                        now: Optional[float] = None) -> None:
        """Admission-rejected (overflow policy): never placed, never ran."""
        key = (origin, req.rid)
        if key not in self._seen:
            self._seen.add(key)
            self.rejected += 1
        self._note_recovered(key, now)

    def record_expired(self, req, origin: Optional[int] = None,
                       now: Optional[float] = None) -> None:
        """Deadline passed while still queued: never ran, never will."""
        key = (origin, req.rid)
        if key not in self._seen:
            self._seen.add(key)
            self.cancelled += 1
            self.deadline_misses += 1
        self._note_recovered(key, now)

    def record_prefix_cache(self, replica_id: Optional[int],
                            hit_tokens: int, miss_tokens: int) -> None:
        """Prefix-cache outcome of one admission: ``hit_tokens`` of the
        prompt were adopted from the replica's cache, ``miss_tokens`` had to
        be prefilled cold."""
        self.prefix_hit_tokens += hit_tokens
        self.prefix_miss_tokens += miss_tokens
        if replica_id is not None:
            st = self.replicas[replica_id]
            st.prefix_hit_tokens += hit_tokens
            st.prefix_miss_tokens += miss_tokens

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_hit_tokens + self.prefix_miss_tokens
        return self.prefix_hit_tokens / total if total else 0.0

    def record_spec(self, replica_id: Optional[int], drafted: int,
                    accepted: int, key=None) -> None:
        """Speculative-decoding outcome of one finished request:
        ``drafted`` draft tokens proposed, ``accepted`` of them verified.
        Deduped by migration key — the same ``(origin, rid)`` rule as
        :meth:`record_steal`: a request that migrated mid-stream can be
        reported by more than one replica, and bare rids alias across entry
        processes."""
        if drafted <= 0:
            return
        if key is not None:
            if key in self._spec_seen:
                return
            self._spec_seen.add(key)
        self.spec_drafted_tokens += drafted
        self.spec_accepted_tokens += accepted
        self.spec_requests += 1
        rate = accepted / drafted
        self._spec_rate_sum += rate
        self._spec_rate_min = min(self._spec_rate_min, rate)
        self._spec_rate_max = max(self._spec_rate_max, rate)
        if replica_id is not None:
            st = self.replicas[replica_id]
            st.spec_drafted += drafted
            st.spec_accepted += accepted

    @property
    def spec_acceptance_rate(self) -> float:
        return self.spec_accepted_tokens / self.spec_drafted_tokens \
            if self.spec_drafted_tokens else 0.0

    # -- chaos / membership --------------------------------------------------
    def _note_recovered(self, key, now: Optional[float]) -> None:
        """Terminal outcome for ``key``: shrink every open failure window
        holding it; an emptied window records its recovery time."""
        if not self._active_failures:
            return
        closed = []
        for cid, (t0, keys) in self._active_failures.items():
            keys.discard(key)
            if not keys:
                self._recoveries.append((now - t0) if now is not None
                                        else 0.0)
                closed.append(cid)
        for cid in closed:
            del self._active_failures[cid]

    def record_crash(self, replica_id: int, now: float,
                     displaced: Sequence) -> None:
        """A replica died at ``now`` with ``displaced`` (origin, rid) keys
        in flight.  Opens a failure window tracked until every displaced
        request reaches a terminal outcome."""
        self.crashes += 1
        keys = set(displaced)
        self.events.append({"t": now, "kind": "crash",
                            "replica": replica_id,
                            "displaced": len(keys)})
        if keys:
            self._active_failures[self._crash_id] = (now, keys)
            self._crash_id += 1

    def record_replay(self, req, origin: Optional[int] = None) -> None:
        self.requests_replayed += 1

    def record_slowdown(self, replica_id: int, now: float,
                        factor: float) -> None:
        self.slowdowns += 1
        self.events.append({"t": now, "kind": "slowdown",
                            "replica": replica_id, "factor": factor})

    def record_scale(self, now: float, delta: int,
                     alive_after: int) -> None:
        """An autoscale decision was applied: ``delta`` replicas added
        (positive) or one sent draining (negative)."""
        if delta > 0:
            self.scale_ups += 1
            self.replicas_added += delta
        elif delta < 0:
            self.scale_downs += 1
        self.events.append({"t": now, "kind": "scale", "delta": delta,
                            "alive": alive_after})

    def record_retired(self, replica_id: int, now: float) -> None:
        """A draining replica emptied and left the fleet."""
        self.replicas_retired += 1
        self.events.append({"t": now, "kind": "retired",
                            "replica": replica_id})

    def add_replica(self) -> int:
        """The fleet grew: open a stats slot for the new replica."""
        self.replicas.append(_ReplicaStats())
        return len(self.replicas) - 1

    def note_alive(self, n: int) -> None:
        """Router callback on any membership change: ``n`` replicas are
        currently alive (placeable or draining)."""
        self.alive_replicas = n
        self.replicas_peak = max(self.replicas_peak, n)

    @property
    def recovery_times(self) -> List[float]:
        return list(self._recoveries)

    def record_steal(self, src: int, dst: int, requests: int,
                     weight: int,
                     rids: Optional[Sequence] = None) -> None:
        """``rids`` enables dedup: with chunked prefill the same request can
        be stolen again between chunks, and counting it once per migration
        would overstate ``requests_migrated`` (per-replica ``*_out`` stats
        stay raw — they describe traffic, not population).  Entries must be
        globally unique migration keys — ``(origin, rid)`` pairs in
        multi-entry deployments, where the rid alone is only unique per
        entry process."""
        if requests <= 0:
            return
        self.steal_events += 1
        self.chunk_migrations += requests
        if rids is None:
            self.requests_migrated += requests
        else:
            fresh = [r for r in rids if r not in self._migrated]
            self._migrated.update(fresh)
            self.requests_migrated += len(fresh)
        self.weight_migrated += weight
        self.replicas[src].steals_out += 1
        self.replicas[src].requests_migrated_out += requests
        self.replicas[src].weight_migrated_out += weight
        self.replicas[dst].steals_in += 1

    # -- reporting -----------------------------------------------------------
    @property
    def finished(self) -> int:
        return sum(h.total for h in self.per_class.values())

    def class_percentiles(self, slo: float) -> dict:
        h = self.per_class.get(slo)
        if h is None:
            return {"count": 0}
        return {"count": h.total, "mean_s": h.mean,
                "p50_s": h.percentile(50), "p90_s": h.percentile(90),
                "p99_s": h.percentile(99), "max_s": h.max}

    def summary(self) -> dict:
        return {
            "finished": self.finished,
            "cancelled": self.cancelled,
            "rejected": self.rejected,
            "deadline_misses": self.deadline_misses,
            "steal_events": self.steal_events,
            "requests_migrated": self.requests_migrated,
            "chunk_migrations": self.chunk_migrations,
            "weight_migrated": self.weight_migrated,
            "prefix_cache": {
                "hit_tokens": self.prefix_hit_tokens,
                "miss_tokens": self.prefix_miss_tokens,
                "hit_rate": self.prefix_hit_rate,
            },
            "spec": {
                "drafted_tokens": self.spec_drafted_tokens,
                "accepted_tokens": self.spec_accepted_tokens,
                "wasted_tokens": (self.spec_drafted_tokens
                                  - self.spec_accepted_tokens),
                "acceptance_rate": self.spec_acceptance_rate,
                "requests": self.spec_requests,
                "per_request_rate": {
                    "mean": (self._spec_rate_sum / self.spec_requests
                             if self.spec_requests else 0.0),
                    "min": (self._spec_rate_min
                            if self.spec_requests else 0.0),
                    "max": self._spec_rate_max,
                },
            },
            "chaos": {
                "crashes": self.crashes,
                "slowdowns": self.slowdowns,
                "requests_replayed": self.requests_replayed,
                "recoveries": len(self._recoveries),
                "recovery_mean_s": (sum(self._recoveries)
                                    / len(self._recoveries)
                                    if self._recoveries else 0.0),
                "recovery_max_s": (max(self._recoveries)
                                   if self._recoveries else 0.0),
                "p99_under_failure_s": self.under_failure.percentile(99),
                "finished_under_failure": self.under_failure.total,
            },
            "autoscale": {
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "replicas_added": self.replicas_added,
                "replicas_retired": self.replicas_retired,
                "replicas_peak": self.replicas_peak,
                "replicas_final": self.alive_replicas,
            },
            "events": list(self.events),
            "per_class": {str(k): self.class_percentiles(k)
                          for k in sorted(self.per_class)},
            "ttft_per_class": {
                str(k): {"p50_s": h.percentile(50), "p99_s": h.percentile(99)}
                for k, h in sorted(self.ttft.items())},
            "per_replica": [r.as_dict() for r in self.replicas],
        }

    def report(self) -> str:
        lines = [f"finished={self.finished} cancelled={self.cancelled} "
                 f"steals={self.steal_events} "
                 f"migrated_requests={self.requests_migrated} "
                 f"migrated_weight={self.weight_migrated}"]
        for slo in sorted(self.per_class):
            c = self.class_percentiles(slo)
            lines.append(
                f"  slo={slo:g}: n={c['count']} mean={c['mean_s']*1e3:.1f}ms "
                f"p50={c['p50_s']*1e3:.1f}ms p90={c['p90_s']*1e3:.1f}ms "
                f"p99={c['p99_s']*1e3:.1f}ms")
        return "\n".join(lines)
