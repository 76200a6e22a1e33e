# Copied from src/repro/cluster/sim.py; only the imports may differ.
"""Discrete-event cluster simulator (estee-style, dependency-free).

``SimReplica`` implements the exact :class:`~repro.cluster.replica.Replica`
interface the live ``EngineReplica`` does, but models execution instead of
running a model: a request's service time is
``prompt_len / prefill_rate + max_new_tokens / decode_rate`` and each
replica runs up to ``slots`` requests concurrently (the continuous-batch
decode slots).  Queueing, admission order, deadline pruning and stealing all
go through the real ``ContinuousBatcher`` — the same strategy code that
schedules the live engine — so a policy evaluated here at 1000+ replicas
and millions of requests is the policy that ships.

The event loop is a plain heapq calendar: arrivals, completions and
periodic steal ticks.  An idle replica additionally steals immediately when
its last slot frees (the work-stealing trigger), so steal latency does not
depend on the tick interval.
"""
from __future__ import annotations

import heapq
import itertools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.device.request_scheduler import (ContinuousBatcher, Request,
                                             RequestState)
from ..core.machine import MachineModel
from ..core.strategy import MergePolicy
from ..runtime.elastic import AutoscalePolicy, Autoscaler
from .chaos import ArrivalPattern, ChaosSchedule
from .replica import Replica, StolenItem
from .router import ClusterRouter, StealPolicy
from .telemetry import ClusterTelemetry

__all__ = ["SimClock", "ServiceModel", "SimReplica", "Simulation",
           "ClassSpec", "default_workload", "synthetic_requests",
           "offered_rate", "run_cluster_sim"]


class SimClock:
    """Simulated time source, shared by batchers, router and telemetry."""

    __slots__ = ("t",)

    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t


@dataclass(frozen=True)
class ServiceModel:
    """Modeled serving-step timings (tokens per second).

    Speculative decoding (``spec_k > 0``): a decode slot emits
    ``E[m] = (1 - a^(k+1)) / (1 - a)`` tokens per round at acceptance rate
    ``a`` (accepted drafts + the correction/bonus token), at a per-round
    cost of one verify step (``1 + k * spec_verify_overhead`` of a plain
    decode step — the batched k+1-wide pass) plus ``k`` draft steps at
    ``spec_draft_cost`` each.  Effective decode throughput scales by
    ``E[m] / cost`` — above 1 on greedy-friendly traffic, below 1 when the
    draft disagrees (the adaptive-k engine would shrink k; the model is a
    fixed-depth lower bound)."""

    prefill_rate: float = 8192.0     # prompt tokens/s while prefilling
    decode_rate: float = 64.0        # generated tokens/s per decode slot
    spec_k: int = 0                  # speculation depth (0 = off)
    spec_accept: float = 0.8         # default acceptance rate (per-request
    #                                  ``Request.spec_accept`` overrides)
    spec_draft_cost: float = 0.15    # draft step / target decode step
    spec_verify_overhead: float = 0.02   # extra cost per verified draft

    def accept_rate(self, req: Request) -> float:
        a = req.spec_accept if req.spec_accept > 0 else self.spec_accept
        return min(max(a, 0.0), 0.999)

    def spec_tokens_per_round(self, req: Request) -> float:
        a = self.accept_rate(req)
        k = self.spec_k
        return (1.0 - a ** (k + 1)) / (1.0 - a)

    def spec_speedup(self, req: Request) -> float:
        if self.spec_k <= 0:
            return 1.0
        k = self.spec_k
        cost = 1.0 + k * self.spec_verify_overhead + k * self.spec_draft_cost
        return self.spec_tokens_per_round(req) / cost

    def prefill_time(self, req: Request) -> float:
        # uncached remaining prefill only: a stolen (or chunked) request
        # keeps its processed prefix (the KV blocks travel with the block
        # table), and a locally-cached prefix is adopted, not recomputed —
        # service time is hit-dependent
        return req.uncached_prefill / self.prefill_rate

    def decode_time(self, req: Request) -> float:
        return req.max_new_tokens / (self.decode_rate
                                     * self.spec_speedup(req))

    def service_time(self, req: Request) -> float:
        return self.prefill_time(req) + self.decode_time(req)

    def spec_counters(self, req: Request) -> Tuple[int, int]:
        """Expected ``(drafted, accepted)`` draft-token totals for a
        finished request — what a live engine's per-request record holds."""
        if self.spec_k <= 0:
            return 0, 0
        a = self.accept_rate(req)
        k = self.spec_k
        rounds = max(1.0, req.max_new_tokens / self.spec_tokens_per_round(req))
        drafted = rounds * k
        # accepted drafts per round: sum_{j=1..k} a^j
        accepted = rounds * a * (1.0 - a ** k) / (1.0 - a)
        return int(round(drafted)), int(round(accepted))


class SimReplica(Replica):
    """Modeled replica: real batcher/strategies, simulated execution.
    ``prefill_chunk`` models chunked prefill: a long prompt occupies a slot
    for one chunk's service time, then re-enters the strategy queue — where
    an urgent arrival can overtake it, or a thief can steal it (the steal
    then migrates its *unprocessed* chunks; the processed prefix travels
    with the request, see :meth:`ServiceModel.prefill_time`)."""

    def __init__(self, replica_id: int, clock: SimClock,
                 service: Optional[ServiceModel] = None, slots: int = 4,
                 place: Optional[int] = None,
                 merge_policy: Optional[MergePolicy] = None,
                 prefill_chunk: Optional[int] = None,
                 admission: str = "strategy",
                 prefix_cache_tokens: int = 0):
        super().__init__(replica_id, place)
        self.clock = clock
        self.service = service or ServiceModel()
        self.slots = slots
        #: service-rate multiplier (1.0 = nominal, < 1 = straggling);
        #: chaos slowdown events set it, the router's speed-aware victim
        #: ranking reads it back through ``speed_hint``
        self.speed = 1.0
        self.batcher = ContinuousBatcher(max_batch=slots, now=clock.now,
                                         merge_policy=merge_policy,
                                         prefill_chunk=prefill_chunk,
                                         admission=admission,
                                         place_id=replica_id)
        self.active = 0
        #: modeled prefix cache: prefix group -> cached prefix tokens, LRU
        #: over a ``prefix_cache_tokens`` capacity (0 = no cache).  Live
        #: engines hash real tokens; the simulator models the same hit
        #: behaviour through the workload's synthetic prefix groups.
        self.prefix_cache_tokens = prefix_cache_tokens
        self._pcache: "OrderedDict[int, int]" = OrderedDict()
        self._pcache_total = 0
        #: rid -> (drafted, accepted): modeled speculation outcome, popped
        #: by the router at finish time (mirrors Speculator.take_record)
        self._spec: dict = {}
        self.sim: Optional["Simulation"] = None   # bound by Simulation

    # -- Replica interface ---------------------------------------------------
    def backlog_weight(self) -> int:
        return self.batcher.backlog_weight()

    def waiting_weight(self) -> int:
        return self.batcher.waiting_weight()

    def waiting_count(self) -> int:
        return self.batcher.waiting_count

    def active_count(self) -> int:
        return self.active

    def wants_work(self) -> bool:
        return (not self.dead and not self.draining
                and self.active < self.slots
                and self.batcher.waiting_count == 0)

    def concurrency(self) -> int:
        return self.slots

    def speed_hint(self) -> float:
        return self.speed

    def set_speed(self, speed: float) -> None:
        """Chaos slowdown/restore.  Only affects work dispatched from now
        on — requests already in a slot keep their scheduled completion
        (the model's granularity; a finer model would re-plan them)."""
        self.speed = max(speed, 1e-6)

    def prefix_match(self, req: Request, tokens=None) -> int:
        if not self.prefix_cache_tokens or req.prefix_group is None:
            return 0
        return min(self._pcache.get(req.prefix_group, 0), req.prefix_len)

    def _cache_adopt(self, req: Request) -> None:
        """Admission-time cache probe: the cached prefix is adopted (jumping
        ``prefilled`` forward, exactly like the engine's block adoption), so
        the modeled prefill time covers only the uncached remainder."""
        if not self.prefix_cache_tokens or req.prefilled > 0:
            return
        hit = min(self.prefix_match(req), max(req.prompt_len - 1, 0))
        req.cached_prefix = hit
        if hit:
            req.prefilled = hit
            self._pcache.move_to_end(req.prefix_group)
        if self.sim is not None:
            self.sim.router.telemetry.record_prefix_cache(
                self.replica_id, hit, req.prompt_len - hit)

    def _cache_insert(self, req: Request) -> None:
        """The request's shared prefix is now resident: cache it, evicting
        least-recently-used groups beyond the capacity."""
        if not self.prefix_cache_tokens or req.prefix_group is None:
            return
        plen = min(req.prefix_len, req.prompt_len)
        old = self._pcache.get(req.prefix_group, 0)
        if plen > old:
            self._pcache_total += plen - old
            self._pcache[req.prefix_group] = plen
        self._pcache.move_to_end(req.prefix_group)
        while self._pcache_total > self.prefix_cache_tokens \
                and len(self._pcache) > 1:
            _, n = self._pcache.popitem(last=False)
            self._pcache_total -= n

    def submit(self, req: Request, tokens=None,
               migrated: bool = False) -> None:
        # probe before the strategy is built: cache-aware admission priority
        # and steal weight read ``cached_prefix``
        if req.prefilled == 0:
            req.cached_prefix = self.prefix_match(req)
        self.batcher.submit(req)
        if self.sim is not None:
            self.dispatch()

    def steal_waiting(self, target_weight: int) -> List[StolenItem]:
        return [(r, None) for r in self.batcher.steal_waiting(target_weight)]

    def steal_waiting_count(self, n: int) -> List[StolenItem]:
        return [(r, None) for r in self.batcher.steal_waiting_count(n)]

    # -- modeled execution ---------------------------------------------------
    def dispatch(self) -> None:
        """Fill free slots in strategy-priority order; schedule completions.
        With chunked prefill, a mid-prompt request occupies the slot for one
        chunk's service time only."""
        if self.dead:
            return
        while self.active < self.slots:
            req = self.batcher.pop_next_waiting()
            if req is None:
                break
            self._cache_adopt(req)
            chunk = self.batcher.chunk_tokens_for(req)
            if chunk < req.remaining_prefill:
                # the chunk occupies a slot: it IS load — track it in the
                # running set so backlog_weight stays honest for placement
                # and steal-surplus decisions
                self.batcher.mark_running(req)
                req.state = RequestState.PREFILL
                self.active += 1
                self.sim.after(
                    chunk / (self.service.prefill_rate * self.speed),
                    self._chunk_done, req, chunk)
                continue
            self.batcher.mark_running(req)
            now = self.clock.now()
            req.first_token_at = now + \
                self.service.prefill_time(req) / self.speed
            self.active += 1
            self.sim.after(self.service.service_time(req) / self.speed,
                           self._complete, req)

    def _chunk_done(self, req: Request, chunk: int) -> None:
        """A non-final prefill chunk finished: the request re-enters the
        waiting storage (strategy-ordered, stealable) for its remaining
        chunks — the same bookkeeping the live engine uses."""
        if self.dead or req.state is not RequestState.PREFILL:
            # crashed mid-chunk (event outlived the replica, or the
            # request was already replayed elsewhere): drop silently
            return
        self.active -= 1
        self.batcher.finish_running(req)
        self.batcher.complete_prefill_chunk(req, chunk)
        if req.prefilled >= min(req.prefix_len, req.prompt_len):
            self._cache_insert(req)       # shared prefix fully resident
        self.dispatch()

    def take_spec(self, rid: int):
        return self._spec.pop(rid, None)

    def _complete(self, req: Request) -> None:
        if self.dead:
            # the completion event outlived the replica: the request was
            # displaced by the crash and replays elsewhere
            return
        self.active -= 1
        req.prefilled = req.prompt_len
        req.generated = req.max_new_tokens
        if self.service.spec_k > 0:
            req.spec_k = self.service.spec_k
            req.spec_accept = self.service.accept_rate(req)
            self._spec[req.rid] = self.service.spec_counters(req)
        self._cache_insert(req)
        self.batcher.finish_running(req)
        req.state = RequestState.DONE
        req.finished_at = self.clock.now()
        self.sim.router.on_finished(req, self.replica_id)
        self.dispatch()
        if self.wants_work():                 # went idle: steal immediately
            self.sim.router.steal_for(self.replica_id)
            self.dispatch()


class Simulation:
    """heapq event calendar driving a router over ``SimReplica`` pools.

    Beyond arrivals/completions/steal ticks, the calendar can carry a
    :class:`~repro.cluster.chaos.ChaosSchedule` (crash and slowdown
    events) and a periodic autoscale tick that feeds the fleet's
    cache-adjusted backlog into an :class:`~repro.runtime.elastic.
    Autoscaler` — scale-up instantiates replicas through
    ``replica_factory(index)``, scale-down drains the least-loaded one.
    Periodic ticks are bookkept separately from *real* events so two
    mutually-rescheduling tick streams cannot keep an otherwise-drained
    calendar alive forever."""

    def __init__(self, router: ClusterRouter, clock: SimClock,
                 steal_interval: Optional[float] = 0.25,
                 chaos: Optional[ChaosSchedule] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 replica_factory: Optional[Callable[[int], Replica]] = None,
                 autoscale_interval: float = 0.5):
        self.router = router
        self.clock = clock
        self.steal_interval = steal_interval
        self.chaos = chaos
        self.autoscaler = autoscaler
        self.replica_factory = replica_factory
        self.autoscale_interval = autoscale_interval
        self._events: List[Tuple[float, int, Callable, tuple, bool]] = []
        self._seq = itertools.count()
        self._real_pending = 0
        self._chaos_scheduled = False
        for rep in router.replicas:
            if isinstance(rep, SimReplica):
                rep.sim = self

    def _push(self, t: float, fn: Callable, args: tuple,
              tick: bool) -> None:
        if not tick:
            self._real_pending += 1
        heapq.heappush(self._events, (t, next(self._seq), fn, args, tick))

    def at(self, t: float, fn: Callable, *args) -> None:
        self._push(t, fn, args, False)

    def after(self, dt: float, fn: Callable, *args) -> None:
        self.at(self.clock.t + dt, fn, *args)

    def _tick_after(self, dt: float, fn: Callable) -> None:
        self._push(self.clock.t + dt, fn, (), True)

    def _live(self) -> bool:
        """Work remains: real events pending or requests outstanding."""
        return self._real_pending > 0 or bool(self.router.outstanding)

    def _steal_tick(self) -> None:
        self.router.steal_tick()
        for rep in self.router.replicas:
            if isinstance(rep, SimReplica):
                rep.dispatch()
        if self.steal_interval and self._live():
            self._tick_after(self.steal_interval, self._steal_tick)

    # -- chaos + autoscale ---------------------------------------------------
    def add_replica(self) -> int:
        rep = self.replica_factory(len(self.router.replicas))
        if isinstance(rep, SimReplica):
            rep.sim = self
        return self.router.add_replica(rep)

    def _crash(self, idx: int) -> None:
        self.router.fail_replica(idx)

    def _slow(self, idx: int, factor: float) -> None:
        rep = self.router.replicas[idx]
        if rep.dead or not isinstance(rep, SimReplica):
            return
        rep.set_speed(factor)
        self.router.telemetry.record_slowdown(idx, self.clock.t, factor)

    def _unslow(self, idx: int) -> None:
        rep = self.router.replicas[idx]
        if not rep.dead and isinstance(rep, SimReplica):
            rep.set_speed(1.0)

    def _autoscale_tick(self) -> None:
        r = self.router
        alive = r.placeable
        if alive:
            backlog = sum(r.replicas[i].backlog_weight() for i in alive)
            delta = self.autoscaler.observe(self.clock.t, len(alive),
                                            backlog)
            if delta > 0 and self.replica_factory is not None:
                for _ in range(delta):
                    self.add_replica()
                r.telemetry.record_scale(self.clock.t, delta,
                                         len(r.placeable))
                r.steal_tick()          # new replicas pull work now
            elif delta < 0:
                victim = min(alive, key=lambda i: (
                    r.replicas[i].backlog_weight(), i))
                if r.retire_replica(victim):
                    r.telemetry.record_scale(self.clock.t, -1,
                                             len(r.placeable))
        r._check_retired()
        if self.autoscale_interval and self._live():
            self._tick_after(self.autoscale_interval, self._autoscale_tick)

    def _schedule_chaos(self) -> None:
        for ev in self.chaos.crashes:
            self.at(ev.t, self._crash, ev.replica)
        for ev in self.chaos.slowdowns:
            self.at(ev.t, self._slow, ev.replica, ev.factor)
            self.at(ev.t + ev.duration, self._unslow, ev.replica)

    def run(self, until: Optional[float] = None) -> float:
        if self.chaos is not None and not self._chaos_scheduled:
            self._chaos_scheduled = True
            self._schedule_chaos()
        if self.steal_interval:
            self._tick_after(self.steal_interval, self._steal_tick)
        if self.autoscaler is not None and self.autoscale_interval:
            self._tick_after(self.autoscale_interval, self._autoscale_tick)
        while self._events:
            item = heapq.heappop(self._events)
            t, _, fn, args, tick = item
            if until is not None and t > until:
                heapq.heappush(self._events, item)   # keep it for resume
                break
            if not tick:
                self._real_pending -= 1
            self.clock.t = t
            fn(*args)
        return self.clock.t


# --------------------------------------------------------------------------
# Synthetic workloads + one-call experiment driver
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ClassSpec:
    """One SLO class of a synthetic workload."""

    priority: float            # the request's SLO class (lower = urgent)
    share: float               # fraction of arrivals in this class
    mean_prompt_len: float
    mean_new_tokens: float
    size_dist: str = "exponential"    # decode lens: exponential | pareto
    pareto_alpha: float = 1.5
    prompt_dist: str = "exponential"  # prompt lens: exponential | pareto
    prompt_pareto_alpha: float = 1.5
    #: shared-prefix (system-prompt) traffic: arrivals spread over
    #: ``prefix_groups`` distinct system prompts, each covering
    #: ``prefix_frac`` of the mean prompt length (0 = every prompt cold)
    prefix_groups: int = 0
    prefix_frac: float = 0.0
    #: per-class draft acceptance rate when the cluster speculates
    #: (0 = inherit the ServiceModel default); greedy-friendly traffic
    #: (extraction, code completion) accepts high, creative traffic low
    spec_accept: float = 0.0

    def mean_service(self, service: ServiceModel) -> float:
        return self.mean_prompt_len / service.prefill_rate + \
            self.mean_new_tokens / service.decode_rate

    @staticmethod
    def _draw(rng, dist: str, mean: float, alpha: float, n: int):
        if dist == "exponential":
            return rng.exponential(mean, n)
        if dist == "pareto":
            # Lomax(alpha, scale); mean = scale/(alpha-1)
            return rng.pareto(alpha, n) * (mean * (alpha - 1.0))
        raise ValueError(f"unknown distribution {dist!r}")

    def sample_sizes(self, rng: np.random.Generator, n: int):
        prompts = self._draw(rng, self.prompt_dist, self.mean_prompt_len,
                             self.prompt_pareto_alpha, n)
        toks = self._draw(rng, self.size_dist, self.mean_new_tokens,
                          self.pareto_alpha, n)
        return (np.maximum(1, prompts).astype(np.int64),
                np.maximum(1, toks).astype(np.int64))


def default_workload(size_dist: str = "exponential",
                     pareto_alpha: float = 1.5) -> Tuple[ClassSpec, ...]:
    """Interactive tier (short, latency-sensitive) sharing the cluster with
    a bulk tier whose decode lengths are exponential or heavy-tailed —
    the bulk tail is what stresses the steal policy, the interactive p99
    is where the difference shows."""
    return (
        ClassSpec(priority=0.0, share=0.3, mean_prompt_len=32,
                  mean_new_tokens=16, size_dist="exponential"),
        ClassSpec(priority=1.0, share=0.7, mean_prompt_len=128,
                  mean_new_tokens=64, size_dist=size_dist,
                  pareto_alpha=pareto_alpha),
    )


def synthetic_requests(num_requests: int, arrival_rate: float,
                       classes: Sequence[ClassSpec],
                       seed: int = 0,
                       pattern: Optional[ArrivalPattern] = None):
    """Poisson arrivals over a mix of SLO classes.  Returns a list of
    ``(arrival_time, make_request)``; ``make_request(now)`` builds the
    Request stamped with sim time.

    ``pattern`` makes the process non-homogeneous (diurnal sinusoid,
    flash crowds): arrivals are drawn at the pattern's peak rate and
    thinned by ``multiplier(t) / peak`` — the standard exact sampler for
    a non-homogeneous Poisson process, and seed-deterministic because
    both the gaps and the acceptance draws come from one seeded
    generator."""
    rng = np.random.default_rng(seed)
    if pattern is None:
        gaps = rng.exponential(1.0 / arrival_rate, num_requests)
        arrivals = np.cumsum(gaps)
    else:
        peak = pattern.peak
        accepted: List[float] = []
        t = 0.0
        while len(accepted) < num_requests:
            t += rng.exponential(1.0 / (arrival_rate * peak))
            if rng.random() * peak <= pattern.multiplier(t):
                accepted.append(t)
        arrivals = np.asarray(accepted, np.float64)
    shares = np.asarray([c.share for c in classes], np.float64)
    which = rng.choice(len(classes), num_requests, p=shares / shares.sum())
    prompts = np.empty(num_requests, np.int64)
    new_toks = np.empty(num_requests, np.int64)
    prios = np.empty(num_requests, np.float64)
    groups = np.full(num_requests, -1, np.int64)
    prefix_lens = np.zeros(num_requests, np.int64)
    for ci, spec in enumerate(classes):
        mask = which == ci
        n = int(mask.sum())
        p, t = spec.sample_sizes(rng, n)
        if spec.prefix_groups > 0 and spec.prefix_frac > 0:
            # shared-prefix traffic: a constant per-group system prompt
            # plus a private tail drawn from the class's prompt
            # distribution (class mean preserved)
            plen = max(1, int(round(spec.mean_prompt_len
                                    * spec.prefix_frac)))
            tail = spec._draw(rng, spec.prompt_dist,
                              max(spec.mean_prompt_len - plen, 1.0),
                              spec.prompt_pareto_alpha, n)
            p = plen + np.maximum(1, tail).astype(np.int64)
            # group ids are globally unique across classes
            groups[mask] = ci * 1_000_003 + rng.integers(
                0, spec.prefix_groups, n)
            prefix_lens[mask] = plen
        prompts[mask] = p
        new_toks[mask] = t
        prios[mask] = spec.priority

    accepts = np.asarray([classes[c].spec_accept for c in which], np.float64)

    out = []
    for i in range(num_requests):
        def make(now: float, i=i) -> Request:
            g = int(groups[i])
            return Request(prompt_len=int(prompts[i]),
                           max_new_tokens=int(new_toks[i]),
                           priority=float(prios[i]), arrival=now,
                           prefix_group=g if g >= 0 else None,
                           prefix_len=int(prefix_lens[i]),
                           spec_accept=float(accepts[i]))
        out.append((float(arrivals[i]), make))
    return out


def offered_rate(num_replicas: int, slots: int, utilization: float,
                 classes: Sequence[ClassSpec],
                 service: ServiceModel) -> float:
    """Arrival rate hitting target ``utilization`` on the *initial* fleet:
    ``lambda = rho * total_slots / mean_service_time``.  Exposed so chaos
    benchmarks can convert request counts into expected run duration and
    schedule faults at meaningful fractions of it."""
    shares = np.asarray([c.share for c in classes], np.float64)
    shares /= shares.sum()
    mean_service = float(sum(
        s * c.mean_service(service) for s, c in zip(shares, classes)))
    return utilization * num_replicas * slots / mean_service


def run_cluster_sim(num_replicas: int, num_requests: int,
                    policy: StealPolicy, *,
                    utilization: float = 0.85,
                    classes: Optional[Sequence[ClassSpec]] = None,
                    size_dist: str = "exponential",
                    pareto_alpha: float = 1.5,
                    slots: int = 4,
                    service: Optional[ServiceModel] = None,
                    machine: Optional[MachineModel] = None,
                    steal_interval: Optional[float] = 0.25,
                    merge_policy: Optional[MergePolicy] = None,
                    prefill_chunk: Optional[int] = None,
                    admission: str = "strategy",
                    prefix_cache_tokens: int = 0,
                    spec_k: int = 0,
                    spec_accept: float = 0.8,
                    chaos: Optional[ChaosSchedule] = None,
                    arrival: Optional[ArrivalPattern] = None,
                    autoscale: Optional[AutoscalePolicy] = None,
                    autoscale_interval: float = 0.5,
                    seed: int = 0,
                    debug_invariants: bool = False) -> ClusterTelemetry:
    """Build a simulated cluster, push a synthetic workload through the
    shared router policy code, return the telemetry.  ``spec_k > 0``
    switches every replica to speculative decoding at that depth
    (acceptance ``spec_accept`` unless the workload's classes override).

    Chaos hardening: ``chaos`` injects crash/slowdown events, ``arrival``
    makes arrivals non-stationary (diurnal + flash crowds), and
    ``autoscale`` turns on telemetry-driven elastic scaling — scale-up
    replicas are built by the same recipe as the initial fleet.  The whole
    run is seed-deterministic: same arguments, same seed → identical
    telemetry, event trace included."""
    service = service or ServiceModel(spec_k=spec_k, spec_accept=spec_accept)
    classes = tuple(classes) if classes is not None else \
        default_workload(size_dist=size_dist, pareto_alpha=pareto_alpha)
    clock = SimClock()

    def make_replica(i: int) -> SimReplica:
        return SimReplica(i, clock, service, slots=slots,
                          merge_policy=merge_policy,
                          prefill_chunk=prefill_chunk,
                          admission=admission,
                          prefix_cache_tokens=prefix_cache_tokens)

    replicas = [make_replica(i) for i in range(num_replicas)]
    telemetry = ClusterTelemetry(num_replicas)
    router = ClusterRouter(replicas, machine=machine, policy=policy,
                           telemetry=telemetry, now=clock.now, seed=seed,
                           debug_invariants=debug_invariants)
    sim = Simulation(router, clock, steal_interval=steal_interval,
                     chaos=chaos,
                     autoscaler=(Autoscaler(autoscale)
                                 if autoscale is not None else None),
                     replica_factory=make_replica,
                     autoscale_interval=autoscale_interval)

    rate = offered_rate(num_replicas, slots, utilization, classes, service)
    workload = synthetic_requests(num_requests, rate, classes,
                                  seed=seed + 1, pattern=arrival)

    def arrive(make) -> None:
        req = make(clock.now())
        router.submit(req)

    for t, make in workload:
        sim.at(t, arrive, make)
    sim.run()
    return telemetry
