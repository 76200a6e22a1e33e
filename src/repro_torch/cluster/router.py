# Copied from src/repro/cluster/router.py; only the imports may differ.
"""Admission router + configurable cross-replica steal loop.

This generalizes ``rebalance_replicas`` into the paper's configurable-
strategy shape, lifted from threads-in-a-process to replicas-in-a-cluster:

* **placement** (where an arriving request lands) — round-robin, random,
  least-loaded-of-d sampled replicas ("share on arrival", Van Houdt's
  sharing discipline), global least-work, SLO-aware (tier-0 requests get
  a global scan, bulk tiers the cheap sampled scan), or cache-affinity
  (route to the replica with the longest matching cached prompt prefix —
  affinity-dependent service times shift the stealing-vs-sharing
  tradeoff); ties broken by ``MachineModel`` distance from the request's
  home place (locality).
* **steal amount** — ``half_work`` (half the victim's backlog by estimated
  *weight*, largest requests first — the paper's steal-half-the-work) vs
  ``half_count`` (half the victim's queue oldest-first, the oblivious
  baseline) vs ``none`` (pure sharing).
* **victim order** — ``nearest`` (machine-distance order, neighbours
  first), ``random``, or ``max_loaded`` (global argmax).  Victims are
  ranked by *speed-adjusted* stealable work: a straggler's queue drains
  slower, so the same token count is effectively heavier — the paper's
  straggler-mitigation rule folded into victim selection.

The router also owns fleet **membership**: replicas can be added
(autoscale-up), retired (graceful drain for scale-down) or failed
(fail-stop crash).  A crash replays the dead replica's in-flight requests
onto survivors — progress rewinds to a cold start, the replacement
replica's prefix cache is re-probed at re-admission, and the original
``(origin, rid)`` telemetry stamp is preserved so post-replay migrations
do not double-count.  Replica indices are never reused: the ``replicas``
list only grows, and dead entries stay as tombstones so telemetry ids
stay stable.

The router only talks to the :class:`~repro.cluster.replica.Replica`
interface, so the identical policy object drives live ``ServingEngine``
replicas and the discrete-event simulator in ``cluster.sim``.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..core.device.request_scheduler import (AdmissionRejected, Request,
                                             RequestState)
from ..core.machine import MachineModel, flat_machine
from .replica import Replica
from .telemetry import ClusterTelemetry

__all__ = ["StealPolicy", "ClusterRouter"]


@dataclass(frozen=True)
class StealPolicy:
    """Configuration of the cluster-level work-stealing strategy."""

    amount: str = "half_work"        # half_work | half_count | none
    victim: str = "nearest"          # nearest | random | max_loaded
    placement: str = "round_robin"   # round_robin | random | least_of_d |
                                     # least_work | slo_aware |
                                     # cache_affinity | cost_model
    probe: int = 4                   # replicas probed per steal / placement
    min_victim_weight: int = 2       # don't steal from near-empty victims

    def __post_init__(self):
        if self.amount not in ("half_work", "half_count", "none"):
            raise ValueError(f"unknown steal amount {self.amount!r}")
        if self.victim not in ("nearest", "random", "max_loaded"):
            raise ValueError(f"unknown victim order {self.victim!r}")
        if self.placement not in ("round_robin", "random", "least_of_d",
                                  "least_work", "slo_aware",
                                  "cache_affinity", "cost_model"):
            raise ValueError(f"unknown placement {self.placement!r}")


class ClusterRouter:
    """Places requests and runs the steal loop over a replica pool."""

    def __init__(self, replicas: Sequence[Replica],
                 machine: Optional[MachineModel] = None,
                 policy: Optional[StealPolicy] = None,
                 telemetry: Optional[ClusterTelemetry] = None,
                 now: Callable[[], float] = time.monotonic,
                 seed: int = 0,
                 heartbeat=None, straggler=None,
                 debug_invariants: bool = False):
        self.replicas = list(replicas)
        self.machine = machine or flat_machine(len(self.replicas))
        if self.machine.num_places != len(self.replicas):
            raise ValueError("machine model size != replica count")
        self.policy = policy or StealPolicy()
        self.telemetry = telemetry or ClusterTelemetry(len(self.replicas))
        self.now = now
        self.rng = random.Random(seed)
        #: liveness (``runtime.fault_tolerance.HeartbeatMonitor``): live
        #: mode beats per responsive replica each step and fail-stops
        #: replicas that miss the timeout.  None = explicit fail_replica
        #: calls only (the simulator's crash events).
        self.heartbeat = heartbeat
        #: measured speeds (``runtime.fault_tolerance.StragglerDetector``):
        #: overrides ``Replica.speed_hint`` for victim ranking and
        #: cost-model placement when provided (live mode feeds it step
        #: wall-times; the sim's replicas self-report their modeled speed)
        self.straggler = straggler
        self._rr_i = 0
        self._dead: set = set()
        self._draining: set = set()
        #: alive AND not draining — the placement candidate set, rebuilt
        #: on membership change (never on the request path)
        self._placeable: List[int] = list(range(len(self.replicas)))
        self._victims_cache: Dict[int, List[int]] = {}
        self.outstanding: Dict[int, Request] = {}
        #: rid -> prompt payload, retained while in flight so a crash can
        #: replay the request (simulation passes no payloads; live mode
        #: keeps the tokens)
        self._payloads: Dict[int, object] = {}
        self._owner: Dict[int, int] = {}        # rid -> replica index
        #: rid -> entry point: rids are only unique per entry process, so
        #: telemetry dedupes by the (origin, rid) pair.  In this one-router
        #: topology the first-placement replica stands in for the entry
        #: point (rids here come from one counter and cannot collide); a
        #: multi-entry deployment must stamp each entry router's own id so
        #: the pair is globally unique — telemetry treats it as opaque.
        self._origin: Dict[int, int] = {}
        #: prefix group -> replica that last served it (the cache-affinity
        #: placement hint; avoids probing every replica per arrival)
        self._group_home: Dict[int, int] = {}
        self._steps = 0
        # -- conservation ledger (see check()) ---------------------------
        #: auto-run check() after every step / poll / crash when True (the
        #: chaos tests and the analysis layer turn this on; production
        #: routers leave it off — the scan is O(outstanding))
        self.debug_invariants = debug_invariants
        #: distinct requests ever admitted into the tracked population
        self.accepted_total = 0
        #: terminal outcomes of tracked requests, by reason
        self.terminal_counts: Dict[str, int] = {
            "finished": 0, "cancelled": 0, "rejected": 0}
        #: crash accounting: every displaced request is either replayed on
        #: a survivor or reaches a terminal outcome during replay
        self.displaced_total = 0
        self.replayed_total = 0
        self.replay_failed_total = 0

    # -- membership ----------------------------------------------------------
    @property
    def placeable(self) -> List[int]:
        """Replica indices placement may choose from (alive, not
        draining)."""
        return self._placeable

    def alive_count(self) -> int:
        return len(self.replicas) - len(self._dead)

    def _membership_changed(self) -> None:
        self._placeable = [i for i in range(len(self.replicas))
                           if i not in self._dead
                           and i not in self._draining]
        self._victims_cache.clear()
        self.telemetry.note_alive(self.alive_count())

    def add_replica(self, rep: Replica) -> int:
        """Scale-up: append a fresh replica.  Indices are append-only, so
        existing telemetry and dedup stamps stay valid.  A custom machine
        topology cannot be extended in place — autoscaled growth falls
        back to flat distances."""
        idx = len(self.replicas)
        self.replicas.append(rep)
        if self.machine.num_places < len(self.replicas):
            self.machine = flat_machine(len(self.replicas))
        self.telemetry.add_replica()
        if self.straggler is not None and self.straggler.num_hosts < \
                len(self.replicas):
            self.straggler.grow(len(self.replicas)
                                - self.straggler.num_hosts)
        self._membership_changed()
        return idx

    def fail_replica(self, idx: int) -> List[Request]:
        """Fail-stop crash of replica ``idx``: everything it held — queued
        requests, running requests, KV cache, prefix cache — is gone.  Each
        displaced request rewinds to a cold start and is re-placed on a
        survivor, where admission re-probes the prefix cache: a prefix the
        fleet had published elsewhere is re-adopted and only the uncached
        remainder re-prefills.  Returns the replayed requests."""
        if idx in self._dead or idx >= len(self.replicas):
            return []
        self._dead.add(idx)
        self._draining.discard(idx)
        self.replicas[idx].fail()
        self._membership_changed()
        if self.heartbeat is not None:
            self.heartbeat.last_seen.pop(idx, None)
        displaced = [self.outstanding[rid]
                     for rid, owner in self._owner.items()
                     if owner == idx and self.outstanding[rid].state in
                     (RequestState.WAITING, RequestState.PREFILL,
                      RequestState.RUNNING)]
        now = self.now()
        self.telemetry.record_crash(
            idx, now,
            [(self._origin.get(r.rid, idx), r.rid) for r in displaced])
        # group homes pointing at the corpse would keep attracting traffic
        self._group_home = {g: h for g, h in self._group_home.items()
                            if h != idx}
        self.displaced_total += len(displaced)
        for req in displaced:
            req.reset_for_replay()
            new_idx = self.submit(req, self._payloads.get(req.rid),
                                  _replay=True)
            if new_idx >= 0:
                self.replayed_total += 1
                self.telemetry.record_replay(
                    req, origin=self._origin.get(req.rid))
        if self.debug_invariants:
            self.check()
        return displaced

    def retire_replica(self, idx: int) -> bool:
        """Graceful scale-down: stop placing on ``idx``, migrate its queue
        to survivors (dedup stamps preserved), let running requests finish.
        The replica leaves the fleet when empty (``_check_retired``).
        Refuses to retire the last placeable replica."""
        if idx in self._dead or idx in self._draining \
                or len(self._placeable) <= 1:
            return False
        self._draining.add(idx)
        self.replicas[idx].draining = True
        self._membership_changed()
        rep = self.replicas[idx]
        stolen = rep.steal_waiting_count(rep.waiting_count())
        for r, payload in stolen:
            r.cached_prefix = 0          # cache affinity does not travel
            dst = self.place(r, None, payload)
            self.replicas[dst].submit(r, payload, migrated=True)
            self._owner[r.rid] = dst
            self.telemetry.record_steal(
                idx, dst, 1, r.est_remaining_work,
                rids=[(self._origin.get(r.rid, idx), r.rid)])
        self._check_retired()
        return True

    def _check_retired(self) -> None:
        """Promote emptied draining replicas to tombstones."""
        if not self._draining:
            return
        done = [i for i in self._draining
                if self.replicas[i].active_count() == 0
                and self.replicas[i].waiting_count() == 0]
        if not done:
            return
        for i in sorted(done):
            self._draining.discard(i)
            self._dead.add(i)
            self.replicas[i].fail()
            self.telemetry.record_retired(i, self.now())
        self._membership_changed()

    def _speed(self, i: int) -> float:
        if self.straggler is not None and i < self.straggler.num_hosts \
                and self.straggler.seen[i]:
            return self.straggler.relative_speed(i)
        return self.replicas[i].speed_hint()

    # -- placement -----------------------------------------------------------
    def _sampled(self, k: int) -> List[int]:
        cand = self._placeable
        return self.rng.sample(cand, min(k, len(cand)))

    def _least_loaded(self, candidates: Sequence[int],
                      home: Optional[int]) -> int:
        def key(i: int):
            dist = (self.machine.distance(home, self.replicas[i].place)
                    if home is not None else 0)
            return (self.replicas[i].backlog_weight(), dist, i)
        return min(candidates, key=key)

    def _place_affine(self, req: Request, tokens,
                      home: Optional[int]) -> int:
        """Cache-affinity placement: among ``probe`` sampled replicas plus
        the prefix group's last home, route to the longest matching cached
        prefix; load and distance break ties (a warm replica wins over an
        idle cold one — the Van Houdt sharing-vs-stealing tradeoff shifts
        when service time is affinity-dependent)."""
        cand = self._candidates_with_home_hint(req)

        def key(i: int):
            rep = self.replicas[i]
            dist = (self.machine.distance(home, rep.place)
                    if home is not None else 0)
            return (-rep.prefix_match(req, tokens),
                    rep.backlog_weight(), dist, i)
        return min(cand, key=key)

    def _candidates_with_home_hint(self, req: Request) -> List[int]:
        cand = self._sampled(self.policy.probe)
        if req.prefix_group is not None:
            hint = self._group_home.get(req.prefix_group)
            if hint is not None and hint not in cand \
                    and hint not in self._dead \
                    and hint not in self._draining:
                cand.append(hint)
        return cand

    def _place_cost_model(self, req: Request, tokens,
                          home: Optional[int]) -> int:
        """estee-style duration-model placement: land the request where
        its estimated completion time is lowest.  Cost = (replica's
        cache-adjusted backlog + this request's uncached work there) over
        its service rate (slots × measured speed) — all in token units,
        so the model's rates cancel out.  Pure model-driven sharing: the
        natural partner policy is ``amount="none"`` (no stealing), the
        contrast the chaos benchmark draws against reactive
        cache-affinity + steal-half-work."""
        cand = self._candidates_with_home_hint(req)

        def key(i: int):
            rep = self.replicas[i]
            hit = rep.prefix_match(req, tokens)
            work = max(req.est_remaining_work - hit, 1)
            rate = max(self._speed(i), 1e-6) * max(rep.concurrency(), 1)
            dist = (self.machine.distance(home, rep.place)
                    if home is not None else 0)
            return ((rep.backlog_weight() + work) / rate, dist, i)
        return min(cand, key=key)

    def place(self, req: Request, home: Optional[int] = None,
              tokens=None) -> int:
        p = self.policy.placement
        cand = self._placeable
        if not cand:
            raise RuntimeError("no placeable replicas")
        if p == "round_robin":
            idx = cand[self._rr_i % len(cand)]
            self._rr_i += 1
            return idx
        if p == "random":
            return cand[self.rng.randrange(len(cand))]
        if p == "least_of_d":
            return self._least_loaded(self._sampled(self.policy.probe), home)
        if p == "least_work":
            return self._least_loaded(cand, home)
        if p == "cache_affinity":
            return self._place_affine(req, tokens, home)
        if p == "cost_model":
            return self._place_cost_model(req, tokens, home)
        # slo_aware: urgent classes pay for the global scan, bulk ones sample
        if req.priority <= 0.0:
            return self._least_loaded(cand, home)
        return self._least_loaded(self._sampled(self.policy.probe), home)

    def submit(self, req: Request, tokens=None,
               home: Optional[int] = None, *, _replay: bool = False) -> int:
        """Place ``req`` on a replica; returns the replica index, or -1
        when the replica rejected it at admission (overflow policy) — a
        per-request outcome, never a cluster failure: the request is
        cancelled, telemetry counts it, and the loop goes on.

        ``_replay`` marks crash recovery: the request was already admitted
        once, so it re-enters as a migration (capacity shortfall truncates
        instead of rejecting) and keeps its original ``(origin, rid)``
        dedup stamp — re-stamping would let a post-replay steal count the
        same request's migration twice."""
        if not self._placeable:
            req.cancel()
            self.telemetry.record_cancelled(
                req, origin=self._origin.get(req.rid), now=self.now())
            if _replay:
                self.replay_failed_total += 1
            self._drop_tracking(req.rid, reason="cancelled")
            return -1
        idx = self.place(req, home, tokens)
        try:
            self.replicas[idx].submit(req, tokens, migrated=_replay)
        except AdmissionRejected:
            req.cancel()
            self.telemetry.record_rejected(
                req, origin=self._origin.get(req.rid, idx)
                if _replay else idx, now=self.now())
            if _replay:
                self.replay_failed_total += 1
            self._drop_tracking(req.rid, reason="rejected")
            return -1
        if req.rid not in self.outstanding:
            self.accepted_total += 1
        self.outstanding[req.rid] = req
        self._owner[req.rid] = idx
        if not _replay:
            self._origin[req.rid] = idx
        if tokens is not None:
            self._payloads[req.rid] = tokens
        if req.prefix_group is not None:
            self._group_home[req.prefix_group] = idx
        return idx

    def _drop_tracking(self, rid: int, reason: Optional[str] = None) -> None:
        tracked = self.outstanding.pop(rid, None) is not None
        self._owner.pop(rid, None)
        self._origin.pop(rid, None)
        self._payloads.pop(rid, None)
        if tracked and reason is not None:
            self.terminal_counts[reason] += 1

    # -- steal loop ----------------------------------------------------------
    def _nearest_order(self, thief_idx: int) -> List[int]:
        # cache is invalidated on membership change; dead replicas are
        # excluded at build time (draining ones stay — they are legitimate
        # victims, stealing is how they drain)
        order = self._victims_cache.get(thief_idx)
        if order is None:
            thief = self.replicas[thief_idx]
            order = sorted(
                (i for i in range(len(self.replicas))
                 if i != thief_idx and i not in self._dead),
                key=lambda i: (self.machine.distance(
                    thief.place, self.replicas[i].place), i))
            self._victims_cache[thief_idx] = order
        return order

    def _victim_order(self, thief_idx: int,
                      pool: Optional[Sequence[int]] = None) -> List[int]:
        """Victim candidates for ``thief_idx``, per policy.  ``pool``
        restricts to replicas known to have queued work (the router is a
        central coordinator — informed probing is allowed)."""
        pol = self.policy
        n = len(self.replicas)
        if pol.victim == "nearest":
            base = self._nearest_order(thief_idx)
            if pool is None:
                return base[:pol.probe]
            pooled = set(pool)
            return [i for i in base if i in pooled][:pol.probe]
        if pol.victim == "random":
            if pool is not None:
                cand = [i for i in pool
                        if i != thief_idx and i not in self._dead]
                if len(cand) > pol.probe:
                    cand = self.rng.sample(cand, pol.probe)
                return cand
            # blind probing: rejection-sample a few indices, no O(n) list
            picked: List[int] = []
            limit = min(pol.probe, n - 1 - len(self._dead))
            for _ in range(4 * pol.probe):
                if len(picked) >= limit:
                    break
                i = self.rng.randrange(n)
                if i != thief_idx and i not in picked \
                        and i not in self._dead:
                    picked.append(i)
            return picked
        # max_loaded: global argmax (the pool, or everyone)
        src = pool if pool is not None else range(n)
        return [i for i in src if i != thief_idx and i not in self._dead]

    def steal_for(self, thief_idx: int,
                  pool: Optional[Sequence[int]] = None) -> int:
        """One steal attempt on behalf of an idle replica.  Returns the
        number of requests migrated."""
        pol = self.policy
        if pol.amount == "none":
            return 0
        if thief_idx in self._dead or thief_idx in self._draining:
            return 0
        candidates = [i for i in self._victim_order(thief_idx, pool)
                      if not self.replicas[i].dead]
        if not candidates:
            return 0
        # rank by STEALABLE work (running requests cannot migrate, so a
        # backlog-heavy but queue-empty replica is not a victim), divided
        # by measured speed: a straggler's queue drains slower, so the
        # same token count is effectively heavier and it is robbed first
        victim_idx = max(
            candidates,
            key=lambda i: (self.replicas[i].waiting_weight()
                           / max(self._speed(i), 1e-6)))
        victim = self.replicas[victim_idx]
        if victim.waiting_count() == 0 or \
                victim.waiting_weight() < pol.min_victim_weight:
            return 0
        if pol.amount == "half_work":
            stolen = victim.steal_waiting(victim.waiting_weight() // 2)
        else:
            stolen = victim.steal_waiting_count(victim.waiting_count() // 2)
        if not stolen:
            return 0
        thief = self.replicas[thief_idx]
        for r, _ in stolen:
            r.cached_prefix = 0          # cache affinity does not travel
        thief.receive(stolen)
        weight = 0
        for r, _ in stolen:
            weight += r.est_remaining_work
            self._owner[r.rid] = thief_idx
        # (origin, rid) keys let telemetry dedupe: with chunked prefill the
        # same request can migrate again between chunks, and bare rids are
        # only unique per entry process
        self.telemetry.record_steal(
            victim_idx, thief_idx, len(stolen), weight,
            rids=[(self._origin.get(r.rid, victim_idx), r.rid)
                  for r, _ in stolen])
        return len(stolen)

    def steal_tick(self) -> int:
        """Every replica that wants work attempts one steal — the cluster
        analogue of the worker's steal loop.  No queued work anywhere →
        nothing to do (the fast path during drain)."""
        queued = [i for i, rep in enumerate(self.replicas)
                  if i not in self._dead and rep.waiting_count() > 0]
        self._check_retired()
        if not queued:
            return 0
        moved = 0
        for i in self._placeable:
            if self.replicas[i].wants_work():
                moved += self.steal_for(i, pool=queued)
        return moved

    # -- live driving (EngineReplica pools) ----------------------------------
    def step(self, steal_every: int = 2) -> int:
        """One cluster step in live mode: step every live engine, beat the
        heartbeat for each one that responded, run the steal loop
        periodically, harvest finished requests into telemetry.  A replica
        whose ``dead`` flag is set (killed engine) stops being stepped and
        stops beating — after the monitor's timeout it is declared dead
        and its in-flight requests replay on the survivors."""
        self._steps += 1
        active = 0
        responsive = []
        for i, rep in enumerate(self.replicas):
            if i in self._dead or rep.dead:
                continue
            if self.straggler is not None:
                t0 = time.monotonic()
                active += rep.step()
                dt = time.monotonic() - t0
                if dt > 0:
                    self.straggler.record_step(i, dt)
            else:
                active += rep.step()
            responsive.append(i)
        if self.heartbeat is not None:
            # Beat every responsive replica at the same instant, after the
            # whole loop: a sibling's slow step (e.g. a JIT compile) must
            # not age an earlier beat past the timeout.  Only a replica
            # that stops responding altogether times out.
            for i in responsive:
                self.heartbeat.beat(i)
            for h in self.heartbeat.dead_hosts():
                if h not in self._dead:
                    self.fail_replica(h)
        if self._steps % steal_every == 0:
            self.steal_tick()
        self.poll_finished()
        return active

    def poll_finished(self) -> None:
        now = self.now()
        done = []
        for rid, req in self.outstanding.items():
            if req.state == RequestState.DONE:
                owner = self._owner.get(rid)
                self._record_finish(req, owner)
                self._collect_spec(req, owner)
                done.append((rid, "finished"))
            elif req.state == RequestState.CANCELLED:
                self.telemetry.record_cancelled(
                    req, origin=self._origin.get(rid), now=now)
                done.append((rid, "cancelled"))
            elif req.state == RequestState.WAITING and \
                    req.deadline is not None and now > req.deadline:
                # expired while queued: the batcher will prune it and it
                # will never run — stop tracking it so drains terminate
                self.telemetry.record_expired(
                    req, origin=self._origin.get(rid), now=now)
                done.append((rid, "cancelled"))
        for rid, reason in done:
            self._drop_tracking(rid, reason=reason)
        self._check_retired()
        if self.debug_invariants:
            self.check()

    def _record_finish(self, req: Request,
                       replica_id: Optional[int] = None) -> None:
        self.telemetry.record_finish(
            req, req.finished_at if req.finished_at is not None
            else self.now(), replica_id, origin=self._origin.get(req.rid))

    def _collect_spec(self, req: Request,
                      replica_id: Optional[int]) -> None:
        """Pull a finished request's speculative-decoding totals off the
        replica that ran it, BEFORE the origin map drops the rid — the
        (origin, rid) key dedupes replays exactly like migrations."""
        if replica_id is None:
            return
        rec = self.replicas[replica_id].take_spec(req.rid)
        if rec is not None:
            self.telemetry.record_spec(
                replica_id, rec[0], rec[1],
                key=(self._origin.get(req.rid), req.rid))

    def on_finished(self, req: Request,
                    replica_id: Optional[int] = None) -> None:
        """Completion callback (the simulator pushes instead of polling)."""
        self._record_finish(req, replica_id)
        self._collect_spec(req, replica_id)
        self._drop_tracking(req.rid, reason="finished")
        self._check_retired()
        if self.debug_invariants:
            self.check()

    def drained(self) -> bool:
        """True when no request is outstanding and every live replica is
        idle (dead replicas are ignored — their work was replayed)."""
        return not self.outstanding and all(
            getattr(r, "drained", lambda: True)() is True
            for i, r in enumerate(self.replicas)
            if i not in self._dead)

    def run_until_drained(self, max_steps: int = 100_000,
                          steal_every: int = 2) -> None:
        for _ in range(max_steps):
            self.step(steal_every=steal_every)
            if self.drained():
                break

    # -- invariants ----------------------------------------------------------
    def check(self) -> None:
        """Assert the router's request-conservation invariants (the cluster
        analogue of ``BlockAllocator.check()``; auto-run after every
        step/poll/crash under ``debug_invariants``):

        * **population conservation** — every request ever admitted is
          accounted to exactly one of finished, cancelled, rejected or
          still in flight: ``accepted == finished + cancelled + rejected +
          in_flight`` (a skew means a request was lost or double-counted);
        * **crash-window conservation** — every request displaced by a
          crash was either replayed onto a survivor or reached a terminal
          outcome during replay: ``displaced == replayed + replay_failed``,
          and the router's replay count matches telemetry's;
        * **ownership** — every in-flight request has an owner and an
          origin stamp, and no non-terminal request is owned by a dead
          (tombstoned) replica.
        """
        t = self.terminal_counts
        terminal = t["finished"] + t["cancelled"] + t["rejected"]
        in_flight = len(self.outstanding)
        assert self.accepted_total == terminal + in_flight, \
            (f"request conservation violated: accepted "
             f"{self.accepted_total} != finished {t['finished']} + "
             f"cancelled {t['cancelled']} + rejected {t['rejected']} + "
             f"in_flight {in_flight}")
        assert self.displaced_total == (self.replayed_total
                                        + self.replay_failed_total), \
            (f"crash-window conservation violated: displaced "
             f"{self.displaced_total} != replayed {self.replayed_total} + "
             f"replay_failed {self.replay_failed_total}")
        assert self.replayed_total == self.telemetry.requests_replayed, \
            (f"replay accounting drifted from telemetry: "
             f"{self.replayed_total} != "
             f"{self.telemetry.requests_replayed}")
        for rid, req in self.outstanding.items():
            assert rid in self._owner, f"in-flight rid {rid} has no owner"
            assert rid in self._origin, \
                f"in-flight rid {rid} has no origin stamp"
            if req.state in (RequestState.WAITING, RequestState.PREFILL,
                             RequestState.RUNNING):
                assert self._owner[rid] not in self._dead, \
                    (f"non-terminal rid {rid} owned by dead replica "
                     f"{self._owner[rid]}")

    # -- health --------------------------------------------------------------
    def health(self) -> List[dict]:
        out = []
        for i, r in enumerate(self.replicas):
            if i in self._dead:
                out.append({"replica_id": r.replica_id, "place": r.place,
                            "dead": True})
            else:
                h = r.health()
                h["draining"] = i in self._draining
                out.append(h)
        return out
