"""Fault tolerance: heartbeats, straggler mitigation, checkpoint/restart.

Straggler mitigation is the paper's steal-half-work rule applied to input
shards: hosts report step durations, the detector computes relative speeds,
and the surplus work of slow hosts moves to fast ones via
``steal_half_transfers`` — identical decision procedure, different
granularity (data shards instead of tasks).

``TrainSupervisor`` wraps a train loop with failure recovery: on any
(including injected) failure it restores the latest checkpoint and resumes.
CPU tests verify bit-exact resume.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["HeartbeatMonitor", "StragglerDetector", "TrainSupervisor",
           "SimulatedFailure"]


class SimulatedFailure(RuntimeError):
    """Injected fault for testing the recovery path."""


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last_seen: Dict[int, float] = {}

    def beat(self, host: int) -> None:
        self.last_seen[host] = self.clock()

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]

    def alive_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, t in self.last_seen.items()
                if now - t <= self.timeout_s]


class StragglerDetector:
    """EWMA of per-host step durations; hosts slower than
    ``threshold ×`` median are stragglers.  ``mitigation_plan`` returns a
    shard-transfer matrix computed with the steal-half-work balancer."""

    def __init__(self, num_hosts: int, alpha: float = 0.3,
                 threshold: float = 1.5):
        self.num_hosts = num_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.ewma = np.zeros(num_hosts)
        self.seen = np.zeros(num_hosts, bool)

    def record_step(self, host: int, duration_s: float) -> None:
        if not self.seen[host]:
            self.ewma[host] = duration_s
            self.seen[host] = True
        else:
            self.ewma[host] = (self.alpha * duration_s
                               + (1 - self.alpha) * self.ewma[host])

    def grow(self, n: int = 1) -> None:
        """Autoscaled fleets add hosts mid-run; new hosts start unseen so
        they do not distort the median until they report steps."""
        if n <= 0:
            return
        self.num_hosts += n
        self.ewma = np.concatenate([self.ewma, np.zeros(n)])
        self.seen = np.concatenate([self.seen, np.zeros(n, bool)])

    def relative_speed(self, host: int) -> float:
        """Measured speed of ``host`` relative to the median host
        (1.0 = typical, < 1 = straggling).  Unseen hosts report 1.0 —
        the router's speed-aware victim ranking and cost-model placement
        treat them as typical until evidence arrives."""
        if not self.seen[host] or self.ewma[host] <= 0:
            return 1.0
        med = float(np.median(self.ewma[self.seen]))
        if med <= 0:
            return 1.0
        return med / float(self.ewma[host])

    def stragglers(self) -> List[int]:
        if not self.seen.all():
            return []
        med = np.median(self.ewma)
        return [h for h in range(self.num_hosts)
                if self.ewma[h] > self.threshold * med]

    def mitigation_plan(self, shards_per_host: np.ndarray) -> np.ndarray:
        """Given current shard counts per host, compute transfers [P, P]
        proportional to measured speed (1/ewma) — slow hosts shed half
        their surplus (the paper's steal rule)."""
        if not self.seen.all():
            return np.zeros((self.num_hosts, self.num_hosts))
        import torch
        from ..core.device.weighted_partition import steal_half_transfers
        # normalized load = shards × time-per-shard, balanced on the host:
        # the plan's inputs and outputs are numpy bookkeeping
        load = shards_per_host * self.ewma
        transfers, _ = steal_half_transfers(
            torch.as_tensor(load, dtype=torch.float32))
        t = transfers.numpy()
        # convert work-units back to shard counts (time-per-shard of the
        # *sending* host)
        with np.errstate(divide="ignore", invalid="ignore"):
            shards = np.where(self.ewma[:, None] > 0,
                              t / self.ewma[:, None], 0.0)
        return np.floor(shards)


class TrainSupervisor:
    """Checkpoint/restart wrapper.

    ``run(state, steps)`` calls ``step_fn(state, i) -> state`` for each
    global step, checkpointing every ``ckpt_every``; any exception triggers
    restore-from-latest and replay.  Deterministic step functions therefore
    yield bit-identical results to an uninterrupted run.
    """

    def __init__(self, manager, step_fn: Callable, state_template,
                 ckpt_every: int = 10, max_restarts: int = 5,
                 shardings=None,
                 on_restart: Optional[Callable[[int], None]] = None):
        self.manager = manager
        self.step_fn = step_fn
        self.template = state_template
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.shardings = shardings
        self.on_restart = on_restart
        self.restarts = 0

    def run(self, state, num_steps: int, start_step: int = 0):
        step = start_step
        while step < num_steps:
            try:
                state = self.step_fn(state, step)
                step += 1
                if step % self.ckpt_every == 0 or step == num_steps:
                    self.manager.save(step, state)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.manager.wait()
                state, manifest = self.manager.restore_latest(
                    self.template, self.shardings)
                step = manifest["step"]
                if self.on_restart:
                    self.on_restart(step)
        self.manager.wait()
        return state, step
