# Copied from src/repro/cluster/chaos.py; only the imports may differ.
"""Fault-injection schedules and non-stationary arrival patterns.

Everything here is a frozen, seed-deterministic *description*: the
simulator (``cluster.sim.Simulation``) turns crash/slowdown events into
calendar entries and ``synthetic_requests`` thins a max-rate Poisson draw
against the arrival pattern's rate multiplier.  Keeping chaos as data —
not callbacks — is what makes the benchmark reproducible: the same
schedule object replayed under the same seed yields an identical event
trace, which CI relies on.

Crash semantics: the dead replica's KV cache and prefix cache die with it.
Displaced requests replay from a cold start on a surviving replica, where
admission re-probes that replica's prefix cache — a prefix chain the dead
replica had *published* via earlier shared-prefix traffic is re-adopted
and only the uncached remainder re-prefills.

Slowdown semantics: a straggler serves at ``factor ×`` its normal rate
(``factor < 1`` = slower) for ``duration`` seconds.  The router's
speed-aware victim ranking treats its queue as proportionally heavier, so
steal-half-work drains stragglers first — the paper's mitigation rule at
cluster granularity.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Tuple

__all__ = ["CrashEvent", "SlowdownEvent", "ChaosSchedule",
           "FlashCrowd", "ArrivalPattern"]


@dataclass(frozen=True)
class CrashEvent:
    """Replica ``replica`` dies at sim time ``t`` (fail-stop, no warning)."""

    t: float
    replica: int


@dataclass(frozen=True)
class SlowdownEvent:
    """Replica ``replica`` serves at ``factor ×`` normal speed from ``t``
    for ``duration`` seconds (``factor < 1`` = straggler)."""

    t: float
    replica: int
    factor: float = 0.25
    duration: float = 10.0

    def __post_init__(self):
        if self.factor <= 0:
            raise ValueError("slowdown factor must be positive")


@dataclass(frozen=True)
class ChaosSchedule:
    """A fixed fault plan: what dies and what straggles, when."""

    crashes: Tuple[CrashEvent, ...] = ()
    slowdowns: Tuple[SlowdownEvent, ...] = ()

    @staticmethod
    def random(num_replicas: int, duration: float, *,
               crashes: int = 0, slowdowns: int = 0,
               slow_factor: float = 0.25, slow_duration: float = 10.0,
               seed: int = 0) -> "ChaosSchedule":
        """Seeded random plan: fault times land in the middle 60% of the
        run (faults at the very start hit an empty fleet, faults at the
        very end hit a drained one — neither stresses recovery), victims
        are distinct replicas drawn from the *initial* fleet."""
        rng = random.Random(seed)
        n = min(crashes + slowdowns, num_replicas)
        victims = rng.sample(range(num_replicas), n)
        evs_c = tuple(
            CrashEvent(t=duration * rng.uniform(0.2, 0.8), replica=v)
            for v in victims[:crashes])
        evs_s = tuple(
            SlowdownEvent(t=duration * rng.uniform(0.2, 0.8), replica=v,
                          factor=slow_factor, duration=slow_duration)
            for v in victims[crashes:])
        return ChaosSchedule(
            crashes=tuple(sorted(evs_c, key=lambda e: e.t)),
            slowdowns=tuple(sorted(evs_s, key=lambda e: e.t)))


@dataclass(frozen=True)
class FlashCrowd:
    """Arrival-rate spike: ``multiplier ×`` base rate over
    ``[start, start + duration)``."""

    start: float
    duration: float
    multiplier: float = 3.0


@dataclass(frozen=True)
class ArrivalPattern:
    """Time-varying arrival-rate multiplier: a diurnal sinusoid
    (``1 + amplitude * sin(2π t / period)``) times any active flash
    crowds.  ``multiplier(t)`` is what the thinning sampler accepts
    against; ``peak`` upper-bounds it so the max-rate Poisson draw
    dominates the target process."""

    diurnal_amplitude: float = 0.0     # 0..1 fraction of the base rate
    diurnal_period: float = 0.0        # seconds of sim time; 0 = flat
    flash_crowds: Tuple[FlashCrowd, ...] = ()

    def __post_init__(self):
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")

    def multiplier(self, t: float) -> float:
        m = 1.0
        if self.diurnal_period > 0:
            m *= 1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / self.diurnal_period)
        for fc in self.flash_crowds:
            if fc.start <= t < fc.start + fc.duration:
                m *= fc.multiplier
        return max(m, 0.0)

    @property
    def peak(self) -> float:
        """Upper bound on ``multiplier`` (crowds may overlap, so the
        bound multiplies every crowd's contribution)."""
        m = 1.0 + self.diurnal_amplitude
        for fc in self.flash_crowds:
            m *= max(fc.multiplier, 1.0)
        return m
