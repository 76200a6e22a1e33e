# Copied from src/repro/core/machine.py; only the imports may differ.
"""Abstract machine model: a balanced tree of places.

The paper gathers the CPU topology with hwloc; leaves are processing units,
inner nodes group processors sharing a memory-hierarchy level.  For TPU
deployments the levels are (chip, host, pod, superpod) and "memory distance"
counts tree hops — same-host < same-pod (ICI) < cross-pod (DCN).  The
scheduler uses distance both for locality-aware strategies and for
steal-from-neighbours-first victim ordering.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass(frozen=True)
class MachineModel:
    """Balanced tree over ``num_places`` leaves described by ``arity`` per
    level, leaves-last.  E.g. ``arity=(2, 4)`` = 2 groups ("pods") of 4
    places each."""

    num_places: int
    arity: Tuple[int, ...] = field(default=())

    def __post_init__(self):
        if self.arity:
            n = 1
            for a in self.arity:
                n *= a
            if n != self.num_places:
                raise ValueError(
                    f"arity {self.arity} describes {n} leaves, expected "
                    f"{self.num_places}")

    # -- distances ---------------------------------------------------------
    def level_path(self, place: int) -> Tuple[int, ...]:
        """Group index of ``place`` at each level, root-first."""
        if not self.arity:
            return (place,)
        path = []
        span = self.num_places
        rem = place
        for a in self.arity:
            span //= a
            path.append(rem // span)
            rem %= span
        return tuple(path)

    def distance(self, a: int, b: int) -> int:
        """Memory distance = 2 × (tree height above the LCA of a and b)."""
        if a == b:
            return 0
        pa, pb = self.level_path(a), self.level_path(b)
        depth = len(pa)
        for i in range(depth):
            if pa[i] != pb[i]:
                return 2 * (depth - i)
        return 0

    def victims_by_distance(self, place: int) -> List[int]:
        """All other places ordered nearest-first (stable within a ring)."""
        others = [p for p in range(self.num_places) if p != place]
        others.sort(key=lambda p: (self.distance(place, p),
                                   (p - place) % self.num_places))
        return others


def flat_machine(num_places: int) -> MachineModel:
    return MachineModel(num_places=num_places, arity=(num_places,) if num_places else ())


def pod_machine(num_pods: int, places_per_pod: int) -> MachineModel:
    return MachineModel(num_places=num_pods * places_per_pod,
                        arity=(num_pods, places_per_pod))
