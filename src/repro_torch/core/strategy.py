# Copied from src/repro/core/strategy.py; only the imports may differ.
"""Scheduling strategies (the paper's Section 2).

A strategy is per-task metadata plus comparison behaviour that the scheduler
consults for:

* local execution order   (``prioritize``)
* steal order             (``steal_prioritize``)
* spawn-to-call           (``allow_call_conversion`` + ``transitive_weight``)
* steal-half-the-work     (``transitive_weight``)
* dead-task pruning       (``is_dead``)
* locality                (``place`` + machine distance)

Strategies form a single-rooted hierarchy (``BaseStrategy`` — the paper's
LIFO/FIFO strategy — at the root).  Tasks with the same concrete strategy type
are ordered by that type; tasks with different types are ordered by comparing
group heads under the *lowest common ancestor* type (children overrule
ancestors), which gives a total, well-defined order for arbitrary mixes —
the paper's composability property.
"""
from __future__ import annotations

import itertools
from typing import Optional

__all__ = [
    "BaseStrategy",
    "LifoFifoStrategy",
    "FifoStrategy",
    "PriorityStrategy",
    "DepthFirstStrategy",
    "RandomStealStrategy",
    "MergePolicy",
    "MergingStrategy",
    "lowest_common_ancestor",
    "local_before",
    "steal_before",
]

_spawn_counter = itertools.count()


class BaseStrategy:
    """Root of the strategy hierarchy: the standard LIFO/FIFO work-stealing
    order (local last-in-first-out, steal first-in-first-out), equivalent to
    the Arora et al. deque order.  This is the default strategy for tasks
    spawned without an explicit one.
    """

    __slots__ = ("place", "spawn_seq", "transitive_weight")

    def __init__(self, transitive_weight: int = 1, place: Optional[int] = None):
        # ``place`` defaults to the spawning place; the scheduler fills it in
        # at spawn time if the strategy was constructed outside a worker.
        self.place = place
        self.spawn_seq = next(_spawn_counter)
        self.transitive_weight = max(1, int(transitive_weight))

    # -- ordering ---------------------------------------------------------
    def prioritize(self, other: "BaseStrategy") -> bool:
        """True iff the task owning ``self`` should execute before ``other``
        locally.  Root semantics: LIFO."""
        return self.spawn_seq > other.spawn_seq

    def steal_prioritize(self, other: "BaseStrategy") -> bool:
        """True iff ``self`` should be *stolen* before ``other``.  Root
        semantics: FIFO (steal the oldest → closest to the task-graph root,
        generating the most local work for the thief)."""
        return self.spawn_seq < other.spawn_seq

    # -- spawn-to-call ----------------------------------------------------
    def allow_call_conversion(self) -> bool:
        """Call conversion is disabled by default (paper Section 2)."""
        return False

    # -- dead tasks -------------------------------------------------------
    def is_dead(self) -> bool:
        return False

    # -- misc -------------------------------------------------------------
    def set_transitive_weight(self, w: int) -> None:
        self.transitive_weight = max(1, int(w))

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"{type(self).__name__}(place={self.place}, "
                f"seq={self.spawn_seq}, w={self.transitive_weight})")


#: The paper names the root strategy "LIFO/FIFO"; alias for readability.
LifoFifoStrategy = BaseStrategy


class FifoStrategy(BaseStrategy):
    """First-in-first-out for local execution as well as stealing."""

    __slots__ = ()

    def prioritize(self, other: BaseStrategy) -> bool:
        return self.spawn_seq < other.spawn_seq


class PriorityStrategy(BaseStrategy):
    """Generic user-priority strategy: smaller ``priority`` value runs first
    (best-first search order).  Steal order defaults to the same; subclass to
    change (e.g. :class:`RandomStealStrategy`)."""

    # Per-instance opt-in to call conversion without needing a subclass.
    __slots__ = ("priority", "_allow_calls")

    def __init__(self, priority: float, transitive_weight: int = 1,
                 allow_calls: bool = False, place: Optional[int] = None):
        super().__init__(transitive_weight=transitive_weight, place=place)
        self.priority = priority
        self._allow_calls = allow_calls

    def prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, PriorityStrategy):
            if self.priority != other.priority:
                return self.priority < other.priority
            return self.spawn_seq > other.spawn_seq
        return super().prioritize(other)

    def steal_prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, PriorityStrategy):
            if self.priority != other.priority:
                return self.priority < other.priority
        return super().steal_prioritize(other)

    def allow_call_conversion(self) -> bool:
        return self._allow_calls


class RandomStealStrategy(PriorityStrategy):
    """Best-first locally, *random* steal order (paper's SSSP strategy:
    stealing all the promising tasks would starve the owner, so thieves take
    random ones).  The random key is drawn once per instance."""

    __slots__ = ("steal_key",)

    def __init__(self, priority: float, steal_key: float,
                 transitive_weight: int = 1, allow_calls: bool = False,
                 place: Optional[int] = None):
        super().__init__(priority, transitive_weight=transitive_weight,
                         allow_calls=allow_calls, place=place)
        self.steal_key = steal_key

    def steal_prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, RandomStealStrategy):
            return self.steal_key < other.steal_key
        return super().steal_prioritize(other)


class DepthFirstStrategy(BaseStrategy):
    """The paper's Algorithm 1: depth-first for locally spawned tasks,
    breadth-first for tasks spawned elsewhere; transitive weight exponential
    in remaining height; call conversion enabled."""

    __slots__ = ("depth",)

    def __init__(self, depth: int, max_depth: int, place: Optional[int] = None,
                 weight_cap: int = 60):
        super().__init__(place=place)
        self.depth = depth
        h = min(max(0, max_depth - depth), weight_cap)
        self.set_transitive_weight(1 << h)

    def allow_call_conversion(self) -> bool:
        return True

    def prioritize(self, other: BaseStrategy) -> bool:
        if not isinstance(other, DepthFirstStrategy):
            return super().prioritize(other)
        here = _current_place_id()
        mine, theirs = self.place == here, other.place == here
        if mine and theirs:
            return self.depth > other.depth      # both local: depth-first
        if mine:
            return True                           # prefer local task
        if theirs:
            return False
        return self.depth < other.depth           # both remote: breadth-first

    def steal_prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, DepthFirstStrategy):
            return self.depth < other.depth       # steal near the root
        return super().steal_prioritize(other)


# --------------------------------------------------------------------------
# Dynamic task merging (the paper's task-merging optimization)
# --------------------------------------------------------------------------

class MergePolicy:
    """Merge-threshold policy shared by the scheduler's ``spawn_many`` and
    the serving batcher's request admission: how many consecutive small
    spawns (or prefills) to coalesce into one unit, given how much
    parallelism the local queue already holds.

    An empty queue means every spawned task may be needed for parallelism,
    so nothing is merged; once ``queue_depth`` tasks are already queued,
    coalescing up to ``depth_factor * queue_depth`` (capped at
    ``max_chunk``) spawns into a single looped task trades parallelism
    nobody would have consumed for far less queue churn."""

    __slots__ = ("min_chunk", "max_chunk", "depth_factor")

    def __init__(self, min_chunk: int = 1, max_chunk: int = 64,
                 depth_factor: float = 1.0):
        self.min_chunk = max(1, int(min_chunk))
        self.max_chunk = max(1, int(max_chunk))
        self.depth_factor = depth_factor

    def chunk_size(self, queue_depth: int, remaining: int) -> int:
        """Units to coalesce given ``queue_depth`` ready units already
        queued locally and ``remaining`` units still to enqueue."""
        c = int(queue_depth * self.depth_factor)
        if c < self.min_chunk:
            c = self.min_chunk
        elif c > self.max_chunk:
            c = self.max_chunk
        return c if c < remaining else remaining

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"MergePolicy(min_chunk={self.min_chunk}, "
                f"max_chunk={self.max_chunk}, "
                f"depth_factor={self.depth_factor})")


class MergingStrategy(BaseStrategy):
    """Strategy of a merged chunk task (``spawn_many``): carries the
    *representative* strategy of the coalesced run (its first task's) plus
    the number of merged spawns and their summed transitive weight.

    Ordering is fully delegated to the representative:
    :func:`local_before`/:func:`steal_before` unwrap a ``MergingStrategy``
    to ``rep`` before comparing, and task storage groups chunk tasks under
    ``type(rep)`` — so a chunk of e.g. ascending-block prefix-sum tasks
    sorts among unmerged blocks exactly where its first block would, and a
    single-strategy-type workload stays on the homogeneous fast path."""

    __slots__ = ("rep", "merged_count")

    def __init__(self, rep: BaseStrategy, merged_count: int,
                 total_weight: Optional[int] = None):
        super().__init__(
            transitive_weight=(total_weight if total_weight is not None
                               else rep.transitive_weight * merged_count),
            place=rep.place)
        self.rep = rep
        self.merged_count = merged_count

    def allow_call_conversion(self) -> bool:
        return False          # a chunk is already batched work

    def is_dead(self) -> bool:
        return self.rep.is_dead()

    def prioritize(self, other: BaseStrategy) -> bool:
        return local_before(self.rep, other)

    def steal_prioritize(self, other: BaseStrategy) -> bool:
        return steal_before(self.rep, other)


# --------------------------------------------------------------------------
# Composition machinery
# --------------------------------------------------------------------------

def lowest_common_ancestor(a: type, b: type) -> type:
    """Lowest common ancestor of two strategy classes in the (single-rooted)
    strategy hierarchy.  Because the hierarchy is Python's class hierarchy
    below ``BaseStrategy`` the LCA is the first class in ``a``'s MRO that is a
    base of ``b``."""
    if a is b:
        return a
    for cls in a.__mro__:
        if issubclass(b, cls) and issubclass(cls, BaseStrategy):
            return cls
    return BaseStrategy


def local_before(a: BaseStrategy, b: BaseStrategy) -> bool:
    """Total local-execution order across arbitrary strategy types.

    Merged chunks compare as their representative strategy.  Same concrete
    type → that type's ``prioritize`` (children overrule ancestors).
    Different types → the LCA type's ``prioritize`` applied to both
    instances (every strategy carries the base fields the ancestor
    comparisons need)."""
    ta, tb = type(a), type(b)
    if ta is MergingStrategy:
        a = a.rep
        ta = type(a)
    if tb is MergingStrategy:
        b = b.rep
        tb = type(b)
    cls = ta if ta is tb else lowest_common_ancestor(ta, tb)
    return cls.prioritize(a, b)


def steal_before(a: BaseStrategy, b: BaseStrategy) -> bool:
    """Total steal order across arbitrary strategy types (see
    :func:`local_before`)."""
    ta, tb = type(a), type(b)
    if ta is MergingStrategy:
        a = a.rep
        ta = type(a)
    if tb is MergingStrategy:
        b = b.rep
        tb = type(b)
    cls = ta if ta is tb else lowest_common_ancestor(ta, tb)
    return cls.steal_prioritize(a, b)


# --------------------------------------------------------------------------
# Place context (filled by the scheduler; import-cycle-free)
# --------------------------------------------------------------------------

def _place_getter():
    return None


def _register_place_getter(fn) -> None:
    global _place_getter
    _place_getter = fn


def _current_place_id() -> Optional[int]:
    return _place_getter()


def get_place() -> Optional[int]:
    """Paper's ``Environment::get_place()`` — the place id of the calling
    worker thread, or ``None`` outside the scheduler."""
    return _place_getter()
