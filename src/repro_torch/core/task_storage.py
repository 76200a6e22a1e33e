# Copied from src/repro/core/task_storage.py; only the imports may differ.
"""Per-place task storage (the paper's Section 3.1).

Two implementations:

* :class:`StrategyTaskStorage` — a priority storage supporting a different
  order per accessing place: the **owner's** priority order is maintained
  eagerly (updated on every push), while each **stealer's** order is evaluated
  lazily — a cached heap per stealer, extended with newly pushed tasks at the
  next steal attempt (exactly the design sketched in the paper; our
  implementation is fine-grained-locked rather than lock-free — the lock-free
  variant was out of the paper's scope as well).

  Composability: tasks are grouped per concrete strategy type (merged chunks
  group under their representative's type); each group is a heap in that
  type's order; the storage-wide head is picked by comparing group heads
  under the lowest-common-ancestor strategy (children overrule ancestors).

  Hot-path fast paths (this is the scheduler's innermost loop):

  - **homogeneous mode** — while only one strategy type is live, push and
    pop skip the group dict lookup and the cross-group LCA comparison
    entirely (one cached group pointer, one heap op);
  - **item freelists** — ``_OwnerItem``/``_StealItem`` wrappers are slot
    objects recycled through per-storage freelists instead of being
    reallocated on every push/refresh;
  - **incremental steal views** — the push log carries monotone sequence
    numbers, so ``_compact`` just drops stale log entries; stealer views
    keep their heaps (stale items are skipped lazily at pop time) and are
    only filtered/re-heapified when they are mostly garbage, instead of
    being rebuilt from scratch on every compaction.

* :class:`DequeTaskStorage` — baseline Arora-style work-stealing deque:
  owner LIFO, stealer FIFO, oblivious to strategies.  Keeps O(1) live
  ``ready_count``/``ready_weight`` counters (entries whose task is observed
  no longer READY are discounted as they are discarded), so steal probes
  don't chase queues holding only stale entries.

A task resides in exactly one storage; its ``state`` changes only under that
storage's lock, so steal-view entries that went stale (task executed, stolen
or re-homed) are skipped at pop time by checking residency + state.
"""
from __future__ import annotations

import heapq
import threading
from bisect import bisect_left
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .strategy import MergingStrategy, local_before, steal_before
from .task import Task, TaskState

PruneCallback = Callable[[Task], None]

#: compact the push log once it exceeds this length and is ≥ 3/4 stale.
_COMPACT_LOG_LEN = 256
#: filter a steal-view heap only when it is this many times larger than the
#: live task count (rare; the common compaction leaves views untouched).
_VIEW_GC_FACTOR = 4


class _OwnerItem:
    __slots__ = ("task",)

    def __init__(self, task: Optional[Task]):
        self.task = task

    def __lt__(self, other: "_OwnerItem") -> bool:
        return local_before(self.task.strategy, other.task.strategy)


class _StealItem:
    __slots__ = ("task",)

    def __init__(self, task: Optional[Task]):
        self.task = task

    def __lt__(self, other: "_StealItem") -> bool:
        return steal_before(self.task.strategy, other.task.strategy)


class _StealView:
    """Lazily evaluated steal-priority view cached per stealer place.
    ``watermark`` is a push *sequence number* (not a log index), so
    compacting the log never invalidates it."""

    __slots__ = ("watermark", "heap")

    def __init__(self):
        self.watermark = 0
        self.heap: List[_StealItem] = []


def _group_type(task: Task) -> type:
    """Grouping key: merged chunks live in their representative's group so
    chunk order composes with unmerged tasks of the same strategy (and a
    merged single-strategy workload stays homogeneous)."""
    strategy = task.strategy
    t = type(strategy)
    if t is MergingStrategy:
        return type(strategy.rep)
    return t


class StrategyTaskStorage:
    def __init__(self, place_id: int, on_prune: Optional[PruneCallback] = None):
        self.place_id = place_id
        self._lock = threading.Lock()
        self._groups: Dict[type, List[_OwnerItem]] = {}
        # Homogeneous fast path: while exactly one group exists, push/pop
        # bypass the dict and the cross-group comparison.
        self._sole_type: Optional[type] = None
        self._sole_group: Optional[List[_OwnerItem]] = None
        self._log: List[Task] = []          # append-only push log for stealers
        self._log_seq: List[int] = []       # parallel monotone sequence nums
        self._push_seq = 0
        self._views: Dict[int, _StealView] = {}
        self._ready = 0
        self._ready_weight = 0
        self._on_prune = on_prune
        self._owner_free: List[_OwnerItem] = []
        self._steal_free: List[_StealItem] = []
        # conservation ledger: every residency that ever entered this
        # storage is accounted to exactly one of executed (claimed by a
        # pop/steal/claim), pruned (dead on sight) or still-ready.
        self.pushed_total = 0
        self.executed_total = 0
        self.pruned_total = 0

    # -- helpers (hold lock) ------------------------------------------------
    def _resident(self, task: Task) -> bool:
        return task.state == TaskState.READY and task._storage is self

    def _claim(self, task: Task) -> None:
        task.state = TaskState.CLAIMED
        self._ready -= 1
        self._ready_weight -= task.strategy.transitive_weight
        self.executed_total += 1

    def _prune(self, task: Task) -> None:
        task.state = TaskState.DEAD
        self._ready -= 1
        self._ready_weight -= task.strategy.transitive_weight
        self.pruned_total += 1
        if self._on_prune is not None:
            self._on_prune(task)

    def _valid_head(self, heap: list, free: list) -> Optional[Task]:
        """Pop stale/dead entries until the head is a live resident task (or
        the heap empties).  Dead tasks are pruned on sight — the paper's
        'removed early and will not be stolen'.  Discarded wrappers are
        recycled through ``free``."""
        while heap:
            item = heap[0]
            task = item.task
            if not self._resident(task):
                heapq.heappop(heap)
                item.task = None
                free.append(item)
                continue
            if task.strategy.is_dead():
                heapq.heappop(heap)
                item.task = None
                free.append(item)
                self._prune(task)
                continue
            return task
        return None

    def _recycle_owner(self, item: _OwnerItem) -> None:
        item.task = None
        self._owner_free.append(item)

    # -- owner API -----------------------------------------------------------
    def push(self, task: Task) -> None:
        with self._lock:
            task._storage = self
            task.state = TaskState.READY
            t = _group_type(task)
            if t is self._sole_type:
                group = self._sole_group           # homogeneous fast path
            else:
                group = self._groups.get(t)
                if group is None:
                    group = self._groups[t] = []
                if len(self._groups) == 1:
                    self._sole_type, self._sole_group = t, group
                else:
                    self._sole_type = self._sole_group = None
            free = self._owner_free
            if free:
                item = free.pop()
                item.task = task
            else:
                item = _OwnerItem(task)
            heapq.heappush(group, item)
            self._log.append(task)
            self._log_seq.append(self._push_seq)
            self._push_seq += 1
            self._ready += 1
            self._ready_weight += task.strategy.transitive_weight
            self.pushed_total += 1

    def pop_local(self) -> Optional[Task]:
        with self._lock:
            group = self._sole_group
            if group is not None:
                # Homogeneous fast path: no dict scan, no LCA comparison.
                task = self._valid_head(group, self._owner_free)
                if task is None:
                    return None
                self._recycle_owner(heapq.heappop(group))
                self._claim(task)
                return task
            best_task: Optional[Task] = None
            best_group = None
            for t in list(self._groups):
                g = self._groups[t]
                head = self._valid_head(g, self._owner_free)
                if head is None:
                    if not g:
                        del self._groups[t]     # retired strategy type
                    continue
                if best_task is None or local_before(head.strategy,
                                                     best_task.strategy):
                    best_task, best_group = head, g
            if len(self._groups) == 1:          # collapsed back to one type
                (self._sole_type, self._sole_group), = self._groups.items()
            if best_task is None:
                return None
            self._recycle_owner(heapq.heappop(best_group))
            self._claim(best_task)
            return best_task

    # -- stealer API ----------------------------------------------------------
    def steal_batch(self, stealer_id: int, *, half_work: bool = True,
                    max_tasks: Optional[int] = None,
                    target_weight: Optional[int] = None
                    ) -> Tuple[List[Task], int]:
        """Steal in the stealer's (lazily cached) steal-priority order until
        half the *weighted* work has moved (``half_work=True``) or half the
        task count (``half_work=False``).  Returns (tasks, weight).

        Either mode moves at most ``max(1, ready // 2)`` tasks per
        transaction: a degenerate weight distribution (e.g. every task at
        weight 0, making ``target_weight`` 0) can therefore never drain the
        victim's whole queue in one steal.

        ``target_weight`` overrides the half-the-work target with an explicit
        weight goal (the serving batcher's cross-replica migration API, where
        the router computes the surplus itself).  An explicit target lifts the
        half-count clamp — the caller asked for that much work, so the steal
        may drain the queue — and ``target_weight <= 0`` steals nothing."""
        with self._lock:
            if self._ready == 0 or \
                    (target_weight is not None and target_weight <= 0):
                return [], 0
            view = self._views.get(stealer_id)
            if view is None:
                view = self._views[stealer_id] = _StealView()
            # Lazy refresh: only now are newly pushed tasks ordered for this
            # stealer.  The watermark is a sequence number; bisect finds
            # where the (possibly compacted) log resumes.
            log, seqs = self._log, self._log_seq
            start = bisect_left(seqs, view.watermark)
            heap, free = view.heap, self._steal_free
            for i in range(start, len(log)):
                task = log[i]
                if self._resident(task):
                    if free:
                        item = free.pop()
                        item.task = task
                    else:
                        item = _StealItem(task)
                    heapq.heappush(heap, item)
            view.watermark = self._push_seq

            # Weight target: half the queued work.  Count clamp: never more
            # than half the queued tasks (min 1), whichever bites first.
            if target_weight is None:
                target_weight = max(1, self._ready_weight // 2)
                target_count = max(1, self._ready // 2)
            else:
                target_count = self._ready
            if max_tasks is not None:
                target_count = min(target_count, max_tasks)

            stolen: List[Task] = []
            weight = 0
            # max_tasks=0 must steal nothing (the deque storage already
            # honors this); the loop below claims before checking the clamp.
            if target_count <= 0:
                return stolen, weight
            while heap:
                task = self._valid_head(heap, free)
                if task is None:
                    break
                item = heapq.heappop(heap)
                item.task = None
                free.append(item)
                self._claim(task)
                stolen.append(task)
                weight += task.strategy.transitive_weight
                # Terminate as soon as half the work (by weight) has been
                # transferred — possibly after a single heavy task — or
                # after half the tasks (always, in count mode; as a clamp,
                # in weight mode).
                if len(stolen) >= target_count:
                    break
                if half_work and weight >= target_weight:
                    break
            # Compact the log when mostly stale to bound memory.
            if len(log) > _COMPACT_LOG_LEN and self._ready < len(log) // 4:
                self._compact()
            return stolen, weight

    def _compact(self) -> None:
        """Drop stale entries from the push log.  Sequence numbers make this
        invisible to stealer views: their watermarks stay valid and their
        heaps are kept as-is (stale items are skipped lazily) — only a view
        that is mostly garbage is filtered, and only then re-heapified."""
        log, seqs = self._log, self._log_seq
        keep = [i for i, t in enumerate(log) if self._resident(t)]
        self._log = [log[i] for i in keep]
        self._log_seq = [seqs[i] for i in keep]
        free = self._steal_free
        for view in self._views.values():
            heap = view.heap
            if len(heap) > 64 and len(heap) > _VIEW_GC_FACTOR * self._ready:
                live: List[_StealItem] = []
                for item in heap:
                    if self._resident(item.task):
                        live.append(item)
                    else:
                        item.task = None
                        free.append(item)
                heapq.heapify(live)
                view.heap = live

    def claim(self, task: Task) -> bool:
        """Claim one specific resident task (remove it from the storage's
        accounting; heap/log entries go stale and are skipped lazily).  Used
        by callers that need an ordering the steal heap does not provide —
        e.g. the serving batcher's oldest-first FIFO-steal baseline.  Dead
        tasks are pruned, not claimed.  Returns True iff claimed."""
        with self._lock:
            if not self._resident(task):
                return False
            if task.strategy.is_dead():
                self._prune(task)
                return False
            self._claim(task)
            return True

    # -- invariants ------------------------------------------------------------
    def check(self) -> None:
        """Assert the storage's structural and conservation invariants (the
        task-storage analogue of ``paged_kv.BlockAllocator.check()``; the
        interleaving explorer and the hot-path tests call this after every
        step):

        * **conservation** — ``pushed == executed + dead_pruned + in_storage``:
          every residency that ever entered is accounted to exactly one
          outcome, so no task is lost and none is delivered twice;
        * **counter consistency** — ``ready_count``/``ready_weight`` match a
          full scan of the resident tasks in the owner heaps;
        * **grouping** — every resident owner item sits in the group of its
          strategy's concrete type (merged chunks under their
          representative's), and the homogeneous-fast-path cache points at
          the sole group when it is set;
        * **push-log consistency** — the log and its sequence numbers stay
          parallel, strictly monotone, and cover every resident task (a
          resident a stealer could never see is a lost task in waiting);
        * **freelist hygiene** — recycled wrappers hold no task reference.
        """
        with self._lock:
            resident: Dict[int, Task] = {}
            for t, group in self._groups.items():
                for item in group:
                    task = item.task
                    assert task is not None, "owner heap holds recycled item"
                    if self._resident(task):
                        resident[id(task)] = task
                        assert _group_type(task) is t, \
                            (f"task grouped under {t.__name__} but its "
                             f"strategy groups as "
                             f"{_group_type(task).__name__}")
            assert self._ready == len(resident), \
                (f"ready_count skew: counter {self._ready} != "
                 f"{len(resident)} resident tasks in the owner heaps")
            weight = sum(t.strategy.transitive_weight
                         for t in resident.values())
            assert self._ready_weight == weight, \
                (f"ready_weight skew: counter {self._ready_weight} != "
                 f"{weight} summed over resident tasks")
            assert self.pushed_total == (self.executed_total
                                         + self.pruned_total + self._ready), \
                (f"conservation violated: pushed {self.pushed_total} != "
                 f"executed {self.executed_total} + pruned "
                 f"{self.pruned_total} + in_storage {self._ready}")
            log, seqs = self._log, self._log_seq
            assert len(log) == len(seqs), "push log and seq nums diverged"
            assert all(a < b for a, b in zip(seqs, seqs[1:])), \
                "push-log sequence numbers not strictly increasing"
            assert not seqs or seqs[-1] < self._push_seq
            in_log = {id(t) for t in log if self._resident(t)}
            assert set(resident) <= in_log, \
                "resident task missing from the push log (invisible to " \
                "stealers: a lost task in waiting)"
            assert in_log <= set(resident), \
                "push log holds a resident task absent from the owner " \
                "heaps (compaction resurrected a claimed task)"
            for view in self._views.values():
                assert view.watermark <= self._push_seq
            assert all(i.task is None for i in self._owner_free), \
                "owner freelist wrapper still references a task"
            assert all(i.task is None for i in self._steal_free), \
                "steal freelist wrapper still references a task"
            if self._sole_group is not None:
                assert len(self._groups) == 1 and \
                    self._groups.get(self._sole_type) is self._sole_group, \
                    "homogeneous fast-path cache points at a stale group"

    # -- introspection ---------------------------------------------------------
    @property
    def ready_count(self) -> int:
        return self._ready

    @property
    def ready_weight(self) -> int:
        return self._ready_weight

    def __len__(self) -> int:
        return self._ready


class DequeTaskStorage:
    """Baseline Arora-style deque: owner pops LIFO, thieves take FIFO.
    Strategy-oblivious (priority, weight and deadness are ignored, matching a
    standard work-stealing scheduler).  ``ready_count``/``ready_weight`` are
    O(1) live counters rather than ``len(deque)``/a full scan: entries whose
    task turns out to be CLAIMED/DEAD are discounted when discarded, so
    thieves don't keep probing a victim holding only stale entries."""

    def __init__(self, place_id: int, on_prune: Optional[PruneCallback] = None,
                 steal_half_count: bool = False):
        self.place_id = place_id
        self._lock = threading.Lock()
        self._dq: deque = deque()
        self._steal_half_count = steal_half_count
        self._ready = 0
        self._ready_weight = 0
        # conservation ledger (see StrategyTaskStorage): the deque never
        # prunes dead tasks itself, but entries whose task was claimed or
        # killed behind its back are discounted as stale when discarded.
        self.pushed_total = 0
        self.executed_total = 0
        self.stale_discarded_total = 0

    def _discard(self, task: Task) -> None:
        """Account for an entry leaving the deque (claimed or stale)."""
        self._ready -= 1
        self._ready_weight -= task.strategy.transitive_weight

    def push(self, task: Task) -> None:
        with self._lock:
            task._storage = self
            task.state = TaskState.READY
            self._dq.append(task)
            self._ready += 1
            self._ready_weight += task.strategy.transitive_weight
            self.pushed_total += 1

    def pop_local(self) -> Optional[Task]:
        with self._lock:
            while self._dq:
                task = self._dq.pop()
                self._discard(task)
                if task.state == TaskState.READY:
                    task.state = TaskState.CLAIMED
                    self.executed_total += 1
                    return task
                self.stale_discarded_total += 1
            return None

    def steal_batch(self, stealer_id: int, *, half_work: bool = False,
                    max_tasks: Optional[int] = None) -> Tuple[List[Task], int]:
        del half_work  # oblivious baseline: steals 1 task (or half the count)
        with self._lock:
            if self._ready == 0:
                return [], 0
            take = max(1, self._ready // 2) if self._steal_half_count else 1
            if max_tasks is not None:
                take = min(take, max_tasks)
            stolen: List[Task] = []
            weight = 0
            while self._dq and len(stolen) < take:
                task = self._dq.popleft()
                self._discard(task)
                if task.state != TaskState.READY:
                    self.stale_discarded_total += 1
                    continue
                task.state = TaskState.CLAIMED
                self.executed_total += 1
                stolen.append(task)
                weight += task.strategy.transitive_weight
            return stolen, weight

    # -- invariants ------------------------------------------------------------
    def check(self) -> None:
        """Assert the deque's conservation invariants: the live counters
        match the entries still queued (stale entries included — they are
        discounted only when observed), and every pushed entry is accounted
        to exactly one of executed, stale-discarded or still-queued."""
        with self._lock:
            assert self._ready == len(self._dq), \
                (f"ready_count skew: counter {self._ready} != "
                 f"{len(self._dq)} queued entries")
            weight = sum(t.strategy.transitive_weight for t in self._dq)
            assert self._ready_weight == weight, \
                (f"ready_weight skew: counter {self._ready_weight} != "
                 f"{weight} summed over queued entries")
            assert self.pushed_total == (self.executed_total
                                         + self.stale_discarded_total
                                         + len(self._dq)), \
                (f"conservation violated: pushed {self.pushed_total} != "
                 f"executed {self.executed_total} + stale "
                 f"{self.stale_discarded_total} + queued {len(self._dq)}")

    @property
    def ready_count(self) -> int:
        return self._ready

    @property
    def ready_weight(self) -> int:
        return self._ready_weight

    def __len__(self) -> int:
        return len(self._dq)
