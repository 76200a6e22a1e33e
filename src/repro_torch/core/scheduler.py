# Copied from src/repro/core/scheduler.py; only the imports may differ.
"""Strategy-aware work-stealing scheduler (the paper's Section 3).

Help-first policy: ``spawn`` enqueues the child into the spawning place's
priority task storage and the parent continues — required for priority
scheduling, because an execution-order decision can only be made once the
candidate tasks exist.  Synchronization is via X10-style finish regions whose
waiters *help* (execute queued/stolen tasks) instead of blocking.

Spawn-to-call: if a task's strategy allows conversion and its transitive
weight is at or below a dynamic threshold (by default: the number of tasks
already queued locally — plenty of parallelism available), the spawn becomes
a plain function call, trading excess parallelism for less queue churn.

Stealing: victims are visited nearest-first in the machine tree (or in random
order); a steal transaction takes tasks in the *stealer's* priority order and
terminates as soon as half the victim's *work* (sum of transitive weights)
has been transferred — for divide-and-conquer weights this often means one
task instead of half the task count.

Task merging: ``spawn_many`` coalesces runs of small same-strategy spawns
into single chunk tasks executed as a loop (the paper's dynamic
task-merging optimization); the chunk size follows the config's
:class:`~repro.core.strategy.MergePolicy`, growing with local queue depth so
merging never starves thieves of parallelism.

The baseline :class:`WorkStealingScheduler` uses Arora-style deques
(LIFO/FIFO, steal one) and ignores strategies, matching the paper's
"standard work-stealing" comparison bar.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

from .machine import MachineModel, flat_machine
from .metrics import SchedulerMetrics
from .strategy import (BaseStrategy, MergePolicy, MergingStrategy,
                       _register_place_getter)
from .task import FinishRegion, Task, TaskState
from .task_storage import DequeTaskStorage, StrategyTaskStorage

_tls = threading.local()


def _current_worker() -> Optional["_Worker"]:
    return getattr(_tls, "worker", None)


_register_place_getter(lambda: (w.place_id if (w := _current_worker()) else None))


def _run_chunk(fn: Callable, chunk: Sequence[tuple]) -> None:
    """Body of a merged chunk task: run the coalesced spawns as a loop."""
    for args in chunk:
        fn(*args)


@dataclass
class SchedulerConfig:
    num_places: int = 4
    #: "strategy" = the paper's scheduler; "deque" = Arora-style baseline.
    storage: str = "strategy"
    #: steal until half the *weight* moved (True) or half/one task (False).
    steal_half_work: bool = True
    #: baseline-only: steal half the task count instead of one task.
    steal_half_count: bool = False
    #: enable spawn-to-call conversion (strategies must also opt in).
    call_conversion: bool = True
    #: weight threshold for conversion given local queue length.
    call_threshold: Callable[[int], int] = field(default=lambda qlen: qlen)
    #: bound inline-call recursion to keep Python stacks sane.
    max_call_depth: int = 200
    #: visit steal victims nearest-first in the machine tree.
    steal_nearest_first: bool = True
    #: dynamic task-merging thresholds for ``spawn_many`` (queue-depth
    #: driven; ``MergePolicy(max_chunk=1)`` disables merging).
    merge_policy: MergePolicy = field(default_factory=MergePolicy)
    idle_sleep_s: float = 20e-6
    seed: int = 0


class _Worker:
    def __init__(self, sched: "StrategyScheduler", place_id: int):
        self.sched = sched
        self.place_id = place_id
        cfg = sched.config
        on_prune = sched._on_prune
        if cfg.storage == "deque":
            self.storage = DequeTaskStorage(
                place_id, on_prune=on_prune,
                steal_half_count=cfg.steal_half_count)
        else:
            self.storage = StrategyTaskStorage(place_id, on_prune=on_prune)
        self.rng = random.Random((cfg.seed << 16) ^ place_id)
        self.call_depth = 0
        self.thread: Optional[threading.Thread] = None
        #: private unlocked metrics shard — this worker is the only writer,
        #: so the hot path bumps plain ints instead of taking the global
        #: metrics lock on every execute/spawn/steal.
        self.m = sched.metrics.register_worker()

    # -- execution --------------------------------------------------------
    def execute(self, task: Task) -> None:
        sched = self.sched
        if task.strategy.is_dead():
            # Claimed tasks may die between claim and run; prune here too.
            task.state = TaskState.DEAD
            self.m.dead_pruned += 1
            task.region.dec()
            return
        prev_region = getattr(_tls, "region", None)
        _tls.region = task.region
        try:
            task.run()
        except BaseException as exc:  # noqa: BLE001 - propagate to run()
            sched._set_error(exc)
        finally:
            _tls.region = prev_region
            task.state = TaskState.DONE
            self.m.tasks_executed += 1
            task.region.dec()

    def try_execute_one(self) -> bool:
        task = self.storage.pop_local()
        if task is not None:
            self.execute(task)
            return True
        return self.sched._try_steal(self)

    # -- main loop ---------------------------------------------------------
    def run_loop(self) -> None:
        _tls.worker = self
        sched = self.sched
        idle = sched.config.idle_sleep_s
        try:
            while not sched._stop.is_set():
                if not self.try_execute_one():
                    if sched._root_region is not None and \
                            sched._root_region.is_complete():
                        break
                    time.sleep(idle)
        finally:
            _tls.worker = None


class StrategyScheduler:
    """The strategy-aware work-stealing scheduler."""

    def __init__(self, num_places: int = 4,
                 machine: Optional[MachineModel] = None,
                 config: Optional[SchedulerConfig] = None, **cfg_kw):
        if config is None:
            config = SchedulerConfig(num_places=num_places, **cfg_kw)
        else:
            config.num_places = num_places
        self.config = config
        self.machine = machine or flat_machine(num_places)
        self.metrics = SchedulerMetrics()
        self.workers: List[_Worker] = [
            _Worker(self, p) for p in range(num_places)]
        self._victim_order = [
            (self.machine.victims_by_distance(p)
             if config.steal_nearest_first else
             [q for q in range(num_places) if q != p])
            for p in range(num_places)]
        self._stop = threading.Event()
        self._root_region: Optional[FinishRegion] = None
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()

    # ------------------------------------------------------------------ API
    def run(self, fn: Callable, *args, **kwargs) -> Any:
        """Execute ``fn`` as the root task and return its result once the
        root finish region (all transitively spawned tasks) completes."""
        self._stop.clear()
        self._error = None
        self._root_region = root = FinishRegion()
        box: dict = {}

        def root_task():
            box["result"] = fn(*args, **kwargs)

        root.inc()
        task = Task(root_task, (), {}, BaseStrategy(place=0), root)
        self.workers[0].storage.push(task)
        self.metrics.add(spawns=1)

        threads = []
        for w in self.workers:
            t = threading.Thread(target=w.run_loop, daemon=True,
                                 name=f"place-{w.place_id}")
            w.thread = t
            threads.append(t)
            t.start()
        root.wait_blocking()
        self._stop.set()
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        return box.get("result")

    # Spawning (called from inside tasks; module-level helpers re-export).
    def spawn(self, fn: Callable, *args, **kwargs) -> None:
        self.spawn_s(BaseStrategy(), fn, *args, **kwargs)

    def spawn_s(self, strategy: BaseStrategy, fn: Callable, *args, **kwargs) -> None:
        worker = _current_worker()
        if worker is None or worker.sched is not self:
            raise RuntimeError("spawn_s must be called from inside a task")
        if strategy.place is None:
            strategy.place = worker.place_id
        region: FinishRegion = getattr(_tls, "region")
        cfg = self.config
        if (cfg.call_conversion
                and cfg.storage == "strategy"
                and strategy.allow_call_conversion()
                and worker.call_depth < cfg.max_call_depth
                and strategy.transitive_weight
                <= cfg.call_threshold(worker.storage.ready_count)):
            # Spawn-to-call: execute inline, no queue traffic.
            worker.m.calls_converted += 1
            worker.call_depth += 1
            try:
                fn(*args, **kwargs)
            finally:
                worker.call_depth -= 1
            return
        region.inc()
        task = Task(fn, args, kwargs, strategy, region)
        worker.storage.push(task)
        m = worker.m
        m.spawns += 1
        qlen = worker.storage.ready_count
        if qlen > m.max_queue_len:
            m.max_queue_len = qlen

    def spawn_many(self, fn: Callable, args_list: Sequence[tuple], *,
                   strategy_fn: Optional[Callable[..., BaseStrategy]] = None,
                   policy: Optional[MergePolicy] = None) -> None:
        """Batch-spawn ``fn(*args)`` for every ``args`` in ``args_list``,
        dynamically merging runs of consecutive spawns into single chunk
        tasks executed as a loop (the paper's task-merging optimization).

        ``strategy_fn(*args)`` builds the strategy for one item (defaults
        to :class:`BaseStrategy`).  A merged chunk adopts its *first* item's
        strategy as representative — ordering, locality and deadness follow
        it — with transitive weight estimated as ``rep.weight * len(chunk)``.
        Chunk sizes follow ``policy`` (default: the scheduler config's):
        nothing is merged while the local queue is shallow (parallelism is
        still needed); deep queues coalesce up to ``max_chunk`` spawns into
        one push+pop.  Spawn-to-call composes at chunk granularity: a chunk
        whose representative opts in and whose estimated weight is at or
        below the call threshold runs inline as a loop — merging never
        forfeits the conversion optimization.  On the deque baseline this
        degrades to per-item spawns, keeping the comparison bar honest."""
        n = len(args_list)
        if n == 0:
            return
        worker = _current_worker()
        if worker is None or worker.sched is not self:
            raise RuntimeError("spawn_many must be called from inside a task")
        cfg = self.config
        if policy is None:
            policy = cfg.merge_policy
        if cfg.storage != "strategy" or policy.max_chunk <= 1 or n == 1:
            for args in args_list:
                self.spawn_s(
                    strategy_fn(*args) if strategy_fn else BaseStrategy(),
                    fn, *args)
            return
        storage = worker.storage
        region: FinishRegion = getattr(_tls, "region")
        m = worker.m
        convert = cfg.call_conversion
        threshold = cfg.call_threshold
        i = 0
        while i < n:
            qdepth = storage.ready_count
            c = policy.chunk_size(qdepth, n - i)
            if c <= 1:
                self.spawn_s(
                    strategy_fn(*args_list[i]) if strategy_fn
                    else BaseStrategy(),
                    fn, *args_list[i])
                i += 1
                continue
            chunk = args_list[i:i + c]
            i += c
            rep = (strategy_fn(*chunk[0]) if strategy_fn
                   else BaseStrategy())
            if rep.place is None:
                rep.place = worker.place_id
            strat = MergingStrategy(rep, merged_count=c)
            if (convert
                    and rep.allow_call_conversion()
                    and worker.call_depth < cfg.max_call_depth
                    and strat.transitive_weight <= threshold(qdepth)):
                # Chunk-granular spawn-to-call: run the whole run inline.
                m.calls_converted += c
                worker.call_depth += 1
                try:
                    _run_chunk(fn, chunk)
                finally:
                    worker.call_depth -= 1
                continue
            region.inc()
            storage.push(Task(_run_chunk, (fn, chunk), {}, strat, region))
            m.spawns += 1
            m.merge_chunks += 1
            m.tasks_merged += c
        qlen = storage.ready_count
        if qlen > m.max_queue_len:
            m.max_queue_len = qlen

    def finish(self) -> "_FinishCtx":
        """``with sched.finish(): spawn(...)`` — returns once every task
        spawned inside (transitively) completed.  The waiter helps."""
        return _FinishCtx(self)

    # -------------------------------------------------------------- internals
    def _try_steal(self, thief: _Worker) -> bool:
        cfg = self.config
        order = list(self._victim_order[thief.place_id])
        if not cfg.steal_nearest_first:
            thief.rng.shuffle(order)
        for victim_id in order:
            victim = self.workers[victim_id]
            if victim.storage.ready_count == 0:
                continue
            thief.m.steal_attempts += 1
            stolen, weight = victim.storage.steal_batch(
                thief.place_id, half_work=cfg.steal_half_work)
            if not stolen:
                continue
            m = thief.m
            m.steals += 1
            m.tasks_stolen += len(stolen)
            m.weight_stolen += weight
            # Execute the highest-steal-priority task now; re-home the rest.
            # Note: strategy.place stays the original spawn place (the
            # paper's default), so locality-aware strategies still see where
            # the task's data lives.
            first, rest = stolen[0], stolen[1:]
            for t in rest:
                thief.storage.push(t)
            thief.execute(first)
            return True
        return False

    def _on_prune(self, task: Task) -> None:
        w = _current_worker()
        if w is not None and w.sched is self:
            w.m.dead_pruned += 1
        else:
            self.metrics.add(dead_pruned=1)
        task.region.dec()

    def _set_error(self, exc: BaseException) -> None:
        with self._error_lock:
            if self._error is None:
                self._error = exc
        self._stop.set()
        if self._root_region is not None:
            self._root_region._done.set()


class _FinishCtx:
    def __init__(self, sched: StrategyScheduler):
        self.sched = sched
        self.region: Optional[FinishRegion] = None
        self._outer: Optional[FinishRegion] = None

    def __enter__(self) -> FinishRegion:
        self._outer = getattr(_tls, "region", None)
        self.region = FinishRegion(parent=self._outer)
        _tls.region = self.region
        return self.region

    def __exit__(self, exc_type, exc, tb) -> bool:
        worker = _current_worker()
        region = self.region
        assert region is not None
        if exc is None:
            idle = self.sched.config.idle_sleep_s
            while not region.is_complete() and not self.sched._stop.is_set():
                if worker is None or not worker.try_execute_one():
                    time.sleep(idle)
        _tls.region = self._outer
        return False


class WorkStealingScheduler(StrategyScheduler):
    """Baseline: standard work-stealing with Arora-style deques (LIFO local,
    FIFO steal, steal one task), no strategy support — the paper's comparison
    scheduler."""

    def __init__(self, num_places: int = 4,
                 machine: Optional[MachineModel] = None,
                 steal_half_count: bool = False, seed: int = 0):
        cfg = SchedulerConfig(
            num_places=num_places, storage="deque", steal_half_work=False,
            steal_half_count=steal_half_count, call_conversion=False,
            steal_nearest_first=False, seed=seed)
        super().__init__(num_places=num_places, machine=machine, config=cfg)


# ----------------------------------------------------------------- free API

def spawn(fn: Callable, *args, **kwargs) -> None:
    w = _current_worker()
    if w is None:
        raise RuntimeError("spawn outside scheduler")
    w.sched.spawn(fn, *args, **kwargs)


def spawn_s(strategy: BaseStrategy, fn: Callable, *args, **kwargs) -> None:
    w = _current_worker()
    if w is None:
        raise RuntimeError("spawn_s outside scheduler")
    w.sched.spawn_s(strategy, fn, *args, **kwargs)


def spawn_many(fn: Callable, args_list: Sequence[tuple], *,
               strategy_fn: Optional[Callable[..., BaseStrategy]] = None,
               policy: Optional[MergePolicy] = None) -> None:
    w = _current_worker()
    if w is None:
        raise RuntimeError("spawn_many outside scheduler")
    w.sched.spawn_many(fn, args_list, strategy_fn=strategy_fn, policy=policy)


def finish() -> _FinishCtx:
    w = _current_worker()
    if w is None:
        raise RuntimeError("finish outside scheduler")
    return w.sched.finish()
