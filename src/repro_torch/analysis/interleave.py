# Copied from src/repro/analysis/interleave.py; only the imports may differ.
"""Bounded systematic exploration of owner/stealer interleavings.

The task storages are fine-grained-locked: any sequential interleaving of
whole operations is a legal concurrent history (each op runs under the
storage lock), so model checking the *protocol* reduces to exploring op
interleavings — the classic stateless-model-checking reduction.  This
module drives N virtual workers, each with a scripted program of
push/pop/steal/cancel/compact ops, through **every** distinct interleaving
of a schedule against a real storage instance, asserting after each step:

* the storage's own :meth:`check` — conservation
  (``pushed == executed + dead_pruned + in_storage``), counter and
  push-log/freelist consistency;
* **no double delivery** — a task returned by any pop/steal is never
  returned again by anyone (owner and stealer views of one task must
  resolve to a single claimant);
* every delivered task is in the CLAIMED state and was actually scripted.

State-space handling (DPOR-flavoured, without the vector clocks):
exploration is a depth-first walk over *storage states*, not over raw
schedules.  Because the storages cannot be snapshotted (they hold a
``threading.Lock``), each DFS node **replays** its op prefix against a
fresh storage; a structural hash of (per-worker pcs, per-task states,
storage internals) memoises states already proven safe, so the walk visits
each distinct state once.  Two prefixes reaching the same hash have
observably identical futures: with distinct per-task priorities the heap
order is a strict total order, so pop/steal results depend only on the
resident set, watermarks and (for the deque) queue order — exactly what
the hash captures.  The number of **interleavings covered** is then exact,
counted by dynamic programming over the explored DAG (paths from the root
to terminal states); every interleaving is a root-to-terminal path whose
every edge has been executed and checked.

``python -m repro.analysis.interleave`` runs the default 3-worker schedule
(450 450 interleavings, a few thousand distinct states) against both
storages and exits non-zero on any violation or if coverage falls short of
``--min-interleavings``.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.strategy import PriorityStrategy
from ..core.task import FinishRegion, Task, TaskState
from ..core.task_storage import DequeTaskStorage, StrategyTaskStorage
from .invariants import soft_check

__all__ = ["Op", "ExploreResult", "Violation", "ScriptStrategy",
           "default_schedule", "explore", "main"]

#: an op is a tuple: ("push", uid, priority, weight) | ("pop",)
#: | ("steal", max_tasks) | ("cancel", uid) | ("compact",)
Op = Tuple


class ScriptStrategy(PriorityStrategy):
    """Scripted task strategy: a stable ``uid`` (replay-independent
    identity — ``spawn_seq`` differs between replays), a distinct priority
    per uid (so heap order is a strict total order and the state hash is
    sound) and an external kill switch for the cancel op."""

    __slots__ = ("uid", "dead")

    def __init__(self, uid: int, priority: float, weight: int = 1):
        super().__init__(priority=priority, transitive_weight=weight)
        self.uid = uid
        self.dead = False

    def is_dead(self) -> bool:
        return self.dead


@dataclass
class Violation:
    storage: str
    trace: Tuple[Tuple[int, Op], ...]   # (worker, op) steps up to the fault
    message: str

    def render(self) -> str:
        steps = " ; ".join(f"w{w}:{op[0]}{op[1:]}" for w, op in self.trace)
        return f"[{self.storage}] after <{steps}>: {self.message}"


@dataclass
class ExploreResult:
    states: int = 0
    edges: int = 0
    replays: int = 0
    ops_executed: int = 0
    interleavings: int = 0
    truncated: bool = False
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def default_schedule(extra_pushes: int = 0) -> List[List[Op]]:
    """The CI schedule: 3 workers, 15 ops, 15!/(7!·4!·4!) = 450 450
    interleavings.  Worker 0 owns the storage (push/pop/cancel), workers 1
    and 2 steal (and force a compaction mid-flight).  ``extra_pushes``
    appends push/pop pairs to the owner for deeper (slower) runs."""
    owner: List[Op] = [
        ("push", 0, 5.0, 2),
        ("push", 1, 3.0, 1),
        ("pop",),
        ("push", 2, 8.0, 3),
        ("cancel", 1),
        ("pop",),
        ("pop",),
    ]
    uid = 3
    for _ in range(extra_pushes):
        owner.insert(2, ("push", uid, 10.0 + uid, 1))
        owner.append(("pop",))
        uid += 1
    thief1: List[Op] = [("steal", 1), ("steal", 2), ("compact",),
                        ("steal", 1)]
    thief2: List[Op] = [("steal", 2), ("compact",), ("steal", 1),
                        ("steal", 1)]
    return [owner, thief1, thief2]


def _noop() -> None:
    pass


class _Replay:
    """One execution of an op prefix against a fresh storage."""

    def __init__(self, schedule: Sequence[Sequence[Op]],
                 storage_factory: Callable[[], object]):
        self.storage = storage_factory()
        self.region = FinishRegion()
        self.tasks: Dict[int, Task] = {}
        for prog in schedule:
            for op in prog:
                if op[0] == "push":
                    _, uid, prio, weight = op
                    self.tasks[uid] = Task(
                        _noop, (), {}, ScriptStrategy(uid, prio, weight),
                        self.region)
        self.claimed: List[int] = []    # delivery order, for double-pop
        self.fault: Optional[str] = None

    def _deliver(self, task: Optional[Task]) -> None:
        if task is None:
            return
        uid = getattr(task.strategy, "uid", None)
        if uid is None or uid not in self.tasks:
            self.fault = f"delivered an unscripted task {task!r}"
        elif uid in self.claimed:
            self.fault = (f"double delivery: task {uid} returned twice — "
                          f"owner and stealer views both claimed it")
        elif task.state != TaskState.CLAIMED:
            self.fault = (f"delivered task {uid} in state "
                          f"{task.state.name}, not CLAIMED")
        else:
            self.claimed.append(uid)

    def step(self, worker: int, op: Op, check: bool) -> bool:
        """Execute one op; False when a violation was recorded."""
        s = self.storage
        kind = op[0]
        try:
            if kind == "push":
                s.push(self.tasks[op[1]])
            elif kind == "pop":
                self._deliver(s.pop_local())
            elif kind == "steal":
                stolen, _ = s.steal_batch(worker, max_tasks=op[1])
                for t in stolen:
                    self._deliver(t)
            elif kind == "cancel":
                self.tasks[op[1]].strategy.dead = True
            elif kind == "compact":
                if isinstance(s, StrategyTaskStorage):
                    with s._lock:
                        s._compact()
            else:
                self.fault = f"unknown op {op!r}"
        except AssertionError as e:     # a mutated storage may assert inline
            self.fault = f"storage op raised: {e}"
        if self.fault is None and check:
            msg = soft_check(s)
            if msg is not None:
                self.fault = msg
        return self.fault is None

    def state_key(self) -> Tuple:
        """Structural hash of everything that can influence future
        behaviour (see module docstring for the soundness argument)."""
        s = self.storage
        task_states = tuple(
            (uid, t.state.value, t.strategy.dead)
            for uid, t in sorted(self.tasks.items()))
        if isinstance(s, StrategyTaskStorage):
            views = tuple(sorted(
                (sid, v.watermark) for sid, v in s._views.items()))
            extra = (s._push_seq, len(s._log), views,
                     s.pushed_total, s.executed_total, s.pruned_total)
        elif isinstance(s, DequeTaskStorage):
            extra = (tuple(getattr(t.strategy, "uid", -1) for t in s._dq),
                     s.pushed_total, s.executed_total,
                     s.stale_discarded_total)
        else:                            # mutated subclass: fall back to
            extra = ()                   # pc-only hashing (still sound DFS)
        return task_states, extra, tuple(sorted(self.claimed))


def explore(schedule: Sequence[Sequence[Op]],
            storage_factory: Callable[[], object],
            *,
            check_every_step: bool = True,
            max_states: int = 500_000,
            max_ops: int = 20_000_000,
            stop_on_violation: bool = True) -> ExploreResult:
    """Explore every distinct interleaving of ``schedule`` (subject to the
    state budget) against storages built by ``storage_factory``."""
    res = ExploreResult()
    name = storage_factory().__class__.__name__
    lengths = [len(p) for p in schedule]
    memo: Dict[Tuple, int] = {}          # state key -> interleavings below

    def replay(prefix: Tuple[Tuple[int, Op], ...]) -> _Replay:
        r = _Replay(schedule, storage_factory)
        res.replays += 1
        for w, op in prefix:
            res.ops_executed += 1
            if not r.step(w, op, check_every_step):
                break
        return r

    def dfs(prefix: Tuple[Tuple[int, Op], ...],
            pcs: Tuple[int, ...]) -> int:
        if res.truncated or (stop_on_violation and res.violations):
            return 0
        r = replay(prefix)
        if r.fault is not None:
            res.violations.append(Violation(name, prefix, r.fault))
            return 0
        key = (pcs, r.state_key())
        hit = memo.get(key)
        if hit is not None:
            return hit
        if len(memo) >= max_states or res.ops_executed >= max_ops:
            res.truncated = True
            return 0
        memo[key] = 0                   # cycle guard; real value below
        res.states += 1
        enabled = [w for w in range(len(schedule)) if pcs[w] < lengths[w]]
        if not enabled:
            memo[key] = 1
            return 1
        total = 0
        for w in enabled:
            res.edges += 1
            op = schedule[w][pcs[w]]
            nxt = tuple(pc + 1 if i == w else pc
                        for i, pc in enumerate(pcs))
            total += dfs(prefix + ((w, op),), nxt)
        memo[key] = total
        return total

    sys.setrecursionlimit(max(sys.getrecursionlimit(),
                              sum(lengths) * 4 + 100))
    res.interleavings = dfs((), tuple(0 for _ in schedule))
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro.analysis.interleave",
        description="systematic interleaving exploration of the task "
                    "storages")
    ap.add_argument("--storage", choices=("strategy", "deque", "both"),
                    default="both")
    ap.add_argument("--extra-pushes", type=int, default=0,
                    help="extend the owner's program (deeper state space)")
    ap.add_argument("--max-states", type=int, default=500_000)
    ap.add_argument("--max-ops", type=int, default=20_000_000,
                    help="step budget across all replays")
    ap.add_argument("--min-interleavings", type=int, default=0,
                    help="fail unless at least this many interleavings "
                         "were covered per storage")
    args = ap.parse_args(argv)

    factories = {"strategy": lambda: StrategyTaskStorage(0),
                 "deque": lambda: DequeTaskStorage(0)}
    picked = list(factories) if args.storage == "both" else [args.storage]
    schedule = default_schedule(args.extra_pushes)
    fails = 0
    for which in picked:
        res = explore(schedule, factories[which],
                      max_states=args.max_states, max_ops=args.max_ops)
        status = "OK" if res.ok else "VIOLATION"
        print(f"{which}: {status} — {res.interleavings} interleavings, "
              f"{res.states} states, {res.edges} edges, "
              f"{res.replays} replays, {res.ops_executed} ops"
              + (" [truncated]" if res.truncated else ""))
        for v in res.violations:
            print("  " + v.render())
            fails += 1
        if res.ok and res.interleavings < args.min_interleavings:
            print(f"  coverage shortfall: {res.interleavings} < "
                  f"{args.min_interleavings}")
            fails += 1
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
