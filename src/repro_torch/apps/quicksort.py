# Copied from src/repro/apps/quicksort.py; only the imports may differ.
"""Task-parallel quicksort (paper Section 4, Figure 8).

Quicksort already fits the LIFO/FIFO order well; the strategy adds (a) the
smaller subsequence first when going depth-first (cache residency), (b)
largest subsequence first when stealing (less interference), (c) transitive
weight n'·log₂ n' (n' = n/b) enabling spawn-to-call and steal-half-the-work.
The paper expects — and we measure — only modest gains: the benchmark's role
is to bound the strategy scheduler's overhead on a well-behaved kernel.
"""
from __future__ import annotations

import math
import time

import numpy as np

from ..core import (BaseStrategy, SchedulerConfig, StrategyScheduler,
                    WorkStealingScheduler, spawn_many, spawn_s)

__all__ = ["QuicksortStrategy", "run_quicksort"]

_CUTOFF = 256


class QuicksortStrategy(BaseStrategy):
    __slots__ = ("size",)

    def __init__(self, size: int, block: int = _CUTOFF):
        super().__init__()
        self.size = size
        np_ = max(size / block, 1.0)
        self.set_transitive_weight(int(np_ * max(math.log2(np_), 1.0)))

    def allow_call_conversion(self) -> bool:
        return True

    def prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, QuicksortStrategy):
            if self.size != other.size:
                return self.size < other.size     # smaller slice first
            return self.spawn_seq > other.spawn_seq
        return super().prioritize(other)

    def steal_prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, QuicksortStrategy):
            return self.size > other.size          # steal the big ones
        return super().steal_prioritize(other)


def _qsort_task(a: np.ndarray, lo: int, hi: int, use_strategy: bool,
                cutoff: int = _CUTOFF, merge: bool = True):
    n = hi - lo
    if n <= cutoff:
        a[lo:hi].sort()
        return
    seg = a[lo:hi]
    p = np.median(seg[[0, n // 2, n - 1]])
    left = seg[seg < p]
    mid = seg[seg == p]
    right = seg[seg > p]
    seg[:len(left)] = left
    seg[len(left):len(left) + len(mid)] = mid
    seg[len(left) + len(mid):] = right
    l_lo, l_hi = lo, lo + len(left)
    r_lo, r_hi = lo + len(left) + len(mid), hi
    subs = [(a, s_lo, s_hi, use_strategy, cutoff, merge)
            for (s_lo, s_hi) in ((l_lo, l_hi), (r_lo, r_hi))
            if s_hi - s_lo > 0]
    if use_strategy and merge:
        # Both children merge into one chunk task once the local queue
        # already holds enough parallelism — half the queue churn per node.
        spawn_many(_qsort_task, subs,
                   strategy_fn=lambda _a, s_lo, s_hi, *_rest:
                       QuicksortStrategy(s_hi - s_lo, block=cutoff))
        return
    for args in subs:
        strat = (QuicksortStrategy(args[2] - args[1], block=cutoff)
                 if use_strategy else BaseStrategy())
        spawn_s(strat, _qsort_task, *args)


def run_quicksort(n: int = 2_000_000, seed: int = 0, num_places: int = 4,
                  scheduler: str = "strategy",
                  use_strategy: bool = True, merge: bool = True,
                  cutoff: int = _CUTOFF) -> dict:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 40, n).astype(np.int64)
    ref = np.sort(a)
    if scheduler == "deque":
        sched = WorkStealingScheduler(num_places=num_places, seed=seed)
        use_strategy = False
    else:
        sched = StrategyScheduler(num_places=num_places,
                                  config=SchedulerConfig(seed=seed))
    t0 = time.perf_counter()
    sched.run(_qsort_task, a, 0, n, use_strategy, cutoff, merge)
    dt = time.perf_counter() - t0
    assert np.array_equal(a, ref), "quicksort output not sorted"
    m = sched.metrics.snapshot()
    return {"time_s": dt, "spawns": m["spawns"],
            "calls_converted": m["calls_converted"], "steals": m["steals"],
            "tasks_stolen": m["tasks_stolen"],
            "weight_stolen": m["weight_stolen"],
            "merge_chunks": m["merge_chunks"],
            "tasks_merged": m["tasks_merged"]}
