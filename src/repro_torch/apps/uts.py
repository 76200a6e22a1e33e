# Copied from src/repro/apps/uts.py; only the imports may differ.
"""Unbalanced Tree Search (paper Section 4, Figure 5).

Deterministic unbalanced tree: each node's child count is geometric with a
mean that decreases linearly with depth (the UTS "geometric" shape), fully
determined by a splitmix64 hash of the path — the same tree for every run.
Millions of tiny tasks in a short time-frame make queue churn the bottleneck;
the strategy assigns transitive weight 2^min(height_left, cap) and enables
spawn-to-call, so near-leaf tasks are executed inline whenever the local
queue already holds enough parallelism.
"""
from __future__ import annotations

import math
import time

import numpy as np

from ..core import (BaseStrategy, SchedulerConfig, StrategyScheduler,
                    WorkStealingScheduler, get_place, spawn_many, spawn_s)

__all__ = ["UTSStrategy", "run_uts", "uts_tree_size"]

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _num_children(h: int, depth: int, b0: float, max_depth: int) -> int:
    if depth == 0:
        return int(math.ceil(b0))             # UTS: root always has b0 kids
    if depth >= max_depth:
        return 0
    mean = b0 * (1.0 - depth / max_depth)
    if mean <= 0:
        return 0
    p = 1.0 / (1.0 + mean)
    u = ((h >> 11) + 1) / float(1 << 53)      # uniform in (0, 1]
    return int(math.log(u) / math.log(1.0 - p))


class UTSStrategy(BaseStrategy):
    """LIFO/FIFO order (inherited) + exponential transitive weight, capped,
    with call conversion enabled — the paper's UTS strategy."""

    __slots__ = ()

    def __init__(self, depth: int, max_depth: int, cap: int = 16):
        super().__init__()
        self.set_transitive_weight(1 << min(max(max_depth - depth, 0), cap))

    def allow_call_conversion(self) -> bool:
        return True


def _uts_task(counts: np.ndarray, h: int, depth: int, b0: float,
              max_depth: int, use_strategy: bool, merge: bool = True):
    place = get_place() or 0
    counts[place] += 1
    k = _num_children(h, depth, b0, max_depth)
    if k == 0:
        return
    if use_strategy and merge:
        # All children share one strategy shape; runs of siblings coalesce
        # into chunk tasks when the local queue is already deep.
        spawn_many(
            _uts_task,
            [(counts, _splitmix64(h ^ (c + 1)), depth + 1, b0, max_depth,
              use_strategy, merge) for c in range(k)],
            strategy_fn=lambda *_a: UTSStrategy(depth + 1, max_depth))
        return
    for c in range(k):
        ch = _splitmix64(h ^ (c + 1))
        strat = (UTSStrategy(depth + 1, max_depth) if use_strategy
                 else BaseStrategy())
        spawn_s(strat, _uts_task, counts, ch, depth + 1, b0, max_depth,
                use_strategy)


def run_uts(b0: float = 4.0, max_depth: int = 13, seed: int = 42,
            num_places: int = 4, scheduler: str = "strategy",
            use_strategy: bool = True, merge: bool = True) -> dict:
    if scheduler == "deque":
        sched = WorkStealingScheduler(num_places=num_places, seed=seed)
        use_strategy = False
    else:
        sched = StrategyScheduler(num_places=num_places,
                                  config=SchedulerConfig(seed=seed))
    counts = np.zeros(num_places, np.int64)
    root_h = _splitmix64(seed)
    t0 = time.perf_counter()
    sched.run(_uts_task, counts, root_h, 0, b0, max_depth, use_strategy,
              merge)
    dt = time.perf_counter() - t0
    m = sched.metrics.snapshot()
    nodes = int(counts.sum())
    return {"nodes": nodes, "time_s": dt, "spawns": m["spawns"],
            "calls_converted": m["calls_converted"],
            "queue_churn": 2 * m["spawns"], "steals": m["steals"],
            "merge_chunks": m["merge_chunks"],
            "tasks_merged": m["tasks_merged"],
            "nodes_per_s": nodes / max(dt, 1e-9)}


def uts_tree_size(b0: float, max_depth: int, seed: int = 42) -> int:
    """Sequential tree size (oracle for tests — same hash stream)."""
    stack = [(_splitmix64(seed), 0)]
    n = 0
    while stack:
        h, d = stack.pop()
        n += 1
        for c in range(_num_children(h, d, b0, max_depth)):
            stack.append((_splitmix64(h ^ (c + 1)), d + 1))
    return n
