# Copied from src/repro/apps/prefix_sum.py; only the imports may differ.
"""Adaptive blocked prefix sums (paper Section 4, Figure 4).

Classic 3-pass parallel prefix sums: (1) per-block local sums, (2) scan of
block totals, (3) per-block offset fix-up.  The strategy observation: if a
block's predecessor is already fully resolved when the block task runs, the
carry can be added *during* pass 1 and passes 2-3 vanish for that block.  The
strategy makes one place sweep blocks in ascending order (the sequential
front), while all other places and all steals take blocks in descending
order, staying out of the front's way.  With one thread the algorithm
degrades gracefully to the sequential single-pass prefix sum — the paper's
adaptivity claim; the ``one_pass_fraction`` metric quantifies it.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..core import (BaseStrategy, SchedulerConfig, StrategyScheduler,
                    WorkStealingScheduler, spawn_many, spawn_s)

__all__ = ["PrefixStrategy", "run_prefix_sum", "run_concurrent_prefix_sums"]


class PrefixStrategy(BaseStrategy):
    """Ascending block order at the owning place, descending elsewhere and
    for steals."""

    __slots__ = ("block", "owner_place")

    def __init__(self, block: int, owner_place: int):
        super().__init__()
        self.block = block
        self.owner_place = owner_place

    def prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, PrefixStrategy):
            from ..core.strategy import _current_place_id
            if _current_place_id() == self.owner_place:
                return self.block < other.block
            return self.block > other.block
        return super().prioritize(other)

    def steal_prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, PrefixStrategy):
            return self.block > other.block
        return super().steal_prioritize(other)


class _State:
    def __init__(self, x: np.ndarray, block: int):
        self.x = x
        self.out = np.empty_like(x)
        self.block = block
        self.nblocks = (len(x) + block - 1) // block
        self.front = 0                 # blocks fully resolved, in order
        self.total = x.dtype.type(0)   # prefix total over resolved front
        self.block_sums = np.zeros(self.nblocks, x.dtype)
        self.processed = np.zeros(self.nblocks, bool)   # pass 1 done
        self.resolved = np.zeros(self.nblocks, bool)    # final values in out
        self.one_pass = 0
        self.lock = threading.Lock()


def _block_task(s: _State, i: int):
    lo, hi = i * s.block, min((i + 1) * s.block, len(s.x))
    seg = np.cumsum(s.x[lo:hi])
    with s.lock:
        if s.front == i:
            # Predecessor resolved → single pass: add the carry now.
            s.out[lo:hi] = seg + s.total
            s.total = s.total + seg[-1]
            s.front += 1
            s.resolved[i] = True
            s.one_pass += 1
            # Drag the front over blocks already processed out-of-order
            # (their fix-up happens here, no extra task needed).
            j = s.front
            while j < s.nblocks and s.processed[j]:
                l2, h2 = j * s.block, min((j + 1) * s.block, len(s.x))
                s.out[l2:h2] += s.total
                s.total = s.total + s.block_sums[j]
                s.resolved[j] = True
                s.front += 1
                j += 1
        else:
            s.out[lo:hi] = seg
            s.block_sums[i] = seg[-1]
            s.processed[i] = True


def _root(s: _State, use_strategy: bool, owner_place: int,
          merge: bool = True):
    if use_strategy and merge:
        # Batch-spawn with dynamic merging: consecutive blocks coalesce into
        # chunk tasks (ascending runs keep the sequential front moving), the
        # chunk ordered where its first block would be.
        spawn_many(_block_task, [(s, i) for i in range(s.nblocks)],
                   strategy_fn=lambda _s, i: PrefixStrategy(i, owner_place))
        return
    for i in range(s.nblocks):
        strat = (PrefixStrategy(i, owner_place) if use_strategy
                 else BaseStrategy())
        spawn_s(strat, _block_task, s, i)


def _finalize(s: _State):
    """Resolve any blocks the in-order front never reached (pass 2 + 3)."""
    if s.front >= s.nblocks:
        return
    pending = np.flatnonzero(~s.resolved)
    offsets = s.total + np.cumsum(
        np.concatenate([[0], s.block_sums[pending[:-1]]]))
    for k, i in enumerate(pending):
        lo, hi = i * s.block, min((i + 1) * s.block, len(s.x))
        s.out[lo:hi] += offsets[k]
        s.resolved[i] = True


def run_prefix_sum(n: int = 1_000_000, block: int = 4096, seed: int = 0,
                   num_places: int = 4, scheduler: str = "strategy",
                   use_strategy: bool = True, merge: bool = True,
                   x: Optional[np.ndarray] = None) -> dict:
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.integers(-1000, 1000, n).astype(np.int64)
    s = _State(x, block)
    if scheduler == "deque":
        sched = WorkStealingScheduler(num_places=num_places, seed=seed)
        use_strategy = False
    else:
        sched = StrategyScheduler(num_places=num_places,
                                  config=SchedulerConfig(seed=seed))
    t0 = time.perf_counter()
    sched.run(_root, s, use_strategy, 0, merge)
    _finalize(s)
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    ref = np.cumsum(x)
    seq_dt = time.perf_counter() - t1
    assert np.array_equal(s.out, ref), "prefix sum mismatch"
    m = sched.metrics.snapshot()
    return {"time_s": dt, "seq_time_s": seq_dt,
            "one_pass_fraction": s.one_pass / s.nblocks,
            "nblocks": s.nblocks, "steals": m["steals"],
            "spawns": m["spawns"], "merge_chunks": m["merge_chunks"],
            "tasks_merged": m["tasks_merged"]}


def run_concurrent_prefix_sums(k: int = 12, n: int = 200_000,
                               block: int = 4096, seed: int = 0,
                               num_places: int = 4,
                               scheduler: str = "strategy",
                               use_strategy: bool = True) -> dict:
    """k independent prefix-sums sharing one scheduler (paper Fig. 4b) —
    each instance brings its own strategy state; strategies compose."""
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-1000, 1000, n).astype(np.int64) for _ in range(k)]
    states = [_State(x, block) for x in xs]
    if scheduler == "deque":
        sched = WorkStealingScheduler(num_places=num_places, seed=seed)
        use_strategy = False
    else:
        sched = StrategyScheduler(num_places=num_places,
                                  config=SchedulerConfig(seed=seed))

    def root():
        for j, s in enumerate(states):
            _root(s, use_strategy, owner_place=j % num_places)

    t0 = time.perf_counter()
    sched.run(root)
    for s in states:
        _finalize(s)
    dt = time.perf_counter() - t0
    for s, x in zip(states, xs):
        assert np.array_equal(s.out, np.cumsum(x))
    return {"time_s": dt,
            "one_pass_fraction": float(np.mean(
                [s.one_pass / s.nblocks for s in states])),
            "steals": sched.metrics.steals}
