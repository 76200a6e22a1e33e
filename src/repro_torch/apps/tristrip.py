# Copied from src/repro/apps/tristrip.py; only the imports may differ.
"""Triangle strip generation (paper Section 4, Figure 7).

SGI-style heuristic on the triangle-adjacency graph: start a strip at a
triangle with the lowest number of unstripped neighbours, grow it greedily at
both ends, repeat.  Fewer/longer strips = better quality.

Two task types demonstrate *composability*:

* ``StartTask`` — tries to start a strip at one triangle.  Strategy: local
  priority = lowest spawn-time degree (mimics the sequential heuristic),
  low transitive weight + call conversion (strips are quick to build), and
  the task is **dead** once its triangle got swallowed by another strip.
* ``SpawnTask`` — generates StartTasks for a range of triangles, splitting
  itself; transitive weight = range length, no call conversion.

Their common parent strategy prefers StartTasks when working locally but
SpawnTasks when stealing (a thief wants work *generators*, not leaves).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..core import (BaseStrategy, SchedulerConfig, StrategyScheduler,
                    WorkStealingScheduler, spawn_s)

__all__ = ["run_tristrip", "grid_mesh", "TriStripStrategy", "StartStrategy",
           "SpawnStrategy"]

_NLOCKS = 256


def grid_mesh(rows: int, cols: int, hole_frac: float = 0.0, seed: int = 0):
    """Triangulated rows×cols quad grid → adjacency (T, 3) with -1 padding.
    ``hole_frac`` removes random triangles (scan-mesh irregularity — makes
    the low-degree-first heuristic matter) and triangle ids are randomly
    permuted so task order ≠ spatial order."""
    T = 2 * rows * cols
    adj = np.full((T, 3), -1, np.int64)

    def tid(r, c, half):
        return 2 * (r * cols + c) + half

    for r in range(rows):
        for c in range(cols):
            lo, hi = tid(r, c, 0), tid(r, c, 1)
            adj[lo, 0] = hi
            adj[hi, 0] = lo
            if c > 0:
                adj[lo, 1] = tid(r, c - 1, 1)
            if r > 0:
                adj[lo, 2] = tid(r - 1, c, 1)
            if c + 1 < cols:
                adj[hi, 1] = tid(r, c + 1, 0)
            if r + 1 < rows:
                adj[hi, 2] = tid(r + 1, c, 0)
    rng = np.random.default_rng(seed)
    if hole_frac > 0.0:
        keep = rng.random(T) >= hole_frac
        remap = np.full(T, -1, np.int64)
        remap[keep] = np.arange(int(keep.sum()))
        adj2 = adj[keep]
        adj2 = np.where(adj2 >= 0, remap[np.clip(adj2, 0, None)], -1)
        adj = adj2
        T = len(adj)
    perm = rng.permutation(T)
    inv = np.argsort(perm)
    out = np.full((T, 3), -1, np.int64)
    out[inv] = np.where(adj >= 0, inv[np.clip(adj, 0, None)], -1)
    return out


class TriStripStrategy(BaseStrategy):
    """Common parent: locally prefer StartTasks (finish strips), steal
    SpawnTasks first (work generators)."""

    __slots__ = ()

    def prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, TriStripStrategy):
            a, b = isinstance(self, StartStrategy), isinstance(other, StartStrategy)
            if a != b:
                return a            # StartTask first locally
        return super().prioritize(other)

    def steal_prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, TriStripStrategy):
            a, b = isinstance(self, SpawnStrategy), isinstance(other, SpawnStrategy)
            if a != b:
                return a            # SpawnTask first when stealing
        return super().steal_prioritize(other)


class StartStrategy(TriStripStrategy):
    __slots__ = ("degree", "node", "state")

    def __init__(self, state: "_State", node: int, degree: int):
        super().__init__()
        self.state = state
        self.node = node
        self.degree = degree

    def prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, StartStrategy):
            if self.degree != other.degree:
                return self.degree < other.degree
            return self.spawn_seq > other.spawn_seq
        return super().prioritize(other)

    def allow_call_conversion(self) -> bool:
        return True

    def is_dead(self) -> bool:
        return bool(self.state.claimed[self.node])


class SpawnStrategy(TriStripStrategy):
    __slots__ = ()

    def __init__(self, span: int):
        super().__init__()
        self.set_transitive_weight(span)


class _State:
    def __init__(self, adj: np.ndarray, num_places: int):
        self.adj = adj
        self.claimed = np.zeros(len(adj), bool)
        self.locks = [threading.Lock() for _ in range(_NLOCKS)]
        self.strips = [[] for _ in range(num_places)]  # per-place strip lens


def _try_claim(s: _State, t: int) -> bool:
    if s.claimed[t]:
        return False
    with s.locks[t % _NLOCKS]:
        if s.claimed[t]:
            return False
        s.claimed[t] = True
        return True


def _degree(s: _State, t: int) -> int:
    return sum(1 for v in s.adj[t] if v >= 0 and not s.claimed[v])


def _grow(s: _State, t: int, place: int):
    """Build one strip starting at claimed triangle t, extending both ends
    toward the lowest-degree unclaimed neighbour."""
    strip = [t]
    for end in (0, 1):
        cur = strip[-1] if end == 0 else strip[0]
        while True:
            cands = [v for v in s.adj[cur] if v >= 0 and not s.claimed[v]]
            if not cands:
                break
            cands.sort(key=lambda v: _degree(s, v))
            nxt = next((v for v in cands if _try_claim(s, v)), None)
            if nxt is None:
                break
            if end == 0:
                strip.append(nxt)
            else:
                strip.insert(0, nxt)
            cur = nxt
    s.strips[place].append(len(strip))


def _start_task(s: _State, t: int, use_strategy: bool):
    from ..core import get_place
    if not _try_claim(s, t):
        return
    _grow(s, t, get_place() or 0)


def _spawn_task(s: _State, lo: int, hi: int, use_strategy: bool,
                chunk: int = 512):
    if hi - lo > chunk:
        mid = (lo + hi) // 2
        for (a, b) in ((lo, mid), (mid, hi)):
            strat = (SpawnStrategy(b - a) if use_strategy else BaseStrategy())
            spawn_s(strat, _spawn_task, s, a, b, use_strategy, chunk)
        return
    for t in range(lo, hi):
        if s.claimed[t]:
            continue
        strat = (StartStrategy(s, t, _degree(s, t)) if use_strategy
                 else BaseStrategy())
        spawn_s(strat, _start_task, s, t, use_strategy)


def run_tristrip(rows: int = 64, cols: int = 64, seed: int = 0,
                 num_places: int = 4, scheduler: str = "strategy",
                 use_strategy: bool = True, hole_frac: float = 0.12) -> dict:
    adj = grid_mesh(rows, cols, hole_frac=hole_frac, seed=seed)
    s = _State(adj, num_places)
    if scheduler == "deque":
        sched = WorkStealingScheduler(num_places=num_places, seed=seed)
        use_strategy = False
    else:
        sched = StrategyScheduler(num_places=num_places,
                                  config=SchedulerConfig(seed=seed))
    t0 = time.perf_counter()
    sched.run(_spawn_task, s, 0, len(adj), use_strategy)
    dt = time.perf_counter() - t0
    assert s.claimed.all(), "not all triangles stripped"
    lens = [l for per in s.strips for l in per]
    assert sum(lens) == len(adj)
    m = sched.metrics.snapshot()
    return {"time_s": dt, "num_strips": len(lens),
            "avg_strip_len": float(np.mean(lens)),
            "num_triangles": len(adj),
            "calls_converted": m["calls_converted"],
            "dead_pruned": m["dead_pruned"], "steals": m["steals"]}
