# Copied from src/repro/apps/sssp.py; only the imports may differ.
"""Single-source shortest path (paper Section 4, Figure 6).

Parallel Dijkstra where the scheduler's priority mechanism *is* the priority
queue: relax tasks are ordered locally by tentative distance (most promising
first) but stolen in **random** order — stealing the most promising tasks
would leave the victim nothing useful (the paper's RandomSteal strategy).
Settled-late tasks become **dead** (their spawn-time distance is stale) and
are pruned from the queues without executing.

Running this under plain LIFO order can do asymptotically more relaxations;
the baseline for comparison is sequential Dijkstra with a binary heap.
"""
from __future__ import annotations

import heapq
import random
import threading
import time

import numpy as np

from ..core import (RandomStealStrategy, SchedulerConfig, StrategyScheduler,
                    get_place, spawn_s)

__all__ = ["run_sssp", "dijkstra", "random_csr_graph"]

_NLOCKS = 256


def random_csr_graph(n: int, density: float, max_weight: int = 1000,
                     seed: int = 0):
    """Random G(n, p) digraph (symmetrized) in CSR form."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < density
    np.fill_diagonal(a, False)
    a |= a.T
    w = rng.integers(1, max_weight + 1, (n, n))
    indptr = np.zeros(n + 1, np.int64)
    indices = []
    weights = []
    for u in range(n):
        vs = np.flatnonzero(a[u])
        indptr[u + 1] = indptr[u] + len(vs)
        indices.append(vs)
        weights.append(w[u, vs])
    return (indptr, np.concatenate(indices) if indices else np.zeros(0, np.int64),
            np.concatenate(weights) if weights else np.zeros(0, np.int64))


def dijkstra(indptr, indices, weights, src: int) -> tuple[np.ndarray, int]:
    n = len(indptr) - 1
    dist = np.full(n, np.inf)
    dist[src] = 0.0
    pq = [(0.0, src)]
    relaxations = 0
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for e in range(indptr[u], indptr[u + 1]):
            relaxations += 1
            v = indices[e]
            nd = d + weights[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist, relaxations


class _SsspState:
    def __init__(self, n: int, num_places: int, seed: int):
        self.dist = np.full(n, np.inf)
        self.locks = [threading.Lock() for _ in range(_NLOCKS)]
        self.relaxations = np.zeros(num_places, np.int64)
        self.rngs = [random.Random((seed << 8) ^ p)
                     for p in range(num_places)]


class _SsspStrategy(RandomStealStrategy):
    """Best-first locally, random steal order, dead when the node has been
    settled to a shorter distance since spawn time."""

    __slots__ = ("state", "node")

    def __init__(self, state: _SsspState, node: int, d: float,
                 steal_key: float):
        super().__init__(priority=d, steal_key=steal_key)
        self.state = state
        self.node = node

    def is_dead(self) -> bool:
        return self.state.dist[self.node] < self.priority


def _relax_task(s: _SsspState, indptr, indices, weights, u: int, d: float):
    if d > s.dist[u]:
        return  # stale (dead task that slipped through before claim)
    place = get_place() or 0
    rng = s.rngs[place]
    s.relaxations[place] += indptr[u + 1] - indptr[u]
    for e in range(indptr[u], indptr[u + 1]):
        v = int(indices[e])
        nd = d + weights[e]
        if nd < s.dist[v]:
            with s.locks[v % _NLOCKS]:
                if nd >= s.dist[v]:
                    continue
                s.dist[v] = nd
            spawn_s(_SsspStrategy(s, v, nd, rng.random()),
                    _relax_task, s, indptr, indices, weights, v, nd)


def run_sssp(n: int = 2000, density: float = 0.05, max_weight: int = 1000,
             seed: int = 0, num_places: int = 4, src: int = 0) -> dict:
    indptr, indices, weights = random_csr_graph(n, density, max_weight, seed)
    t0 = time.perf_counter()
    ref, seq_relax = dijkstra(indptr, indices, weights, src)
    seq_dt = time.perf_counter() - t0

    s = _SsspState(n, num_places, seed)
    s.dist[src] = 0.0
    sched = StrategyScheduler(num_places=num_places,
                              config=SchedulerConfig(seed=seed))
    t0 = time.perf_counter()
    sched.run(_relax_task, s, indptr, indices, weights, src, 0.0)
    dt = time.perf_counter() - t0
    assert np.allclose(s.dist, ref), "SSSP distances mismatch"
    m = sched.metrics.snapshot()
    par_relax = int(s.relaxations.sum())
    return {"time_s": dt, "seq_time_s": seq_dt,
            "relaxations": par_relax, "seq_relaxations": seq_relax,
            "work_ratio": par_relax / max(seq_relax, 1),
            "dead_pruned": m["dead_pruned"], "steals": m["steals"],
            "spawns": m["spawns"]}
