# Copied from src/repro/apps/bipartition.py; only the imports may differ.
"""Branch-and-bound graph bipartitioning (paper Section 4, Figures 2-3).

Vertices of a weighted undirected graph are split into two sets of given
sizes with minimum cut weight.  Subproblems are tasks; the strategy

* prioritizes locally by the *estimated* solution value (best-first — mostly
  decreasing, hence near-depth-first on promising branches),
* steals tasks with the highest *uncertainty* (estimate − lower bound: likely
  to generate much work and maybe a good solution → fewer future steals),
* sets transitive weight 2^d − 1 for estimated remaining depth d and enables
  spawn-to-call (bound-pruned subtrees then cost a call, not a queue trip),
* declares tasks **dead** when their lower bound meets the global upper
  bound, so they are pruned in the queues without being executed or stolen.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core import (BaseStrategy, SchedulerConfig, StrategyScheduler,
                    WorkStealingScheduler, spawn_s)

__all__ = ["random_graph", "run_bipartition", "BBStrategy", "UpperBound"]


def random_graph(n: int, density: float, max_weight: int = 1,
                 seed: int = 0) -> np.ndarray:
    """Symmetric weight matrix of a G(n, p) graph; ``max_weight == 1`` gives
    the paper's unweighted instances, 1000 the weighted ones."""
    rng = np.random.default_rng(seed)
    up = np.triu(rng.random((n, n)) < density, k=1)
    w = np.triu(rng.integers(1, max_weight + 1, (n, n)), k=1) * up
    return (w + w.T).astype(np.int64)


class UpperBound:
    """Global best known solution, updated atomically; remembers when the
    final (optimal) value was reached — the paper's Fig. 2(b)/3(b) metric."""

    def __init__(self, value: int):
        self.value = value
        self.solution: Optional[np.ndarray] = None
        self.last_improved_at = 0.0
        self._lock = threading.Lock()

    def offer(self, value: int, assign_a: np.ndarray) -> bool:
        if value >= self.value:
            return False
        with self._lock:
            if value >= self.value:
                return False
            self.value = value
            self.solution = assign_a.copy()
            self.last_improved_at = time.perf_counter()
            return True


class BBStrategy(BaseStrategy):
    """est → local best-first; uncertainty → steal order; lb vs ub → dead."""

    __slots__ = ("lb", "est", "uncertainty", "ub")

    def __init__(self, lb: float, est: float, depth_left: int, ub: UpperBound):
        super().__init__()
        self.lb = lb
        self.est = est
        self.uncertainty = est - lb
        self.ub = ub
        self.set_transitive_weight((1 << min(max(depth_left, 0), 40)) - 1)

    def prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, BBStrategy):
            if self.est != other.est:
                return self.est < other.est
            return self.spawn_seq > other.spawn_seq
        return super().prioritize(other)

    def steal_prioritize(self, other: BaseStrategy) -> bool:
        if isinstance(other, BBStrategy):
            return self.uncertainty > other.uncertainty
        return super().steal_prioritize(other)

    def allow_call_conversion(self) -> bool:
        return True

    def is_dead(self) -> bool:
        return self.lb >= self.ub.value


@dataclass
class _Problem:
    w: np.ndarray            # symmetric weights
    size_a: int
    size_b: int
    order: np.ndarray        # branching order (heavy vertices first)
    ub: UpperBound
    explored: "list[int]"    # [count]; guarded by GIL increments per task
    use_strategy: bool


def _bounds(p: _Problem, in_a: np.ndarray, in_b: np.ndarray,
            cut: int) -> tuple[float, float]:
    """(lower bound, estimate).  lb = cut + Σ_unassigned min(w→A, w→B); the
    estimate adds the expected cross-weight among unassigned vertices."""
    un = ~(in_a | in_b)
    r = int(un.sum())
    if r == 0:
        return float(cut), float(cut)
    wa = p.w[np.ix_(un, in_a)].sum(axis=1) if in_a.any() else np.zeros(r)
    wb = p.w[np.ix_(un, in_b)].sum(axis=1) if in_b.any() else np.zeros(r)
    lb = cut + np.minimum(wa, wb).sum()
    ra = p.size_a - int(in_a.sum())
    rb = p.size_b - int(in_b.sum())
    est = lb
    if r > 1:
        w_uu = p.w[np.ix_(un, un)].sum() / 2.0
        est = lb + w_uu * (2.0 * ra * rb) / (r * (r - 1))
    return float(lb), float(est)


def _solve_leaf(p: _Problem, in_a: np.ndarray, in_b: np.ndarray, cut: int):
    p.ub.offer(cut, in_a)


def _bb_task(p: _Problem, in_a: np.ndarray, in_b: np.ndarray, cut: int,
             lb: float):
    p.explored[0] += 1
    ub = p.ub
    if lb >= ub.value:
        return  # bound
    na, nb = int(in_a.sum()), int(in_b.sum())
    if na == p.size_a and nb == p.size_b:
        _solve_leaf(p, in_a, in_b, cut)
        return
    un = ~(in_a | in_b)
    idx = np.flatnonzero(un)
    if idx.size == 0:
        return
    # Branch on the most discriminating unassigned vertex.
    wa = p.w[np.ix_(idx, in_a)].sum(axis=1) if na else np.zeros(idx.size)
    wb = p.w[np.ix_(idx, in_b)].sum(axis=1) if nb else np.zeros(idx.size)
    v = idx[int(np.argmax(np.abs(wa - wb)))]
    for side in (0, 1):
        if side == 0 and na >= p.size_a:
            continue
        if side == 1 and nb >= p.size_b:
            continue
        a2, b2 = in_a.copy(), in_b.copy()
        add_cut = int(p.w[v, in_b].sum() if side == 0 else p.w[v, in_a].sum())
        (a2 if side == 0 else b2)[v] = True
        lb2, est2 = _bounds(p, a2, b2, cut + add_cut)
        if lb2 >= ub.value:
            continue
        if p.use_strategy:
            avg = max(ub.value / p.w.shape[0], 1e-9)
            depth_left = int(min((ub.value - lb2) / avg,
                                 p.w.shape[0] - na - nb))
            strat = BBStrategy(lb2, est2, depth_left, ub)
        else:
            strat = BaseStrategy()
        spawn_s(strat, _bb_task, p, a2, b2, cut + add_cut, lb2)


def _greedy_initial(w: np.ndarray, size_a: int) -> int:
    """Greedy feasible solution to seed the upper bound (finite, not tight)."""
    n = w.shape[0]
    in_a = np.zeros(n, bool)
    in_a[np.argsort(-w.sum(axis=1))[:size_a]] = True
    return int(w[np.ix_(in_a, ~in_a)].sum())


def run_bipartition(n: int = 24, density: float = 0.5, max_weight: int = 1,
                    seed: int = 0, num_places: int = 4,
                    scheduler: str = "strategy",
                    use_strategy: bool = True) -> dict:
    """scheduler: "strategy" (paper) | "deque" (standard work-stealing).
    ``use_strategy=False`` on the strategy scheduler measures its overhead
    with plain LIFO/FIFO tasks (the paper's third bar)."""
    w = random_graph(n, density, max_weight, seed)
    size_a = n // 2
    ub = UpperBound(_greedy_initial(w, size_a) + 1)
    explored = [0]
    p = _Problem(w, size_a, n - size_a, np.argsort(-w.sum(axis=1)), ub,
                 explored, use_strategy and scheduler == "strategy")
    if scheduler == "deque":
        sched = WorkStealingScheduler(num_places=num_places, seed=seed)
    else:
        sched = StrategyScheduler(num_places=num_places,
                                  config=SchedulerConfig(seed=seed))
    in_a = np.zeros(n, bool)
    in_b = np.zeros(n, bool)
    lb0, _ = _bounds(p, in_a, in_b, 0)
    t0 = time.perf_counter()
    sched.run(_bb_task, p, in_a, in_b, 0, lb0)
    dt = time.perf_counter() - t0
    m = sched.metrics.snapshot()
    return {
        "cut": ub.value,
        "solution": ub.solution,
        "time_s": dt,
        "time_to_optimum_s": max(0.0, ub.last_improved_at - t0),
        "explored": explored[0],
        **{k: m[k] for k in ("spawns", "calls_converted", "steals",
                             "dead_pruned", "tasks_stolen")},
    }
