"""Quickstart: configurable scheduling strategies in 60 lines.

A best-first search (toy branch-and-bound over a random tree) run three
ways on the SAME scheduler API:

  1. standard work-stealing order (LIFO/FIFO deque baseline),
  2. the strategy scheduler with plain LIFO/FIFO (overhead check),
  3. a custom strategy: best-first locally, high-uncertainty steals,
     transitive weights driving spawn-to-call, dead-task pruning.

The PyTorch port's counterpart of ``examples/quickstart.py``: the same
search on ``repro_torch.core``, the port's copy of the scheduler.  It runs
on the host only (no model, no device).

Run:  python examples_torch/quickstart.py
"""
import random
import sys
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (BaseStrategy, StrategyScheduler,  # noqa: E402
                              WorkStealingScheduler, spawn_s)

_LOCK = threading.Lock()  # incumbent updates must be atomic (check+set)


class SearchStrategy(BaseStrategy):
    """Priority = node's lower bound (best-first); dead once the global
    incumbent beats the bound; weight = expected subtree size."""

    __slots__ = ("bound", "incumbent")

    def __init__(self, bound, depth_left, incumbent):
        super().__init__(transitive_weight=2 ** min(depth_left, 20))
        self.bound = bound
        self.incumbent = incumbent

    def prioritize(self, other):
        if isinstance(other, SearchStrategy):
            return self.bound < other.bound
        return super().prioritize(other)

    def allow_call_conversion(self):
        return True

    def is_dead(self):
        return self.bound >= self.incumbent[0]


def search(incumbent, rng_seed, value, depth, use_strategy):
    rng = random.Random(rng_seed)
    if value < incumbent[0]:
        with _LOCK:
            if value < incumbent[0]:
                incumbent[0] = value  # new best solution (atomic update)
    if depth == 0:
        return
    # draw ALL randomness first: the tree must not depend on pruning
    draws = [(value - rng.random(), rng.randrange(2**31)) for _ in range(2)]
    for child_value, child_seed in draws:
        bound = child_value - (depth - 1)       # admissible lower bound
        if bound >= incumbent[0]:
            continue                            # pruned at spawn
        strat = (SearchStrategy(bound, depth, incumbent)
                 if use_strategy else BaseStrategy())
        spawn_s(strat, search, incumbent, child_seed,
                child_value, depth - 1, use_strategy)


def run(sched, use_strategy, label):
    incumbent = [0.0]
    sched.run(search, incumbent, 1234, 0.0, 18, use_strategy)
    m = sched.metrics.snapshot()
    print(f"{label:28s} best={incumbent[0]:8.3f} "
          f"executed={m['tasks_executed']:6d} spawns={m['spawns']:6d} "
          f"inlined={m['calls_converted']:6d} pruned={m['dead_pruned']:5d} "
          f"steals={m['steals']}")
    return incumbent[0]


def main() -> None:
    b1 = run(WorkStealingScheduler(num_places=4), False,
             "standard work-stealing")
    b2 = run(StrategyScheduler(num_places=4), False,
             "strategy sched (LIFO/FIFO)")
    b3 = run(StrategyScheduler(num_places=4), True,
             "strategy sched (best-first)")
    assert abs(b1 - b3) < 1e-9 and abs(b2 - b3) < 1e-9, \
        "all variants must find the same optimum"
    print("\nSame optimum, different work: the best-first strategy prunes "
          "dead subtrees\nearly and inlines small tasks — fewer queue "
          "round-trips for the same answer.")


if __name__ == "__main__":
    main()
