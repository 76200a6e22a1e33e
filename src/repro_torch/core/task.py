# Copied from src/repro/core/task.py; only the imports may differ.
"""Tasks and finish regions for the strategy scheduler."""
from __future__ import annotations

import threading
from enum import IntEnum
from typing import Callable, Optional

from .strategy import BaseStrategy


class TaskState(IntEnum):
    READY = 0       # in some place's task storage
    CLAIMED = 1     # popped/stolen, about to execute
    DONE = 2
    DEAD = 3        # pruned (strategy.is_dead() at pop/steal time)


class Task:
    """One schedulable unit.  State transitions happen under the lock of the
    storage the task currently resides in, so no per-task lock is needed."""

    __slots__ = ("fn", "args", "kwargs", "strategy", "state", "region",
                 "home_place", "_storage")

    def __init__(self, fn: Callable, args: tuple, kwargs: dict,
                 strategy: BaseStrategy, region: "FinishRegion"):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.strategy = strategy
        self.state = TaskState.READY
        self.region = region
        self.home_place = strategy.place
        self._storage = None

    def run(self):
        return self.fn(*self.args, **self.kwargs)

    def __repr__(self):  # pragma: no cover
        return (f"Task({getattr(self.fn, '__name__', self.fn)!r}, "
                f"state={self.state.name}, strat={self.strategy!r})")


class FinishRegion:
    """X10-style finish region: tracks outstanding tasks (including
    transitively spawned ones attached to the same region).  Waiters help
    execute work instead of blocking (help-first)."""

    __slots__ = ("_count", "_lock", "_done", "parent")

    def __init__(self, parent: Optional["FinishRegion"] = None):
        self._count = 0
        self._lock = threading.Lock()
        self._done = threading.Event()
        self.parent = parent

    def inc(self) -> None:
        with self._lock:
            self._count += 1
            if self._count == 1:
                self._done.clear()

    def dec(self) -> None:
        with self._lock:
            self._count -= 1
            if self._count <= 0:
                self._done.set()

    @property
    def pending(self) -> int:
        return self._count

    def is_complete(self) -> bool:
        return self._count <= 0

    def wait_blocking(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)
