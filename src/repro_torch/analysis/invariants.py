# Copied from src/repro/analysis/invariants.py; only the imports may differ.
"""Reusable conservation-invariant hooks (the dynamic side of schedcheck).

The ``check()`` methods themselves live on the objects they verify —
:meth:`repro.core.task_storage.StrategyTaskStorage.check`,
:meth:`repro.core.task_storage.DequeTaskStorage.check` and
:meth:`repro.cluster.router.ClusterRouter.check` — the task-storage and
router analogues of :meth:`repro.serving.paged_kv.BlockAllocator.check`.
This module is the façade callers use:

* :func:`check_storage` / :func:`check_router` — hard asserts, re-raised as
  :class:`InvariantViolation` with the object's identity prepended, so a
  failure deep inside a chaos test names the structure that broke.
* :func:`soft_check` — run any ``check()``-bearing object and *collect* the
  violation instead of raising; the interleaving explorer and the mutation
  harness use this to record which fault fired without unwinding.
* :class:`EveryN` — cheap hot-path wrapper: full ``check()`` every N calls,
  for test loops where per-step checking would dominate runtime.

Invariant definitions (see ``docs/analysis.md`` for derivations):

* storage conservation — ``pushed == executed + dead_pruned + in_storage``;
* router conservation — ``accepted == finished + cancelled + rejected +
  in_flight`` and ``displaced == replayed + replay_failed``.
"""
from __future__ import annotations

from typing import Any, Optional

__all__ = ["InvariantViolation", "check_storage", "check_router",
           "soft_check", "EveryN"]


class InvariantViolation(AssertionError):
    """A conservation or structural invariant failed, with context."""


def _run(obj: Any, label: str) -> None:
    try:
        obj.check()
    except AssertionError as e:
        raise InvariantViolation(f"{label}: {e}") from e


def check_storage(storage: Any) -> None:
    """Hard-assert a task storage's invariants (either implementation —
    anything exposing ``check()`` and ``place_id`` qualifies)."""
    _run(storage, f"{type(storage).__name__}(place={storage.place_id})")


def check_router(router: Any) -> None:
    """Hard-assert a :class:`~repro.cluster.router.ClusterRouter`'s
    conservation ledger."""
    _run(router, f"{type(router).__name__}({len(router.replicas)} replicas)")


def soft_check(obj: Any) -> Optional[str]:
    """Run ``obj.check()``; return the violation message instead of raising
    (``None`` when clean).  Unexpected exception types still propagate —
    a crash inside a checker is a checker bug, not a finding."""
    try:
        obj.check()
    except AssertionError as e:
        return str(e)
    return None


class EveryN:
    """Call ``obj.check()`` on every Nth :meth:`tick` (and always on the
    first), so hot test loops stay hot.  ``tick()`` returns True when a
    check actually ran."""

    __slots__ = ("obj", "n", "_count")

    def __init__(self, obj: Any, n: int = 16):
        self.obj = obj
        self.n = max(1, int(n))
        self._count = 0

    def tick(self) -> bool:
        ran = self._count % self.n == 0
        if ran:
            _run(self.obj, type(self.obj).__name__)
        self._count += 1
        return ran

    def final(self) -> None:
        """End-of-test hook: one last unconditional check."""
        _run(self.obj, type(self.obj).__name__)
