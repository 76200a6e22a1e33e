# Copied from src/repro/analysis/__init__.py; only the imports may differ.
"""schedcheck: static and dynamic verification for the strategy scheduler.

Three entry points, one per failure mode the scheduler can actually ship:

* :mod:`repro.analysis.schedlint` — static lints over the strategy zoo:
  comparator lawfulness (strict-weak-order properties ``heapq`` silently
  requires), priority-key shape compatibility between strategies that share
  a storage, steal-class and merge-policy legality, transitive-weight
  positivity.  ``python -m repro.analysis.schedlint``.
* :mod:`repro.analysis.interleave` — bounded systematic exploration of
  owner/stealer interleavings against the real task storages, asserting the
  conservation invariant and no-double-delivery after every step.
  ``python -m repro.analysis.interleave``.
* :mod:`repro.analysis.invariants` — the reusable ``check()`` hooks the
  explorer and the hot-path tests call (task-storage and cluster-router
  conservation), in soft (collect) and hard (assert) flavours.

``benchmarks/schedcheck_mutations.py`` seeds known fault classes into
copies of the zoo and the storages and asserts every one is caught — the
proof that these checks have teeth.
"""
_EXPORTS = {
    "InvariantViolation": "invariants",
    "check_router": "invariants",
    "check_storage": "invariants",
    "soft_check": "invariants",
    "EveryN": "invariants",
    "Finding": "schedlint",
    "run_lint": "schedlint",
    "ExploreResult": "interleave",
    "default_schedule": "interleave",
    "explore": "interleave",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    # lazy re-export (PEP 562): ``python -m repro.analysis.schedlint``
    # should not import the explorer (and vice versa), and eager submodule
    # imports here would trip runpy's double-import warning.
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{module}", __name__), name)
