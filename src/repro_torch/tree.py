"""Trees of tensors: nested dicts, lists and NamedTuples, the containers of
the port's parameters, optimizer state and checkpoints.

The leaf order is ``jax.tree.leaves``'s (dict keys sorted, list entries and
NamedTuple fields in order), and a leaf's path joins with ``/`` what the
reference's checkpoints join: a dict entry's key, a list entry's index and
a NamedTuple field as ``.field`` (``opt/.m/embed/table``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_map", "tree_map_with_path", "tree_leaves",
           "tree_leaves_with_path"]


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map_with_path(fn: Callable, tree, *rest, _path: str = "") -> Any:
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``; returns a tree of the same structure."""
    def sub(key):
        return f"{_path}/{key}" if _path else str(key)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      _path=sub(k))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_path(fn, getattr(tree, f),
                               *(getattr(r, f) for r in rest),
                               _path=sub(f".{f}"))
            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             _path=sub(i))
                          for i, v in enumerate(tree))
    return fn(_path, tree, *rest)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn(leaf, *matching leaves of rest)`` over the leaves of ``tree``."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves_with_path(tree, _path: str = "") -> Iterator[tuple]:
    """(path, leaf) pairs in the reference's leaf order."""
    def sub(key):
        return f"{_path}/{key}" if _path else str(key)
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], sub(k))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from tree_leaves_with_path(getattr(tree, f), sub(f".{f}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, sub(i))
    else:
        yield _path, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
