"""Spans of the serving step, on the host's monotonic clock.

Off by default.  Off, :func:`span` reads one flag and returns a shared
no-op context: it records nothing and calls nothing in torch.  On, each span
records ``(name, parent, start, end, attrs)`` in memory, where ``parent`` is
the index of the enclosing open span (None at the root) and the clock is
``time.monotonic``; while a ``torch.profiler`` profile is running, the span
also opens ``torch.profiler.record_function(name)``, so that it appears in
the profiler's trace beside the kernels it enqueued.

Whoever turns tracing on reads the records with :func:`take`.  The spans
(``NAMES``), from the engine down:

* ``engine.step``: one :meth:`ServingEngine.step` (attrs ``decoded``, the
  rows decoded, and ``prefill_tokens``), around
  ``engine.plan`` (the scheduler's plan), ``engine.prefill`` (one planned
  request's chunk or whole prompt; attrs ``rid``, and ``start`` and
  ``tokens`` as planned),
  ``engine.kv_blocks`` (block growth, copy-on-write and preemption before
  decode), ``engine.upload`` (a blocking host-to-device copy; attr
  ``bytes``), ``engine.read`` (a device-to-host read of sampled tokens) and
  ``engine.emit`` (the bookkeeping after decode);
* ``model.decode``, ``model.prefill_chunk``, ``model.prefill``: the paged
  model's decode step, a prompt chunk, a whole prompt (the transformer's
  and the hybrid's); ``model.unembed``: the final norm and the output
  head;
* ``attn.qkv``, ``attn.kv_write``, ``attn.gather`` (the block table's
  logical view of K and V; attr ``bytes``), ``attn.core``, ``attn.out``:
  one paged attention layer;
* ``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``: one
  MoE layer;
* ``mamba.prefill``, ``mamba.decode``: one Mamba layer's work from in_proj
  to out_proj (attr ``tokens``); ``mamba.scan``: the selective scan inside
  ``mamba.prefill`` (the ``mamba_scan`` kernel, or the plain chunked scan);
* ``hybrid.state_commit``: a chunk-prefilled request's carried Mamba state
  copied into its decode slot after its last chunk.

The host enqueues device work without waiting for it, so a span times the
host: the time to issue its kernels, or the time it was blocked on the
device where it reads from it (``engine.read``) or copies to it from
pageable memory (``engine.upload``).  One thread traces at a time.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

__all__ = ["NAMES", "Span", "span", "enable", "disable", "take"]

NAMES = ("engine.step", "engine.plan", "engine.prefill", "engine.kv_blocks",
         "engine.upload", "engine.read", "engine.emit",
         "model.decode", "model.prefill_chunk", "model.prefill",
         "model.unembed",
         "attn.qkv", "attn.kv_write", "attn.gather", "attn.core", "attn.out",
         "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
         "mamba.prefill", "mamba.scan", "mamba.decode",
         "hybrid.state_commit")


class Span(NamedTuple):
    name: str
    parent: Optional[int]       # index of the enclosing span in the list
    start: float                # time.monotonic(), seconds
    end: Optional[float]        # None while open
    attrs: Dict[str, Any]


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _State:
    __slots__ = ("on", "records", "open")

    def __init__(self):
        self.on = False
        self.records: List[list] = []
        self.open: List[int] = []       # indices of the open spans


_state = _State()


class _On:
    __slots__ = ("name", "attrs", "rec", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        st = _state
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        parent = st.open[-1] if st.open else None
        st.open.append(len(st.records))
        self.rec = [self.name, parent, time.monotonic(), None, self.attrs]
        st.records.append(self.rec)
        return self.attrs

    def __exit__(self, *exc):
        self.rec[3] = time.monotonic()
        _state.open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context that records ``name`` while tracing is on; ``attrs`` are
    kept with the span.  ``with span(...) as a``: ``a`` is the span's attrs
    dict, to add to before it closes, or None while tracing is off."""
    if not _state.on:
        return _OFF
    return _On(name, attrs)


def enable() -> None:
    _state.on = True


def disable() -> None:
    """Stop recording; spans already open still record their end."""
    _state.on = False


def take() -> List[Span]:
    """The spans recorded since the last call, in the order they opened,
    and clear them.  Call it with no span open: a parent index refers to
    the list it returns."""
    out = [Span(*r) for r in _state.records]
    _state.records = []
    return out
