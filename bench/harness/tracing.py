"""The traced run's instruments, all in the benchmark's own files, around
the calls into the program's layers:

* the work of each of the engine's model calls (``_prefill_chunk``,
  ``_prefill``, ``_decode``: tokens, model FLOPs), all the window long;
* the scheduler's plans: when each request was first taken out of WAITING;
* in the drain after the window, where traffic still arrives, back to
  back: a span slice, in which each model call is timed and ended by a
  device synchronise; then two profiled slices without synchronises:
  slice A (device activity only, cheap on the host) gives the device's
  busy time, every kernel's time by name, and the op entry points' inputs
  (grouped SwiGLU's group sizes, decode's ``kv_valid`` from the engine's
  positions on the host); slice B (host and device, with the harness's
  spans as ``record_function`` ranges) names each idle gap of the device
  by the span the host was in; last the program slice, the only time the
  program's own tracer (``repro_torch.trace``) is on: its spans, and the
  engine's counters (``io_stats``, the scheduler's step count) at the
  slice's start and end, go to ``Records.spans``, ``io_open`` and
  ``io_close``.

The architecture's model FLOPs and attention-layer count come from the
cell's family.  Outside the slices nothing synchronises, so that the
window's queueing is that of an untraced run; the slices begin once the
window's requests have their first tokens, so that the scheduler's
metrics read no request that they slowed.  Nothing here runs in an
untraced run.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import numpy as np
import torch

from ..counts.flash import decode_bound_s
from ..counts.gmm import gmm_bound_s

__all__ = ["Tracer", "flash_decode_bound_s"]

#: kernels by a part of their CUDA function names
GMM_KERNELS = ("gmm_",)
FLASH_DECODE_KERNELS = ("flash_split", "flash_combine")
TOP = 10


def _events(prof):
    """Device events ``(start_ns, end_ns, name)`` and the harness's host
    spans, from the profiler's raw results."""
    kernels, spans = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if hasattr(e, "start_ns"):
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        else:
            s = int(e.start_us() * 1000)
            t = s + int(e.duration_us() * 1000)
        if name.startswith("bench."):
            if e.device_type() != cuda:
                spans.append((s, t, name))
        elif e.device_type() == cuda and t > s:
            kernels.append((s, t, name))
    kernels.sort()
    spans.sort()
    return kernels, spans


def _merge(kernels):
    """Union of the kernels' intervals, sorted."""
    out = []
    for s, t, _ in kernels:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _label(spans, starts, t: int) -> str:
    """The innermost harness span open at ``t``: the latest-starting span
    that contains it; outside every step, the open loop's own work
    (submitting, bookkeeping, waiting for an arrival)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s, e, name = spans[i]
        if e > t:
            return name
        i -= 1
    return "bench.outside_step"


def flash_decode_bound_s(family, sizes: dict, kv_calls) -> float:
    """The least time of flash attention's decode calls: each step's
    ``kv_valid`` (``kv_calls``) through every attention layer of the
    family."""
    s = sizes
    return family.attention_layers(s) * sum(
        decode_bound_s(s["num_heads"], s["num_kv_heads"], s["head_dim"],
                       kv, s["dtype"]) for kv in kv_calls)


class Tracer:
    """``slices``: ``[(mode, seconds), ...]`` run back to back from
    ``start`` (absolute; None until the caller sets it): ``"span"``
    synchronises and times each model call, ``"a"`` and ``"b"`` are the
    profiled slices, ``"program"`` turns the program's tracer on.  Outside
    them (``"off"``) calls are counted but neither timed nor synchronised,
    so that the rest of the window runs as an untraced run does."""

    def __init__(self, eng, rec, family, sizes: dict, *, start: float,
                 slices, clock=time.monotonic):
        self.eng, self.rec, self.sizes, self.clock = eng, rec, sizes, clock
        self.family = family
        self.cuda = eng.device.type == "cuda"
        self.start, self.slices = start, list(slices)
        self.mode, self.t_start, self.length = "off", 0.0, 0.0
        self.prof = None
        self.admitted = {}
        self.gmm_calls = []        # (e, c, d, f, load tensor), slice A
        self.flash_calls = []      # kv_valid lists, slice A
        self.summary = {}
        self._done = []            # (summarise, profile, seconds) to read
        self.step_start = 0.0
        self._gmm_orig = None
        self._install()
        if self.cuda:
            self._prime()

    def _prime(self):
        """Start and stop the profiler once in set-up: its first start
        initialises the device's tracing, which takes seconds."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device=self.eng.device).add_(1)
            torch.cuda.synchronize()

    # -- wrappers ------------------------------------------------------------
    def _span(self, name: str):
        return torch.profiler.record_function(name)

    def _call(self, kind, fn, tokens, flops, *args):
        rec = {"kind": kind, "tokens": tokens, "flops": flops,
               "start": None, "end": None, "synced": False,
               "step": len(self.rec.steps)}
        self.rec.calls.append(rec)
        if self.mode == "b":
            with self._span(f"bench.{kind}"):
                return fn(*args)
        if self.mode != "span":
            return fn(*args)
        rec["start"] = self.clock()
        out = fn(*args)
        if self.cuda:
            torch.cuda.synchronize()
        rec["end"], rec["synced"] = self.clock(), True
        return out

    def _install(self):
        eng, s, fam = self.eng, self.sizes, self.family
        chunk, whole, decode = eng._prefill_chunk, eng._prefill, eng._decode
        plan = eng.batcher.plan_step
        cap = eng.cap

        def prefill_chunk(params, batch, cache, row, start):
            n = int(batch["tokens"].shape[1])
            return self._call("prefill_chunk", chunk, n,
                              fam.chunk_flops(s, int(start), n),
                              params, batch, cache, row, start)

        def prefill(params, batch):
            n = int(batch["tokens"].shape[1])
            return self._call("prefill", whole, n,
                              fam.chunk_flops(s, 0, n), params, batch)

        def step_decode(*args):
            live = [int(eng.slot_pos[i]) for i, r in enumerate(eng.slot_req)
                    if r is not None]
            if self.mode == "a":
                self.flash_calls.append(
                    np.minimum(eng.slot_pos + 1, cap).tolist())
            return self._call("decode", decode, len(live),
                              fam.decode_flops(s, live), *args)

        def plan_step():
            p = plan()
            for req in p.prefill:
                self.admitted.setdefault(req.rid, self.step_start)
            return p

        if chunk is not None:
            eng._prefill_chunk = prefill_chunk
        eng._prefill = prefill
        eng._decode = step_decode
        eng.batcher.plan_step = plan_step

    def step(self):
        self.step_start = self.clock()
        if self.mode == "b":
            with self._span("bench.step"):
                return self.eng.step()
        return self.eng.step()

    # -- slices --------------------------------------------------------------
    def _gmm_install(self):
        from repro_torch.models import moe
        self._gmm_orig = orig = moe.grouped_swiglu

        def grouped_swiglu(x, w_gate, w_up, w_down, load=None):
            e, c, d = x.shape
            self.gmm_calls.append((e, c, d, int(w_gate.shape[2]), load))
            return orig(x, w_gate, w_up, w_down, load)

        moe.grouped_swiglu = grouped_swiglu

    def _gmm_uninstall(self):
        from repro_torch.models import moe
        moe.grouped_swiglu = self._gmm_orig

    def _counters(self) -> dict:
        """The engine's counters now, the scheduler's steps and the time."""
        return dict(self.eng.io_stats,
                    steps=self.eng.batcher.metrics["steps"], t=self.clock())

    def _end_slice(self):
        """Close the current slice; its profile is read after the run: the
        events are many, and reading them now would stall the window."""
        if self.cuda:
            torch.cuda.synchronize()
        seconds = self.clock() - self.t_start
        if self.mode == "program":
            from repro_torch import trace
            trace.disable()
            self.rec.io_close = self._counters()
            self.rec.spans = trace.take()
        if self.mode in ("a", "b"):
            self.prof.stop()
            summarise = self._summarise_a if self.mode == "a" \
                else self._summarise_b
            self._done.append((summarise, self.prof, seconds))
            self.prof = None
        if self.mode == "a":
            self._gmm_uninstall()
        self.mode = "off"

    def _begin_slice(self, mode: str):
        from torch.profiler import ProfilerActivity, profile
        if self.cuda:
            torch.cuda.synchronize()
        if mode == "a":
            self.prof = profile(activities=[ProfilerActivity.CUDA])
        elif mode == "b":
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
        if self.prof is not None:
            self.prof.start()
        if mode == "a":
            self._gmm_install()
        if mode == "program":
            from repro_torch import trace
            self.rec.io_open = self._counters()
            trace.enable()
        self.mode, self.t_start = mode, self.clock()

    def on_tick(self, now: float):
        """Between steps: end the slice whose time is up, begin the next
        one that is due.  Each slice runs its full length from its actual
        start; the profiled ones only where there is a card."""
        if self.mode != "off" and now >= self.t_start + self.length:
            self._end_slice()
        while self.mode == "off" and self.slices \
                and self.start is not None and now >= self.start:
            mode, self.length = self.slices.pop(0)
            if mode in ("a", "b") and not self.cuda:
                continue
            self._begin_slice(mode)
            self.start = self.t_start + self.length

    @property
    def finished(self) -> bool:
        """Every slice has begun and ended."""
        return self.start is not None and not self.slices \
            and self.mode == "off"

    def _summarise_a(self, prof, window_s: float):
        kernels, _ = _events(prof)
        busy = sum(t - s for s, t in _merge(kernels)) / 1e9
        by_name = defaultdict(float)
        for s, t, name in kernels:
            by_name[name] += (t - s) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gmm_s = sum(v for k, v in by_name.items()
                    if any(n in k for n in GMM_KERNELS))
        flash_s = sum(v for k, v in by_name.items()
                      if any(n in k for n in FLASH_DECODE_KERNELS))
        s = self.sizes
        gmm_bound = sum(gmm_bound_s(e, c, d, f, load.tolist(), s["dtype"])
                        for e, c, d, f, load in self.gmm_calls)
        flash_bound = flash_decode_bound_s(self.family, s, self.flash_calls)
        self.summary.update(
            window_s=window_s, busy_s=busy, kernels=len(kernels),
            device_ops=[[k[:160], v] for k, v in top],
            gmm_s=gmm_s, gmm_bound_s=gmm_bound, gmm_calls=len(self.gmm_calls),
            flash_decode_s=flash_s, flash_decode_bound_s=flash_bound,
            decode_calls=len(self.flash_calls))
        self.gmm_calls, self.flash_calls = [], []

    def _summarise_b(self, prof, window_s: float):
        kernels, spans = _events(prof)
        merged = _merge(kernels)
        starts = [sp[0] for sp in spans]
        gaps = defaultdict(float)
        for (_, t), (s, _) in zip(merged, merged[1:]):
            gaps[_label(spans, starts, t)] += (s - t) / 1e9
        self.summary.update(
            b_window_s=window_s,
            b_busy_s=sum(t - s for s, t in merged) / 1e9,
            idle_gaps=sorted(([k, v] for k, v in gaps.items()),
                             key=lambda kv: -kv[1])[:TOP])

    def finish(self):
        """Close a slice left open, read the profiles, and file the
        admission times."""
        if self.mode != "off":
            self._end_slice()
        for summarise, prof, seconds in self._done:
            summarise(prof, seconds)
        self._done = []
        for r in self.rec.requests:
            r.admitted = self.admitted.get(r.rid)
        self.rec.profile = self.summary or None
