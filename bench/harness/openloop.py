"""The open loop: submit every request when it is due, step the engine
while it has work, sleep until the next due time when it has none.

Every time is the host's monotonic clock.  A request's latency runs from
when it was due, so a stall that delays its submission counts.  A token's
time is the end of the engine step that emitted it.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .traffic import Arrival

__all__ = ["ReqRecord", "StepRecord", "Records", "drive", "engine_busy"]


@dataclass
class ReqRecord:
    arrival: Arrival
    due: float                      # absolute, monotonic seconds
    submitted: Optional[float] = None
    rid: Optional[int] = None
    max_new: int = 0
    first: Optional[float] = None   # end of the step of the first token
    last: Optional[float] = None
    n_out: int = 0
    admitted: Optional[float] = None  # start of the step that took it out
    #                                   of WAITING (traced runs only)
    rejected: bool = False
    slot: int = -1                  # the highest batch slot it held

    @property
    def done(self) -> bool:
        return self.n_out >= self.max_new > 0


@dataclass
class StepRecord:
    start: float
    end: float
    tokens: int


@dataclass
class Records:
    """Everything one run recorded; the metric readers read it."""
    t0: float = 0.0                 # the traffic's time 0
    window_open: float = 0.0
    window_close: float = 0.0
    end: float = 0.0                # when the drain stopped
    requests: List[ReqRecord] = field(default_factory=list)
    steps: List[StepRecord] = field(default_factory=list)
    #: model calls of a traced run: dicts with kind, start, end, tokens,
    #: flops, synced
    calls: List[dict] = field(default_factory=list)
    #: the profiled slices' summary (traced runs on the card only)
    profile: Optional[dict] = None
    setup_s: float = 0.0
    sizes: dict = field(default_factory=dict)
    #: requests still waiting for admission when the window closed
    waiting_at_close: int = 0
    #: monotonic stamps of the set-up's parts (the log's breakdown)
    marks: dict = field(default_factory=dict)
    #: where a traced run's slices began: after the window closed and its
    #: requests had their first tokens (None: an untraced run)
    traced_from: Optional[float] = None
    #: the program's spans (``repro_torch.trace.Span``) of a traced run's
    #: program slice, and the engine's counters (``io_stats``, ``steps``,
    #: the time ``t``) at its start and end (None: no program slice ran)
    spans: list = field(default_factory=list)
    io_open: Optional[dict] = None
    io_close: Optional[dict] = None

    def in_window(self, t: float) -> bool:
        return self.window_open <= t < self.window_close

    def window_requests(self) -> List[ReqRecord]:
        return [r for r in self.requests if self.in_window(r.due)]

    def untraced_requests(self) -> List[ReqRecord]:
        """The window's requests whose first token came before a traced
        run's slices began (every one of them, unless the drain's wait for
        first tokens ran out), or never came."""
        end = self.traced_from
        return [r for r in self.window_requests()
                if end is None or r.first is None or r.first <= end]


def engine_busy(eng) -> bool:
    b = eng.batcher
    return bool(b.waiting_count or b.running
                or any(r is not None for r in eng.slot_req))


def drive(eng, arrivals: List[Arrival], rec: Records, *, stop_at: float,
          until: Optional[Callable[[], bool]] = None,
          step: Optional[Callable] = None,
          on_tick: Optional[Callable[[float], None]] = None,
          clock=time.monotonic) -> None:
    """Run the loop from now until ``stop_at`` (absolute), or earlier once
    ``until()`` holds (None: run to ``stop_at``).
    Arrivals due before now are submitted at once.  ``arrivals`` is
    consumed from the left; records are appended to ``rec``."""
    from repro_torch.serving import AdmissionRejected
    step = step or eng.step
    pending = arrivals if isinstance(arrivals, deque) else deque(arrivals)
    inflight: List[ReqRecord] = [r for r in rec.requests
                                 if r.submitted is not None and not r.done
                                 and not r.rejected]
    while True:
        now = clock()
        while pending and rec.t0 + pending[0].due <= now:
            a = pending.popleft()
            r = ReqRecord(a, rec.t0 + a.due, submitted=now)
            try:
                req = eng.submit(a.tokens, a.max_new, priority=a.priority)
            except AdmissionRejected:
                r.rejected = True
            else:
                r.rid, r.max_new = req.rid, req.max_new_tokens
                inflight.append(r)
            rec.requests.append(r)
        if on_tick is not None:
            on_tick(now)
        if now >= stop_at or (until is not None and until()):
            return
        if not engine_busy(eng):
            nxt = rec.t0 + pending[0].due if pending else stop_at
            time.sleep(max(0.0, min(nxt, stop_at) - clock()))
            continue
        start = clock()
        step()
        end = clock()
        slots = {req.rid: i for i, req in enumerate(eng.slot_req)
                 if req is not None}
        emitted = 0
        keep = []
        for r in inflight:
            r.slot = max(r.slot, slots.get(r.rid, -1))
            n = len(eng.outputs[r.rid])
            if n > r.n_out:
                if r.n_out == 0:
                    r.first = end
                emitted += n - r.n_out
                r.n_out, r.last = n, end
            if not r.done:
                keep.append(r)
        inflight = keep
        rec.steps.append(StepRecord(start, end, emitted))
