"""Scheduler wait, 95th percentile: from when a request was due to the
start of the step whose plan first took it out of WAITING (the harness's
step timestamps), over the requests due in the window (a traced run's
slices, whose synchronises and profiler slow the engine, begin in the
drain once these have their first tokens).  A request never taken counts
as the time from due to the run's end."""
from bench.harness.stats import percentile

UNIT = "ms"


def read(rec):
    waits = [((r.admitted if r.admitted is not None else rec.end) - r.due)
             for r in rec.untraced_requests()]
    if not rec.calls:
        return None
    v = percentile(waits, 95)
    return None if v is None else v * 1e3
