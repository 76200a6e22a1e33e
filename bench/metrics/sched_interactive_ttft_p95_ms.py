"""Time to first token, 95th percentile, of the most urgent class only
(priority 0, the requests the scheduler's strategies protect), over its
requests due in the window (a traced run's slices begin in the drain once
these have their first tokens; host clock)."""
from bench.harness.stats import percentile, ttft_s

UNIT = "ms"


def read(rec):
    v = percentile([ttft_s(rec, r) for r in rec.untraced_requests()
                    if r.arrival.priority == 0], 95)
    return None if v is None else v * 1e3
