"""Time to first token, 95th percentile, over every request due in the
window: from when it was due to the end of the step that emitted its
first token (host clock).  A request that failed counts as missing."""
from bench.harness.stats import percentile, ttft_s

UNIT = "ms"


def read(rec):
    v = percentile([ttft_s(rec, r) for r in rec.window_requests()], 95)
    return None if v is None else v * 1e3
