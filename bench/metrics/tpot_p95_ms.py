"""Time per output token, 95th percentile, over every request due in the
window: (last token - first token) / (tokens - 1), each token timed at
the end of the step that emitted it (host clock).  A request that failed
counts as missing."""
from bench.harness.stats import percentile, tpot_s

UNIT = "ms"


def read(rec):
    v = percentile([tpot_s(rec, r) for r in rec.window_requests()], 95)
    return None if v is None else v * 1e3
