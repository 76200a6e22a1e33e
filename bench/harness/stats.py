"""Small helpers the metric readers share."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["percentile", "ttft_s", "tpot_s", "window_steps"]


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """numpy's linear-interpolation percentile; None for no values."""
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if len(values) else None


def ttft_s(rec, r) -> float:
    """Due time to the end of the step of the first token.  A request
    that never got one missed by at least the whole run: it counts as
    the time from due to the run's end."""
    return (r.first if r.first is not None else rec.end) - r.due


def tpot_s(rec, r) -> float:
    """(last token - first token) / (tokens - 1) of a finished request; an
    unfinished one counts as the time from due to the run's end."""
    if not r.done:
        return rec.end - r.due
    return (r.last - r.first) / max(1, r.n_out - 1)


def window_steps(rec) -> list:
    """(index, step) of the steps that started and ended in the window."""
    return [(i, s) for i, s in enumerate(rec.steps)
            if s.start >= rec.window_open and s.end <= rec.window_close]
