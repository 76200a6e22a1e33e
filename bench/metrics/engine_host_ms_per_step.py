"""The engine's and the scheduler's own host time a step: each step's
span minus the spans of its model calls, averaged over the steps of the
traced run's span slice, in the drain after the window (every model call
of the step timed and ended by a device synchronise)."""
from collections import defaultdict

UNIT = "ms"


def read(rec):
    inside, synced = defaultdict(float), {}
    for c in rec.calls:
        synced[c["step"]] = synced.get(c["step"], True) and c["synced"]
        if c["synced"]:
            inside[c["step"]] += c["end"] - c["start"]
    own = [s.end - s.start - inside[i] for i, s in enumerate(rec.steps)
           if synced.get(i)]
    return sum(own) / len(own) * 1e3 if own else None
