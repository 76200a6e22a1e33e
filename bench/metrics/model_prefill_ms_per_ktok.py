"""Prefill time per 1000 prompt tokens: the synchronised spans of the
model's chunked and whole-prompt prefill calls in the traced run's span
slice (in the drain after the window), summed, over their prompt
tokens."""
UNIT = "ms"


def read(rec):
    calls = [c for c in rec.calls
             if c["kind"] in ("prefill_chunk", "prefill") and c["synced"]]
    tokens = sum(c["tokens"] for c in calls)
    if not tokens:
        return None
    return sum(c["end"] - c["start"] for c in calls) / tokens * 1e6
