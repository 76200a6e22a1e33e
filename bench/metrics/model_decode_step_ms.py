"""The median of the model's decode calls (``ServingEngine._decode``, every
slot of the batch), each span ended by a device synchronise, in the
traced run's span slice, in the drain after the window."""
from bench.harness.stats import percentile

UNIT = "ms"


def read(rec):
    spans = [c["end"] - c["start"] for c in rec.calls
             if c["kind"] == "decode" and c["synced"]]
    v = percentile(spans, 50)
    return None if v is None else v * 1e3
