"""Blocking transfers a step: the engine's host-to-device copies and
device-to-host reads (``ServingEngine.io_stats``: ``h2d_copies`` +
``d2h_reads``) over the scheduler's steps (``batcher.metrics["steps"]``),
as deltas across the traced run's program slice, in the drain after the
window."""
UNIT = "count"


def read(rec):
    a, b = rec.io_open, rec.io_close
    if a is None or b is None or b["steps"] <= a["steps"]:
        return None
    syncs = (b["h2d_copies"] - a["h2d_copies"]
             + b["d2h_reads"] - a["d2h_reads"])
    return syncs / (b["steps"] - a["steps"])
