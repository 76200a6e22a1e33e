"""The live share of the paged KV that a decode step gathers: the valid
positions of the decoded rows (``ServingEngine.io_stats``'s
``kv_live_tokens``: min(pos + 1, cap) summed over the rows) over the
logical view the step gathers (``kv_view_tokens``: max_batch x cap), as
deltas across the traced run's program slice, in the drain after the
window.  It tells an emptier batch from a slower kernel where
``flash_decode_roofline`` moves."""
UNIT = "%"


def read(rec):
    a, b = rec.io_open, rec.io_close
    if a is None or b is None:
        return None
    view = b["kv_view_tokens"] - a["kv_view_tokens"]
    if view <= 0:
        return None
    return 100.0 * (b["kv_live_tokens"] - a["kv_live_tokens"]) / view
